"""The port's roaring codec (pilosa_tpu_torch.core.roaring_io) against
pilosa_tpu.core.roaring_io: the same bytes from encode and the same
positions (or the same error) from decode, on seeded random positions
that make empty, array, bitmap and run containers, on official-format
files of both cookies, and on the checked-in corpus of good and broken
files.
"""

import pathlib

import numpy as np
import pytest

from pilosa_tpu.core import roaring_io as jr
from pilosa_tpu_torch.core import roaring_io as tr
from test_roaring_io import KINDS, encode_official_norun, encode_official_runs, random_positions

CORPUS = sorted((pathlib.Path(__file__).resolve().parent / "corpus" / "roaring").glob("*.bin"))


def decode_both(data: bytes):
    """(positions or error message) from each codec."""
    out = []
    for codec in (jr, tr):
        try:
            out.append(codec.decode(data).tolist())
        except codec.RoaringError as e:
            out.append(f"RoaringError: {e}")
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("kind", KINDS)
def test_encode_decode_match_reference(kind, seed):
    rng = np.random.default_rng(1000 * seed + KINDS.index(kind))
    pos = random_positions(rng, kind)
    data = tr.encode(pos)
    assert data == jr.encode(pos)
    ref, port = decode_both(data)
    assert port == ref == pos.tolist()
    assert tr.inspect(data) == jr.inspect(data)


def test_container_kinds_covered():
    """One file holding an array, a bitmap and a run container, as the
    encoder picks them, decodes the same through both codecs."""
    rng = np.random.default_rng(5)
    pos = random_positions(rng, "multikey")
    data = tr.encode(pos)
    n = int.from_bytes(data[4:8], "little")
    types = {int.from_bytes(data[8 + 12 * i + 8 : 8 + 12 * i + 10], "little") for i in range(n)}
    assert types == {tr.TYPE_ARRAY, tr.TYPE_BITMAP, tr.TYPE_RUN}
    ref, port = decode_both(data)
    assert port == ref == pos.tolist()


@pytest.mark.parametrize("n_containers", [1, 3, 4, 9])
def test_official_dialects_match_reference(n_containers):
    rng = np.random.default_rng(n_containers)
    keys = np.sort(rng.choice(1 << 16, n_containers, replace=False))
    norun, runs = [], []
    for i, key in enumerate(keys.tolist()):
        if i % 3 == 0:
            lows = np.unique(rng.integers(0, 1 << 16, 100))
        elif i % 3 == 1:
            lows = np.unique(rng.integers(0, 1 << 16, 6000))
        else:
            lows = np.arange(int(rng.integers(0, 1000)), 5000 + int(rng.integers(0, 1000)))
        norun.append((key, lows))
        runs.append((key, lows, i % 3 == 2))
    for data in (encode_official_norun(norun), encode_official_runs(runs)):
        ref, port = decode_both(data)
        assert port == ref
        assert isinstance(port, list) and len(port) == sum(len(lows) for _, lows in norun)


@pytest.mark.parametrize("path", CORPUS, ids=lambda p: p.name)
def test_corpus_matches_reference(path):
    ref, port = decode_both(path.read_bytes())
    assert port == ref

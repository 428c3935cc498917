"""Dense bitmap algebra in plain PyTorch: the port's twin of
pilosa_tpu/ops/bitmap.py.

Words are torch.int32 tensors holding the same bits as the reference's
uint32 words (bit b of word w <=> in-shard column 32w + b). PyTorch has no
uint32 shifts or complement on the CPU and widens uint32 sums, so:

- `>>` on int32 is arithmetic; every right shift here masks afterwards to
  get the logical shift;
- popcount is SWAR on int32, split into 16-bit halves so no intermediate
  overflows;
- counts accumulate in int64. The all-axes scalar counts wrap mod 2^32 to
  keep the reference's uint32 contract; per-row counts never wrap (one
  (row, shard) holds at most 2^30 bits).

All functions broadcast over leading axes like the reference. The four
fused reductions that carry the query path have hand-written CUDA kernels
in ops/kernels.py; the functions here are their building blocks and the
rest of the algebra.
"""

from __future__ import annotations

import numpy as np
import torch

from pilosa_tpu_torch.shardwidth import SHARD_WIDTH, WORDS_PER_ROW

MASK32 = 0xFFFFFFFF


def as_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> int32 with the same low 32 bits."""
    x = x & MASK32
    return (x - ((x >> 31) & 1) * (1 << 32)).to(torch.int32)


# ---------------------------------------------------------------------------
# Host-side packing (storage boundary only; numpy uint32 words)
# ---------------------------------------------------------------------------


def pack_positions(positions, n_bits: int = SHARD_WIDTH) -> np.ndarray:
    """Pack sorted/unsorted in-shard positions into a dense uint32 word vector."""
    words = np.zeros(n_bits // 32, dtype=np.uint32)
    if len(positions):
        p = np.asarray(positions, dtype=np.uint64)
        if p.size and (p.max() >= n_bits):
            raise ValueError(f"position {p.max()} out of range for {n_bits} bits")
        np.bitwise_or.at(
            words,
            (p >> 5).astype(np.int64),
            np.uint32(1) << (p & np.uint64(31)).astype(np.uint32),
        )
    return words


def unpack_positions(words: np.ndarray) -> np.ndarray:
    """Inverse of pack_positions: dense words -> sorted uint64 positions."""
    w = np.ascontiguousarray(np.asarray(words, dtype=np.uint32)).ravel()
    nz = np.flatnonzero(w)  # only words with a bit set are unpacked
    word_i, bit_i = np.nonzero(np.unpackbits(w[nz].view(np.uint8), bitorder="little").reshape(-1, 32))
    return (nz[word_i].astype(np.uint64) << np.uint64(5)) | bit_i.astype(np.uint64)


def empty_row(n_words: int = WORDS_PER_ROW) -> np.ndarray:
    return np.zeros(n_words, dtype=np.uint32)


def to_host(words: torch.Tensor) -> np.ndarray:
    """Device/CPU int32 words -> numpy uint32 (same bits)."""
    return words.detach().cpu().numpy().view(np.uint32)


def from_host(words: np.ndarray, device) -> torch.Tensor:
    """numpy uint32 words -> int32 tensor on `device` (same bits)."""
    arr = np.ascontiguousarray(words, dtype=np.uint32).view(np.int32)
    return torch.from_numpy(arr).to(device)


# ---------------------------------------------------------------------------
# Elementwise algebra
# ---------------------------------------------------------------------------


def b_and(a, b):
    return a & b


def b_or(a, b):
    return a | b


def b_xor(a, b):
    return a ^ b


def b_andnot(a, b):
    """a AND NOT b."""
    return a & ~b


def b_not(a, exists):
    """NOT a, bounded by the existence row."""
    return ~a & exists


def lsr(x: torch.Tensor, r: int) -> torch.Tensor:
    """Logical right shift of int32 words by 0 < r < 32."""
    return (x >> r) & ((1 << (32 - r)) - 1)


def _popcount16(v: torch.Tensor) -> torch.Tensor:
    v = v - ((v >> 1) & 0x5555)
    v = (v & 0x3333) + ((v >> 2) & 0x3333)
    v = (v + (v >> 4)) & 0x0F0F
    return (v + (v >> 8)) & 0x1F


def popcount_words(x: torch.Tensor) -> torch.Tensor:
    """Per-word popcount of int32 words (int32 result, same shape)."""
    return _popcount16(x & 0xFFFF) + _popcount16(lsr(x, 16))


# ---------------------------------------------------------------------------
# Reductions
# ---------------------------------------------------------------------------


def popcount(words) -> torch.Tensor:
    """Total set bits over ALL axes, mod 2^32 (0-d int64)."""
    return popcount_words(words).sum(dtype=torch.int64) & MASK32


def popcount_rows(words) -> torch.Tensor:
    """Set bits per row: sums over the trailing word axis only (int64)."""
    return popcount_words(words).sum(dim=-1, dtype=torch.int64)


def count_and(a, b) -> torch.Tensor:
    return popcount(a & b)


def count_and_rows(a, b) -> torch.Tensor:
    return popcount_rows(a & b)


def count_andnot(a, b) -> torch.Tensor:
    return popcount(a & ~b)


def _reduce(stack, init: int, op):
    if stack.shape[0] == 0:
        return torch.full(stack.shape[1:], init, dtype=stack.dtype, device=stack.device)
    out = stack[0].clone()
    for i in range(1, stack.shape[0]):
        out = op(out, stack[i])
    return out


def union_reduce(stack):
    """Bitwise-or over axis 0: n-way union."""
    return _reduce(stack, 0, torch.bitwise_or)


def intersect_reduce(stack):
    return _reduce(stack, -1, torch.bitwise_and)


def xor_reduce(stack):
    return _reduce(stack, 0, torch.bitwise_xor)


def range_mask_words(start: int, stop: int, n_bits: int = SHARD_WIDTH, device=None):
    """Dense mask with bits [start, stop) set (int32[n_bits // 32])."""
    n_words = n_bits // 32
    base = torch.arange(n_words, dtype=torch.int64, device=device) * 32
    lo = (int(start) - base).clamp(0, 32)
    hi = (int(stop) - base).clamp(0, 32)
    nset = (hi - lo).clamp(min=0)
    ones = torch.bitwise_left_shift(torch.ones_like(nset), nset) - 1
    body = torch.where(nset >= 32, torch.full_like(nset, MASK32), ones)
    mask = torch.where(nset > 0, (body << lo) & MASK32, torch.zeros_like(nset))
    return as_i32(mask)


def count_range(words, start: int, stop: int) -> torch.Tensor:
    """popcount of bits in [start, stop), mod 2^32."""
    mask = range_mask_words(start, stop, words.shape[-1] * 32, device=words.device)
    return popcount(words & mask)


def _shift_words_up(x, k: int):
    """Move words to higher indices by k along the last axis, zero-filled."""
    if k == 0:
        return x
    n = x.shape[-1]
    pad = torch.zeros(x.shape[:-1] + (min(k, n),), dtype=x.dtype, device=x.device)
    return torch.cat([pad, x[..., : n - min(k, n)]], dim=-1)


def _shift_words_down(x, k: int):
    if k == 0:
        return x
    n = x.shape[-1]
    pad = torch.zeros(x.shape[:-1] + (min(k, n),), dtype=x.dtype, device=x.device)
    return torch.cat([x[..., min(k, n):], pad], dim=-1)


def shift_bits(words, n: int = 1):
    """Shift the whole bit-vector towards higher positions by n.

    Returns (shifted, overflow): `overflow` holds the n high bits that fell
    off the end rebased to positions [0, n); the executor carries them into
    the next shard. Operates on the last axis."""
    if n == 0:
        return words, torch.zeros_like(words)
    n_words = words.shape[-1]
    if not 0 <= n <= n_words * 32:
        raise ValueError(
            f"shift amount {n} out of range [0, {n_words * 32}]: overflow may only "
            "carry into the immediately following shard"
        )
    q, r = divmod(n, 32)
    shifted = _shift_words_up(words, q)
    if r:
        prev = _shift_words_up(shifted, 1)
        shifted = (shifted << r) | lsr(prev, 32 - r)
    # overflow: original bits in [n_bits - n, n_bits) shifted DOWN to [0, n)
    qd, rd = divmod(n_words * 32 - n, 32)
    down = _shift_words_down(words, qd)
    if rd:
        nxt = _shift_words_down(down, 1)
        down = lsr(down, rd) | (nxt << (32 - rd))
    mask = range_mask_words(0, n, n_words * 32, device=words.device)
    return shifted, down & mask


def any_set(words) -> torch.Tensor:
    """True if any bit is set (bool scalar)."""
    return torch.any(words != 0)


# ---------------------------------------------------------------------------
# GroupBy cross tally (twins of the counts_cross and gather_and kernels)
# ---------------------------------------------------------------------------


def counts_cross(acc: torch.Tensor, planes: torch.Tensor) -> torch.Tensor:
    """acc int32[G, S, W] x planes int32[R, S, W] -> int32[G, R, S] of
    popcount(acc[g, s] & planes[r, s]) (pilosa_tpu/exec/groupby.py
    _counts_cross), one [G, S, W] intermediate per plane row."""
    g, s, _ = acc.shape
    out = torch.empty((g, planes.shape[0], s), dtype=torch.int32, device=acc.device)
    for r in range(planes.shape[0]):
        out[:, r] = popcount_words(acc & planes[r]).sum(dim=-1, dtype=torch.int64).to(torch.int32)
    return out


def gather_and(a: torch.Tensor, ia: torch.Tensor, b: torch.Tensor, ib: torch.Tensor) -> torch.Tensor:
    """out[i] = a[ia[i]] & b[ib[i]] over the leading axis (groupby.py
    _select_rows_filtered, _select_pairs and _cross_expand)."""
    return a[ia.long()] & b[ib.long()]

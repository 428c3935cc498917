"""The port's four hand-written CUDA kernels: build, binding, dispatch and
their plain-PyTorch twins.

Each kernel function below takes int32 word tensors (the bits of the
reference's uint32 words). On a CUDA tensor it launches its kernel from
`cuda/bitmap_kernels.cu`; on a CPU tensor it runs its twin, which has the
same contract and is the oracle the kernel is held to. There is no other
route: a CUDA tensor never reaches a twin through these functions, and a
failed build or launch raises.

| function       | replaces (TPU side)                                     |
|----------------|---------------------------------------------------------|
| `count2`       | pallas_kernels.py `_count2` (+ `popcount`, op "none")   |
| `rows_counts`  | pallas_kernels.py `_rows_counts`                        |
| `plan_count`   | exec/plan.py `_eval_jit`/`_root_out` (XLA program)      |
| `gather_tally` | ops/bitmap.py `gather_tally_sorted` (XLA program)       |

All four read every input word once and do one popcount per word, so on
the card they are bound by device-memory bytes.

The library is compiled lazily, at the first CUDA launch, with `nvcc` into
`ops/_build/` under a name keyed by a hash of the sources and flags, and
loaded with ctypes (pointers and the stream pass as c_void_p).
`LAUNCHES` counts kernel launches per kernel (`popcount` launches count
under `count2`: one kernel template serves both); only the CUDA route
counts.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import List, Optional, Sequence

import torch

from pilosa_tpu_torch.ops.bitmap import MASK32, popcount_words

_SRC_DIR = Path(__file__).resolve().parent / "cuda"
_BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = (
    "-O3",
    "-std=c++17",
    "-gencode",
    "arch=compute_90a,code=sm_90a",
    "-shared",
    "-Xcompiler",
    "-fPIC",
    "-Xptxas",
    "-v",
)

# launches per kernel function (CUDA route only)
LAUNCHES = {"count2": 0, "rows_counts": 0, "plan_count": 0, "gather_tally": 0}

# nvcc's stderr of the build this process loaded (ptxas register/spill
# report), or "" when the library was already built
BUILD_LOG = {"text": ""}

_OPS = {"none": 0, "and": 1, "or": 2, "xor": 3, "andnot": 4}

# plan_count program encoding (mirrors bitmap_kernels.cu). Leaves and
# instructions are unbounded; the operand stack holds MAX_STACK entries,
# which a program compiled deepest-child-first needs only past 2^31 leaves.
MAX_STACK = 32
PUSH_ZERO = -1
# "andnot" is below & ~top; "rev_andnot" is top & ~below
BINOPS = {"and": -2, "or": -3, "xor": -4, "andnot": -5, "rev_andnot": -6}

_lib = None
_lib_mu = threading.Lock()


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ---------------------------------------------------------------------------
# build + binding
# ---------------------------------------------------------------------------


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (PATH or $CUDA_HOME/bin)")


def build() -> Path:
    """Compile the kernel library if this source hash has no build yet;
    return its path. Raises with nvcc's stderr on failure."""
    sources = sorted(_SRC_DIR.glob("*.cu"))
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    out = _BUILD_DIR / f"libpilosa_kernels_{h.hexdigest()[:16]}.so"
    if out.exists():
        return out
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, sources)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed with exit code {proc.returncode}:\n{proc.stderr}"
        )
    BUILD_LOG["text"] = proc.stderr
    os.replace(tmp, out)
    return out


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    lib.pt_count2.argtypes = [p, p, i64, i32, i32, p, p]
    lib.pt_rows_counts.argtypes = [p, i64, i64, p, i64, i32, p, p]
    lib.pt_plan_count.argtypes = [p, i64, i64, i64, i64, p, p]
    lib.pt_gather_tally.argtypes = [p, p, p, p, p, i64, p, p]
    for fn in (lib.pt_count2, lib.pt_rows_counts, lib.pt_plan_count, lib.pt_gather_tally):
        fn.restype = ctypes.c_int
    return lib


def library() -> ctypes.CDLL:
    """The loaded kernel library, building it on first use."""
    global _lib
    with _lib_mu:
        if _lib is None:
            _lib = _bind(ctypes.CDLL(str(build())))
        return _lib


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _launched(name: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")
    LAUNCHES[name] += 1


def _words(t: torch.Tensor, what: str) -> None:
    if t.dtype != torch.int32:
        raise TypeError(f"{what}: want int32 words, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{what}: tensor must be contiguous")


def _route(*ts: torch.Tensor) -> str:
    """'cpu' (twin) or 'cuda' (kernel); every tensor on one device."""
    dev = ts[0].device
    for t in ts[1:]:
        if t.device != dev:
            raise ValueError(f"tensors on different devices: {dev} vs {t.device}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return dev.type


def _aligned(*ts: torch.Tensor) -> bool:
    return all(t.data_ptr() % 16 == 0 for t in ts)


# ---------------------------------------------------------------------------
# count2 / popcount  (Pallas _count2 + popcount)
# ---------------------------------------------------------------------------


def count2_plain(a: torch.Tensor, b: Optional[torch.Tensor], op: str) -> torch.Tensor:
    if op == "none":
        x = a
    elif op == "and":
        x = a & b
    elif op == "or":
        x = a | b
    elif op == "xor":
        x = a ^ b
    elif op == "andnot":
        x = a & ~b
    else:
        raise ValueError(f"unknown op {op!r}")
    return popcount_words(x).sum(dtype=torch.int64) & MASK32


def count2(a: torch.Tensor, b: Optional[torch.Tensor], op: str) -> torch.Tensor:
    """Sum of popcount(a op b) over every word, wrapping mod 2^32 as the
    TPU kernel's int32 accumulator does; op "none" is plain popcount of a
    (b is None). Returns a 0-d int64 tensor in [0, 2^32) on a's device."""
    if op not in _OPS:
        raise ValueError(f"unknown op {op!r}")
    if (op == "none") != (b is None):
        raise ValueError("op 'none' takes no second operand; the others need one")
    ts = (a,) if b is None else (a, b)
    for t in ts:
        _words(t, "count2")
    if b is not None and a.shape != b.shape:
        raise ValueError(f"count2: shapes differ {tuple(a.shape)} vs {tuple(b.shape)}")
    if _route(*ts) == "cpu":
        return count2_plain(a, b, op)
    out = torch.zeros(1, dtype=torch.int32, device=a.device)
    n = a.numel()
    rc = library().pt_count2(
        a.data_ptr(),
        0 if b is None else b.data_ptr(),
        n,
        _OPS[op],
        int(_aligned(*ts)),
        out.data_ptr(),
        _stream(a),
    )
    _launched("count2", rc)
    return out[0].to(torch.int64) & MASK32


def popcount(a: torch.Tensor) -> torch.Tensor:
    """Total set bits over all axes, mod 2^32 (Pallas `popcount`)."""
    return count2(a, None, "none")


# ---------------------------------------------------------------------------
# rows_counts  (Pallas _rows_counts)
# ---------------------------------------------------------------------------


def _filter_rows(filt: Optional[torch.Tensor], w: int) -> int:
    if filt is None:
        return 0
    if filt.dim() == 1:
        if filt.shape[0] != w:
            raise ValueError(f"rows_counts: filter width {filt.shape[0]} != {w}")
        return 1
    if filt.dim() != 2 or filt.shape[1] != w or filt.shape[0] < 1:
        raise ValueError(f"rows_counts: filter shape {tuple(filt.shape)}")
    return filt.shape[0]


def rows_counts_plain(stack: torch.Tensor, filt: Optional[torch.Tensor] = None) -> torch.Tensor:
    words = stack
    if filt is not None:
        f = filt.reshape(-1, stack.shape[1])
        sel = torch.arange(stack.shape[0], device=stack.device) % f.shape[0]
        words = stack & f[sel]
    return popcount_words(words).sum(dim=-1, dtype=torch.int64).to(torch.int32)


def rows_counts(stack: torch.Tensor, filt: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-row popcount of stack[R, W], each row optionally ANDed with a
    filter: none, one broadcast row [W], or an [F, W] stack whose row
    r % F meets row r (the TopN dense tally: an [R', S, W] plane stack
    flattened to rows against the [S, W] filter stack). Returns int32[R]
    (one row holds at most 2^30 bits, so no count wraps)."""
    if stack.dim() != 2:
        raise ValueError(f"rows_counts: want [R, W], got {tuple(stack.shape)}")
    _words(stack, "rows_counts")
    r, w = stack.shape
    f_rows = _filter_rows(filt, w)
    ts = (stack,) if filt is None else (stack, filt)
    if filt is not None:
        _words(filt, "rows_counts filter")
    if _route(*ts) == "cpu":
        return rows_counts_plain(stack, filt)
    out = torch.empty(r, dtype=torch.int32, device=stack.device)
    rc = library().pt_rows_counts(
        stack.data_ptr(),
        r,
        w,
        0 if filt is None else filt.data_ptr(),
        f_rows,
        int(w % 4 == 0 and _aligned(*ts)),
        out.data_ptr(),
        _stream(stack),
    )
    _launched("rows_counts", rc)
    return out


# ---------------------------------------------------------------------------
# plan_count  (exec/plan.py _eval_jit + _root_out "count")
# ---------------------------------------------------------------------------


def check_program(n_leaves: int, prog: Sequence[int]) -> None:
    """Validate a postfix plan program: leaf indices in range, stack depth
    within the kernel's, exactly one value left."""
    if not prog:
        raise ValueError("plan program is empty")
    depth = 0
    for ins in prog:
        if ins >= 0:
            if ins >= n_leaves:
                raise ValueError(f"plan program: leaf {ins} of {n_leaves}")
            depth += 1
        elif ins == PUSH_ZERO:
            depth += 1
        elif ins in BINOPS.values():
            if depth < 2:
                raise ValueError("plan program: operator without two operands")
            depth -= 1
        else:
            raise ValueError(f"plan program: bad instruction {ins}")
        if depth > MAX_STACK:
            raise ValueError(f"plan program needs stack depth > {MAX_STACK}")
    if depth != 1:
        raise ValueError("plan program leaves more than one value")


def plan_count_plain(
    leaves: Sequence[torch.Tensor], prog: Sequence[int], shards: int
) -> torch.Tensor:
    names = {v: k for k, v in BINOPS.items()}
    st: List[torch.Tensor] = []
    w = leaves[0].shape[1] if leaves else 0
    dev = leaves[0].device if leaves else torch.device("cpu")
    for ins in prog:
        if ins >= 0:
            st.append(leaves[ins][:shards])
        elif ins == PUSH_ZERO:
            st.append(torch.zeros((shards, w), dtype=torch.int32, device=dev))
        else:
            b = st.pop()
            a = st.pop()
            op = names[ins]
            if op == "and":
                st.append(a & b)
            elif op == "or":
                st.append(a | b)
            elif op == "xor":
                st.append(a ^ b)
            elif op == "andnot":
                st.append(a & ~b)
            else:  # rev_andnot
                st.append(b & ~a)
    return popcount_words(st[0]).sum(dim=-1, dtype=torch.int64)


def plan_count(
    leaves: Sequence[torch.Tensor], prog: Sequence[int], shards: int
) -> torch.Tensor:
    """Per-shard counts of one plan root: the postfix program `prog` over
    the [>=shards, W] leaf stacks, popcount, summed per shard row, for the
    first `shards` rows. Returns int64[shards]."""
    if not leaves:
        raise ValueError("plan_count needs at least one leaf (it fixes W)")
    check_program(len(leaves), prog)
    w = leaves[0].shape[1]
    for t in leaves:
        _words(t, "plan_count leaf")
        if t.dim() != 2 or t.shape[1] != w or t.shape[0] < shards:
            raise ValueError(f"plan_count: leaf shape {tuple(t.shape)}")
    if _route(*leaves) == "cpu":
        return plan_count_plain(leaves, prog, shards)
    if w % 4 != 0 or not _aligned(*leaves):
        raise ValueError("plan_count: W % 4 != 0 or a leaf not 16-byte aligned")
    dev = leaves[0].device
    out = torch.zeros(shards, dtype=torch.int64, device=dev)
    # leaf pointers then instructions, in one device buffer (copied on the
    # launch stream, so the kernel sees it)
    table = torch.tensor([t.data_ptr() for t in leaves] + list(prog), dtype=torch.int64)
    table = table.to(dev)
    rc = library().pt_plan_count(
        table.data_ptr(),
        len(leaves),
        len(prog),
        shards,
        w,
        out.data_ptr(),
        _stream(leaves[0]),
    )
    _launched("plan_count", rc)
    return out


# ---------------------------------------------------------------------------
# gather_tally  (ops/bitmap.py gather_tally_sorted)
# ---------------------------------------------------------------------------


def gather_tally_plain(src, idx, mask, starts, ends) -> torch.Tensor:
    vals = popcount_words(src.reshape(-1)[idx.long()] & mask)
    cum = torch.cat([vals.new_zeros(1), torch.cumsum(vals, 0)])
    return (cum[ends.long()] - cum[starts.long()]).to(torch.int32)


def gather_tally(
    src: torch.Tensor,
    idx: torch.Tensor,
    mask: torch.Tensor,
    starts: torch.Tensor,
    ends: torch.Tensor,
) -> torch.Tensor:
    """Segment sums of popcount(src.flat[idx[k]] & mask[k]) over sorted
    half-open [starts[g], ends[g]) entry ranges -> int32[n_seg]. The
    caller bounds the entry count by 2^27, so sums are exact."""
    for t, what in ((src, "src"), (idx, "idx"), (mask, "mask"), (starts, "starts"), (ends, "ends")):
        _words(t, f"gather_tally {what}")
    if idx.shape != mask.shape or starts.shape != ends.shape:
        raise ValueError("gather_tally: idx/mask or starts/ends shapes differ")
    if _route(src, idx, mask, starts, ends) == "cpu":
        return gather_tally_plain(src, idx, mask, starts, ends)
    n_seg = starts.numel()
    out = torch.empty(n_seg, dtype=torch.int32, device=src.device)
    rc = library().pt_gather_tally(
        src.data_ptr(),
        idx.data_ptr(),
        mask.data_ptr(),
        starts.data_ptr(),
        ends.data_ptr(),
        n_seg,
        out.data_ptr(),
        _stream(src),
    )
    _launched("gather_tally", rc)
    return out

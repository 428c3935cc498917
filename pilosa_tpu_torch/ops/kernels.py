"""The port's hand-written CUDA kernels: build, binding, dispatch and
their plain-PyTorch twins.

Each kernel function below takes int32 word tensors (the bits of the
reference's uint32 words). On a CUDA tensor it launches its kernel from
`cuda/bitmap_kernels.cu`, `cuda/bsi_kernels.cu` or
`cuda/merge_kernels.cu`; on a CPU tensor it runs its twin, which has the
same contract and is the oracle the kernel is held to. There is no other
route: a CUDA tensor never reaches a twin through these functions, and a
failed build or launch raises.

| function          | replaces (TPU side)                                 |
|-------------------|-----------------------------------------------------|
| `count2_segments` | pallas_kernels.py `_count2` and `popcount`, for a   |
|                   | list of segments in one launch (`count2` and        |
|                   | `popcount` are its one-segment case)                |
| `rows_counts`     | pallas_kernels.py `_rows_counts`                    |
| `plan_count`      | exec/plan.py `_eval_jit`/`_root_out` (XLA program)  |
| `plan_count_multi`| exec/plan.py `_eval_multi_jit`/`_root_out`: N roots |
|                   | over one shared leaf set in one launch              |
| `plan_rows`       | exec/plan.py `_eval_jit(plan, "row")` with          |
|                   | ops/bitmap.py `shift_bits` (XLA program)            |
| `gather_tally`    | ops/bitmap.py `gather_tally_sorted` (XLA program)   |
| `counts_cross`    | exec/groupby.py `_counts_cross` (XLA program)       |
| `gather_and`      | exec/groupby.py `_select_rows_filtered`,            |
|                   | `_select_pairs`, `_cross_expand` (XLA programs)     |
| `bsi_sum`         | pallas_kernels.py `sum_counts` (`_bsi_sum_kernel`)  |
| `bsi_min_max`     | ops/bsi.py `min_max_stream` (XLA program)           |
| `bsi_min_max_step`| ops/bsi.py `min_max_stream_step` and `_finish`: one |
|                   | slab of planes with carried state (XLA programs)    |
| `bsi_range`       | ops/bsi.py `range_*_unsigned` (XLA programs)        |
| `bsi_range_step`  | ops/bsi.py `range_stream_single`, `_step` and       |
|                   | `_finish`: every job of a condition over one slab   |
| `or_bits`         | core/view.py `_patch_entry`'s gather/OR/scatter:    |
|                   | the barrier's merged bit keys ORed into a resident  |
|                   | entry; wrapper and twin in ops/merge.py             |
| `merge_mark`      | ops/merge.py `_merge_sorted_u64` after its sort;    |
|                   | wrapper and twin in ops/merge.py                    |

All of them read every input word once (counts_cross: once per 16
prefixes and 8 rows, with its ANDs and popcounts on the tensor cores as
binary mma's) and do a few bitwise operations and popcounts per word, so
on the card they are bound by device-memory bytes. The twins of
counts_cross and gather_and live in ops/bitmap.py.

Each `.cu` source is compiled lazily, at the first CUDA launch, with its
own `nvcc` process (all started together) into `ops/_build/`, under a
name keyed by a hash of the sources and flags, and loaded with ctypes
(pointers and the stream pass as c_void_p, predicates as c_uint32).
`LAUNCHES` counts kernel launches per kernel (`count2_segments`, `count2`
and `popcount` launches count under `count2`: one kernel template serves
them all); only the CUDA route counts.

`count2_segments`, `plan_count`, `plan_count_multi`, `plan_rows` and `or_bits`
take a table built on the
host for each launch (segment pointers and lengths; leaf pointers and the
micro program; key chunks). It goes through `_Staging`, a ring of pinned host slots: the C
entry point copies the slot to the card asynchronously on the launch
stream, zeros for the output included, so a launch makes no pageable
copy and no separate memset.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from pilosa_tpu_torch.ops import bitmap as ob
from pilosa_tpu_torch.ops import bsi as obsi
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
LAUNCHES = {
    "count2": 0,
    "rows_counts": 0,
    "plan_count": 0,
    "plan_count_multi": 0,
    "plan_rows": 0,
    "gather_tally": 0,
    "counts_cross": 0,
    "gather_and": 0,
    "bsi_sum": 0,
    "bsi_min_max": 0,
    "bsi_min_max_step": 0,
    "bsi_range": 0,
    "bsi_range_step": 0,
    "or_bits": 0,
    "merge_mark": 0,
}

# nvcc's stderr of the builds this process ran (ptxas register/spill
# report), or "" when the libraries were already built
BUILD_LOG = {"text": ""}

_OPS = {"none": 0, "and": 1, "or": 2, "xor": 3, "andnot": 4}

# bsi_range encodings (mirror bsi_kernels.cu)
RANGE_KINDS = {"eq": 0, "lt": 1, "gt": 2, "between": 3}
RANGE_SELS = {"consider": 0, "pos": 1, "neg": 2}
RANGE_MODES = ("rows", "count")

# grid-stride kernels (bsi_sum, bsi_min_max and the two step kernels): 132
# SMs x 16 blocks, more only where a thread would otherwise walk over 256
# items (the bound of the 32-bit block counters)
_THREADS = 256
_MAX_GRID = 132 * 16
_MAX_ITEMS_PER_THREAD = 256

# words in one count2 work item (mirrors kTileWords in bitmap_kernels.cu)
COUNT2_TILE_WORDS = 4096

# plan_count program encoding (mirrors bitmap_kernels.cu). Leaves and
# instructions are unbounded; the operand stack holds MAX_STACK entries,
# which a program compiled deepest-child-first needs only past 2^31 leaves.
MAX_STACK = 32
PUSH_ZERO = -1
# "andnot" is below & ~top; "rev_andnot" is top & ~below
BINOPS = {"and": -2, "or": -3, "xor": -4, "andnot": -5, "rev_andnot": -6}
# the kernel's micro program (plan_micro_program; mirrors MicroKind and
# binop in bitmap_kernels.cu)
MICRO_KINDS = {"push": 0, "zero": 1, "leaf_op": 2, "zero_op": 3, "stack_op": 4}
MICRO_OPS = {BINOPS[k]: i for i, k in enumerate(("and", "or", "xor", "andnot", "rev_andnot"))}

_lib = None
_lib_mu = threading.Lock()


_LAUNCHES_MU = threading.Lock()


def reset_launches() -> None:
    with _LAUNCHES_MU:
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


def build() -> List[Path]:
    """Compile each kernel source whose hash has no build yet, one nvcc
    process per source, all started together; return the libraries'
    paths. Raises with nvcc's stderr on failure."""
    sources = sorted(_SRC_DIR.glob("*.cu"))
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    tag = h.hexdigest()[:16]
    outs = [_BUILD_DIR / f"lib{src.stem}_{tag}.so" for src in sources]
    todo = [(src, out) for src, out in zip(sources, outs) if not out.exists()]
    if todo:
        _BUILD_DIR.mkdir(parents=True, exist_ok=True)
        procs = []
        for src, out in todo:
            tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
            procs.append((src, out, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True
            )))
        logs, failed = [], []
        for src, out, tmp, proc in procs:
            _, err = proc.communicate()
            logs.append(f"== {src.name}\n{err}")
            if proc.returncode != 0:
                failed.append(f"nvcc failed on {src.name} with exit code {proc.returncode}:\n{err}")
            else:
                os.replace(tmp, out)
        if failed:
            raise RuntimeError("\n".join(failed))
        BUILD_LOG["text"] = "\n".join(logs)
    return outs


class _Library:
    """The kernels' C entry points, gathered from the per-source
    libraries."""

    def __init__(self, libs: Sequence[ctypes.CDLL]):
        p, i64, i32, u32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_uint32
        argtypes = {
            "pt_count2": [p, i64, p, i64, i64, i32, p],
            "pt_rows_counts": [p, i64, i64, p, i64, i32, p, p],
            "pt_plan_count": [p, i64, p, i64, i64, i64, i64, i64, p],
            "pt_plan_count_multi": [p, i64, p, i64, i64, i64, i64, i64, i64, i64, i64, i64, i64, p],
            "pt_plan_rows": [p, i64, p, i64, i64, i64, i64, i64, p, p],
            "pt_gather_tally": [p, i64, p, p, i64, p, p, i64, p, p],
            "pt_counts_cross": [p, i64, p, i64, i64, i64, i32, p, p],
            "pt_b1_mma_probe": [i64, i64, p, p],
            "pt_gather_and": [p, p, p, p, i64, i64, i32, p, p],
            "pt_bsi_sum": [p, p, p, p, i32, i64, i32, i32, p, p],
            "pt_bsi_min_max": [p, p, p, p, i32, i64, i32, i32, i32, i32, p, p, i32, i32, p, p, p, p],
            "pt_bsi_range": [p, p, p, i32, i64, i64, i32, i32, i32, u32, u32, i32, i32, p, p],
            "pt_bsi_range_step": [p, p, p, p, p, i32, i32, i32, i32, i64, i32, i32, p, p],
            "pt_merge_mark": [p, i64, p, p, p],
            "pt_or_bits": [p, i64, p, p, p, i64, i64, p],
        }
        for name, types in argtypes.items():
            fn = next((getattr(lib, name) for lib in libs if hasattr(lib, name)), None)
            if fn is None:
                raise RuntimeError(f"kernel entry point {name} is missing from the build")
            fn.argtypes = types
            fn.restype = ctypes.c_int
            setattr(self, name, fn)


def library() -> _Library:
    """The loaded kernel libraries, building them on first use."""
    global _lib
    with _lib_mu:
        if _lib is None:
            _lib = _Library([ctypes.CDLL(str(path)) for path in build()])
        return _lib


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _launched(name: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")
    with _LAUNCHES_MU:  # HTTP handler threads launch concurrently
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


class _Staging:
    """Pinned host slots for the tables that count2, plan_count, plan_rows and or_bits
    copy to the card with each launch. The C entry point copies the slot to the
    device table asynchronously on the launch stream, right before the
    kernel, so the host never waits on a pageable copy. An event recorded
    after the launch guards the slot: it is rewritten only once that event
    has completed, so at most `slots` launches run ahead of the card."""

    def __init__(self, slots: int = 32):
        self._host: List[Optional[torch.Tensor]] = [None] * slots
        self._arr: List[Optional[np.ndarray]] = [None] * slots
        self._done: List[Optional[torch.cuda.Event]] = [None] * slots
        self._next = 0
        self._mu = threading.Lock()

    def launch(self, dev: torch.device, parts, call):
        """Write `parts` (int64 sequences) back to back into a pinned slot,
        then `call(host_ptr, nbytes, table_ptr, stream)`, which copies the
        slot into a fresh device table of the same length and launches on
        it. Returns (device table, the call's return code)."""
        n = sum(len(p) for p in parts)
        table = torch.empty(n, dtype=torch.int64, device=dev)
        stream = torch.cuda.current_stream(dev)
        with self._mu:
            k = self._next
            self._next = (k + 1) % len(self._host)
            if self._done[k] is not None:
                self._done[k].synchronize()
            if self._host[k] is None or self._host[k].numel() < n:
                self._host[k] = torch.empty(max(n, 4096), dtype=torch.int64, pin_memory=True)
                self._arr[k] = self._host[k].numpy()
            arr = self._arr[k]
            off = 0
            for p in parts:
                arr[off : off + len(p)] = p
                off += len(p)
            rc = call(self._host[k].data_ptr(), n * 8, table.data_ptr(), stream.cuda_stream)
            done = torch.cuda.Event()
            done.record(stream)
            self._done[k] = done
        return table, rc


_STAGING = _Staging()


# ---------------------------------------------------------------------------
# count2 / popcount  (Pallas _count2 + popcount)
# ---------------------------------------------------------------------------


def _apply_op(a: torch.Tensor, b: Optional[torch.Tensor], op: str) -> torch.Tensor:
    if op == "none":
        return a
    if op == "and":
        return a & b
    if op == "or":
        return a | b
    if op == "xor":
        return a ^ b
    if op == "andnot":
        return a & ~b
    raise ValueError(f"unknown op {op!r}")


def count2_segments_plain(a_list, b_list, op: str) -> torch.Tensor:
    a_list = list(a_list)
    bs = [None] * len(a_list) if b_list is None else list(b_list)
    if not a_list:
        return torch.zeros(0, dtype=torch.int64)
    return torch.stack(
        [popcount_words(_apply_op(a, b, op)).sum(dtype=torch.int64) for a, b in zip(a_list, bs)]
    )


def count2_segments(
    a_list: Sequence[torch.Tensor], b_list: Optional[Sequence[torch.Tensor]], op: str
) -> torch.Tensor:
    """popcount(a_i op b_i) summed over the words of each segment i, for
    every segment in one launch: exact int64[n] on the segments' device (an
    empty CPU tensor for no segments). op "none" counts a_i alone (b_list
    None). Segments are contiguous int32 tensors of any shape and width,
    aligned or not; a_i and b_i have one shape."""
    if op not in _OPS:
        raise ValueError(f"unknown op {op!r}")
    if (op == "none") != (b_list is None):
        raise ValueError("op 'none' takes no second operand list; the others need one")
    a_list = list(a_list)
    b_list = None if b_list is None else list(b_list)
    if b_list is not None and len(b_list) != len(a_list):
        raise ValueError(f"count2: {len(a_list)} first operands vs {len(b_list)} second")
    ts = a_list if b_list is None else a_list + b_list
    if not ts:
        return torch.zeros(0, dtype=torch.int64)
    # one cheap pass over every segment (Row.count() hands over 1024);
    # the helpers name what is wrong
    dev = ts[0].device
    for t in ts:
        if t.dtype != torch.int32 or not t.is_contiguous() or t.device != dev:
            _words(t, "count2")
            _route(ts[0], t)
    if b_list is not None:
        for a, b in zip(a_list, b_list):
            if a.shape != b.shape:
                raise ValueError(f"count2: shapes differ {tuple(a.shape)} vs {tuple(b.shape)}")
    if _route(ts[0]) == "cpu":
        return count2_segments_plain(a_list, b_list, op)
    n = len(a_list)
    lens = np.fromiter((t.numel() for t in a_list), np.int64, n)
    first = np.zeros(n + 1, np.int64)
    np.cumsum(-(-lens // COUNT2_TILE_WORDS), out=first[1:])
    n_items = int(first[-1])
    if n_items == 0:  # every segment is empty: nothing to launch
        return torch.zeros(n, dtype=torch.int64, device=dev)
    a_ptrs = [t.data_ptr() for t in a_list]
    b_ptrs = [t.data_ptr() for t in b_list] if b_list is not None else np.zeros(n, np.int64)
    table, rc = _STAGING.launch(
        dev,
        (np.zeros(n, np.int64), a_ptrs, b_ptrs, lens, first),
        lambda host, nbytes, tab, stream: library().pt_count2(
            host, nbytes, tab, n, n_items, _OPS[op], stream
        ),
    )
    _launched("count2", rc)
    return table[:n]


def count2_plain(a: torch.Tensor, b: Optional[torch.Tensor], op: str) -> torch.Tensor:
    return count2_segments_plain([a], None if b is None else [b], op)[0] & MASK32


def count2(a: torch.Tensor, b: Optional[torch.Tensor], op: str) -> torch.Tensor:
    """Sum of popcount(a op b) over every word, wrapping mod 2^32 as the
    TPU kernel's int32 accumulator does; op "none" is plain popcount of a
    (b is None). Returns a 0-d int64 tensor in [0, 2^32) on a's device:
    the one-segment case of `count2_segments`."""
    return count2_segments([a], None if b is None else [b], op)[0] & MASK32


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


def plan_micro_program(prog: Sequence[int]) -> Tuple[List[int], List[int], int]:
    """The plan_count kernel's form of a checked postfix program: (micro
    codes, the leaf index of each push in program order, the stack entries
    below the top that it needs). A code is kind * 8 + op (MICRO_KINDS,
    MICRO_OPS). A push of a leaf or of zeros that an operator follows is
    folded into that operator, so only values that wait for a later
    operand are stacked: a wide union or a two-leaf intersection needs no
    stack entry at all."""
    codes: List[int] = []
    pushes: List[int] = []
    depth = most = 0
    i = 0
    while i < len(prog):
        ins = prog[i]
        if ins >= PUSH_ZERO:
            if ins >= 0:
                pushes.append(ins)
            nxt = prog[i + 1] if i + 1 < len(prog) else PUSH_ZERO
            if nxt < PUSH_ZERO:
                kind = MICRO_KINDS["leaf_op" if ins >= 0 else "zero_op"]
                codes.append(kind * 8 + MICRO_OPS[nxt])
                i += 2
                continue
            codes.append(MICRO_KINDS["push" if ins >= 0 else "zero"] * 8)
            depth += 1
            most = max(most, depth)
        else:
            codes.append(MICRO_KINDS["stack_op"] * 8 + MICRO_OPS[ins])
            depth -= 1
        i += 1
    return codes, pushes, most - 1


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
    if shards == 0 or w == 0:  # nothing to count: nothing to launch
        return torch.zeros(shards, dtype=torch.int64, device=dev)
    codes, pushes, slots = plan_micro_program(prog)
    ptrs = [t.data_ptr() for t in leaves]
    # the table: zeros for the output, each push's leaf pointer, the codes
    table, rc = _STAGING.launch(
        dev,
        (np.zeros(shards, np.int64), [ptrs[i] for i in pushes], codes),
        lambda host, nbytes, tab, stream: library().pt_plan_count(
            host, nbytes, tab, shards, len(pushes), len(codes), slots, w, stream
        ),
    )
    _launched("plan_count", rc)
    return table[:shards]


# ---------------------------------------------------------------------------
# plan_count_multi  (exec/plan.py _eval_multi_jit + _root_out "count")
# ---------------------------------------------------------------------------

# mirrors bitmap_kernels.cu: consumer threads a block (four warps; a
# producer warp runs beside them), roots a launch, the shared memory a
# launch may take and the part of it its slots leave for the per-lane
# root counters and, where it fits, the table
MULTI_THREADS = 128
MULTI_WARPS = MULTI_THREADS // 32
MULTI_MAX_ROOTS = 64
MULTI_SMEM_BYTES = 226 * 1024
MULTI_COUNTER_SMEM_BYTES = 16384
# one leaf tile (or stack entry) of one uint4 a thread: a launch at VEC v
# takes v of these a leaf slot and buffer, and L of these a stack entry
MULTI_TILE_BYTES = MULTI_THREADS * 16
# the table's 32-bit entries copied to shared memory; a longer table is
# read from device memory
MULTI_TABLE_SMEM_ENTRIES = 2048
# uint4 a thread an item (VEC), uint4 a lane a pass (L) and ring buffers
# the kernel takes (the launcher uses one or two buffers)
MULTI_VECS = (1, 2)
MULTI_LANES = (1, 2, 4, 8)
MULTI_MAX_BUF = 4
# what bounds a launch's resident blocks an SM: the SM's shared memory
# (228 KiB, 1 KiB of it reserved a block, 64 B of static barriers a
# block), its 2048 threads, and the registers the kernel's
# __launch_bounds__ allow at each L (multi_min_blocks in bitmap_kernels.cu)
MULTI_SM_SMEM_BYTES = 228 * 1024
MULTI_BLOCK_SMEM_EXTRA = 1024 + 64
MULTI_SM_THREADS = 2048
MULTI_LANE_BLOCKS = {1: 8, 2: 7, 4: 5, 8: 3}
# code bits below the leaf slot (kind * 8 + op < 64)
_MULTI_SLOT_SHIFT = 6


def multi_table_entries(n_root: int, n_code: int) -> int:
    """32-bit entries of a launch's table: each warp's first root and the
    end, each root's output row, its first code and the end, the codes,
    one padding entry."""
    return MULTI_WARPS + 3 + 2 * n_root + n_code


def multi_smem_bytes(n_root: int, n_leaf: int, stack: int, vec: int, nbuf: int, lanes: int,
                     table_entries: int) -> int:
    """Dynamic shared memory of a plan_count_multi launch (mirrors
    multi_smem_bytes in bitmap_kernels.cu): the ring of `nbuf` buffers of
    `n_leaf` slots, the warps' stacks (`lanes` uint4 a lane and entry),
    a 32-bit counter a root and lane, and the table if it is kept there
    (`table_entries` > 0)."""
    return ((nbuf * n_leaf * vec + stack * lanes) * MULTI_TILE_BYTES + n_root * 32 * 4
            + (table_entries * 4 + 15) // 16 * 16)


def multi_launch_ok(n_root: int, n_leaf: int, n_code: int, stack: int, vec: int, nbuf: int, lanes: int,
                    table_in_smem: bool) -> bool:
    """Whether pt_plan_count_multi takes a launch of this shape and layout
    (mirrors its argument check)."""
    entries = multi_table_entries(n_root, n_code)
    return (
        1 <= n_root <= MULTI_MAX_ROOTS and n_leaf >= 0 and n_code >= n_root and 0 <= stack < MAX_STACK
        and (n_leaf + stack) * MULTI_TILE_BYTES + MULTI_COUNTER_SMEM_BYTES <= MULTI_SMEM_BYTES
        and vec in MULTI_VECS and 1 <= nbuf <= MULTI_MAX_BUF and lanes in MULTI_LANES and lanes <= 4 * vec
        and not (table_in_smem and entries > MULTI_TABLE_SMEM_ENTRIES)
        and multi_smem_bytes(n_root, n_leaf, stack, vec, nbuf, lanes, entries if table_in_smem else 0)
        <= MULTI_SMEM_BYTES
    )


def multi_resident_blocks(smem: int, lanes: int) -> int:
    """Blocks of a plan_count_multi launch an SM holds at once, taking
    `smem` bytes of dynamic shared memory at L = `lanes`."""
    return min(
        MULTI_SM_SMEM_BYTES // (smem + MULTI_BLOCK_SMEM_EXTRA),
        MULTI_LANE_BLOCKS[lanes],
        MULTI_SM_THREADS // (MULTI_THREADS + 32),
    )


@functools.lru_cache(maxsize=4096)
def plan_count_multi_layout(n_root: int, n_leaf: int, n_code: int, stack: int) -> Tuple[int, int, int, bool]:
    """(VEC, nbuf, L, table in shared memory) of a plan_count_multi
    launch: of the layouts the kernel takes with one or two ring
    buffers, the one with the most uint4 loads in flight an SM (resident
    blocks x L: each code's loads are L a lane, and the programs, not the
    copies, bound the kernel), then two buffers over one, wider L, the
    table in shared memory, and the least shared memory. Any group
    plan_count_multi_groups makes has one (VEC 1, one buffer, L 1 at the
    cap)."""
    entries = multi_table_entries(n_root, n_code)
    best, best_key = None, None
    for vec in MULTI_VECS:
        for nbuf in (1, 2):  # a deeper ring costs resident blocks and lost at every shape measured
            for lanes in MULTI_LANES:
                for tab in (True, False):
                    if not multi_launch_ok(n_root, n_leaf, n_code, stack, vec, nbuf, lanes, tab):
                        continue
                    smem = multi_smem_bytes(n_root, n_leaf, stack, vec, nbuf, lanes, entries if tab else 0)
                    key = (multi_resident_blocks(smem, lanes) * lanes, nbuf, lanes, tab, -smem)
                    if best_key is None or key > best_key:
                        best, best_key = (vec, nbuf, lanes, tab), key
    if best is None:
        raise ValueError(
            f"plan_count_multi: {n_root} roots over {n_leaf} leaves and {stack} stack slots do not fit a launch"
        )
    return best


def plan_count_multi_warps(starts: Sequence[int]) -> List[List[int]]:
    """The roots (positions in the launch) each consumer warp runs: the
    longest programs first, each to the warp with the fewest codes so far
    (a root costs its codes and one popcount pass), in launch order
    within a warp."""
    loads = [0] * MULTI_WARPS
    warps: List[List[int]] = [[] for _ in range(MULTI_WARPS)]
    cost = [starts[k + 1] - starts[k] + 1 for k in range(len(starts) - 1)]
    for k in sorted(range(len(cost)), key=lambda k: (-cost[k], k)):
        w = min(range(MULTI_WARPS), key=lambda w: (loads[w], w))
        warps[w].append(k)
        loads[w] += cost[k]
    return [sorted(ks) for ks in warps]


def multi_flat_op(codes: Sequence[int]) -> int:
    """1 + the op of a flat root's codes (a leaf push, then leaf_ops of one
    op: one n-ary node over leaves), which the kernel runs with the op
    hoisted out of its loop; 0 for any other root."""
    ops = {c & 7 for c in codes[1:]}
    if (codes[0] >> 3) & 7 != MICRO_KINDS["push"] or len(ops) > 1:
        return 0
    if any((c >> 3) & 7 != MICRO_KINDS["leaf_op"] for c in codes[1:]):
        return 0
    return 1 + (ops.pop() if ops else 0)


def plan_count_multi_table32(starts: Sequence[int], codes: Sequence[int]) -> np.ndarray:
    """A launch's 32-bit table packed into int64 table words: the first
    root of each warp and the end, each root's output row (its position
    in the launch) plus 256 * multi_flat_op of its codes, each root's
    first code and the end, the codes, one padding entry (the kernel
    reads each code one ahead), the roots in warp order
    (plan_count_multi_warps), zero-padded to whole words."""
    firsts, rows, new_starts, body = [0], [], [0], []
    for ks in plan_count_multi_warps(starts):
        firsts.append(firsts[-1] + len(ks))
        for k in ks:
            own = codes[starts[k] : starts[k + 1]]
            rows.append(k + 256 * multi_flat_op(own))
            body += own
            new_starts.append(len(body))
    t = firsts + rows + new_starts + body + [0]
    return np.array(t + [0] * (len(t) % 2), np.int32).view(np.int64)


def plan_count_multi_plain(
    leaves: Sequence[torch.Tensor], progs: Sequence[Sequence[int]], shards: int
) -> torch.Tensor:
    return torch.stack([plan_count_plain(leaves, p, shards) for p in progs])


def _multi_slots(prog: Sequence[int]) -> int:
    """Shared-memory slots a root takes in a plan_count_multi launch: its
    distinct leaves and its stack entries."""
    _, pushes, slots = plan_micro_program(prog)
    return len(set(pushes)) + slots


# the VEC-1 slots one launch holds beside its counters
MULTI_CAP = (MULTI_SMEM_BYTES - MULTI_COUNTER_SMEM_BYTES) // MULTI_TILE_BYTES


def fits_multi(prog: Sequence[int]) -> bool:
    """Whether a root fits a plan_count_multi launch at all. One that
    reads more distinct leaves than a launch's shared memory holds is a
    single-root program: plan_count streams any number of leaves."""
    return _multi_slots(prog) <= MULTI_CAP


def plan_count_multi_groups(progs: Sequence[Sequence[int]]) -> List[List[int]]:
    """The roots (indices into `progs`) of each plan_count_multi launch,
    in order: as few groups as fit one launch each, a group holding at
    most MULTI_MAX_ROOTS roots whose distinct leaves and deepest stack
    take at most MULTI_CAP VEC-1 slots (MULTI_SMEM_BYTES less the
    counters' share). Decided from
    each root's micro program (the leaves its pushes read, the stack
    entries it needs)."""
    cap = MULTI_CAP
    groups: List[List[int]] = []
    cur: List[int] = []
    cur_leaves: set = set()
    cur_stack = 0
    for r, prog in enumerate(progs):
        _, pushes, slots = plan_micro_program(prog)
        leaves = set(pushes)
        if len(leaves) + slots > cap:
            raise ValueError(f"plan_count_multi: a root reads {len(leaves)} leaves, more than one launch holds")
        union = cur_leaves | leaves
        stack = max(cur_stack, slots)
        if cur and (len(cur) == MULTI_MAX_ROOTS or len(union) + stack > cap):
            groups.append(cur)
            cur, union, stack = [], leaves, slots
        cur.append(r)
        cur_leaves, cur_stack = union, stack
    if cur:
        groups.append(cur)
    return groups


def plan_count_multi_tables(
    progs: Sequence[Sequence[int]],
) -> List[Tuple[List[int], List[int], List[int], List[int], int]]:
    """What each plan_count_multi launch is given, in launch order: (its
    roots, indices into `progs`; the leaf, an index into the leaves, of
    each shared-memory slot; each root's first code, then the end; the
    codes, plan_micro_program's with the slot of each push in the bits
    from _MULTI_SLOT_SHIFT up; the deepest stack of its roots)."""
    out = []
    for group in plan_count_multi_groups(progs):
        slot_of: dict = {}
        starts = [0]
        codes: List[int] = []
        stack = 0
        for r in group:
            micro, pushes, slots = plan_micro_program(progs[r])
            stack = max(stack, slots)
            j = 0
            for c in micro:
                if c >> 3 in (MICRO_KINDS["push"], MICRO_KINDS["leaf_op"]):
                    c += slot_of.setdefault(pushes[j], len(slot_of)) << _MULTI_SLOT_SHIFT
                    j += 1
                codes.append(c)
            starts.append(len(codes))
        out.append((group, list(slot_of), starts, codes, stack))  # dicts keep slot order
    return out


def plan_count_multi(
    leaves: Sequence[torch.Tensor], progs: Sequence[Sequence[int]], shards: int
) -> torch.Tensor:
    """Per-root, per-shard counts of N plan roots over one shared leaf
    set: root r's postfix program `progs[r]` (plan_count's encoding, leaf
    indices into `leaves`) over the [>=shards, W] leaf stacks, popcount,
    summed per shard row, for the first `shards` rows. Returns
    int64[N, shards]. One launch reads each distinct leaf a group's roots
    push once; roots split into more launches only where one launch's
    shared memory cannot hold their distinct leaves
    (plan_count_multi_groups)."""
    if not leaves:
        raise ValueError("plan_count_multi needs at least one leaf (it fixes W)")
    if not progs:
        raise ValueError("plan_count_multi needs at least one root")
    for prog in progs:
        check_program(len(leaves), prog)
    w = leaves[0].shape[1]
    for t in leaves:
        _words(t, "plan_count_multi leaf")
        if t.dim() != 2 or t.shape[1] != w or t.shape[0] < shards:
            raise ValueError(f"plan_count_multi: leaf shape {tuple(t.shape)}")
    if _route(*leaves) == "cpu":
        return plan_count_multi_plain(leaves, progs, shards)
    if w % 4 != 0 or not _aligned(*leaves):
        raise ValueError("plan_count_multi: W % 4 != 0 or a leaf not 16-byte aligned")
    dev = leaves[0].device
    tables = plan_count_multi_tables(progs)
    if shards == 0 or w == 0:  # nothing to count: nothing to launch
        return torch.zeros((len(progs), shards), dtype=torch.int64, device=dev)
    outs = []
    for group, slot_leaves, starts, codes, stack in tables:
        n = len(group)
        if not slot_leaves:  # every root of the group is all-zero
            outs.append(torch.zeros((n, shards), dtype=torch.int64, device=dev))
            continue
        ptrs = [leaves[i].data_ptr() for i in slot_leaves]
        vec, nbuf, lanes, tab_smem = plan_count_multi_layout(n, len(ptrs), len(codes), stack)
        # the table: zeros for the [n, shards] output, the leaf pointers,
        # the 32-bit warp, row, start and code entries
        table, rc = _STAGING.launch(
            dev,
            (np.zeros(n * shards, np.int64), ptrs, plan_count_multi_table32(starts, codes)),
            lambda host, nbytes, tab, stream: library().pt_plan_count_multi(
                host, nbytes, tab, shards, n, len(ptrs), len(codes), stack, vec, nbuf, lanes, int(tab_smem), w,
                stream,
            ),
        )
        _launched("plan_count_multi", rc)
        outs.append(table[: n * shards].view(n, shards))
    return outs[0] if len(outs) == 1 else torch.cat(outs)


# ---------------------------------------------------------------------------
# plan_rows  (exec/plan.py _eval_jit(plan, "row") with ops/bitmap.py
# shift_bits)
# ---------------------------------------------------------------------------


def check_shift(n: int, w: int) -> None:
    """A Shift amount must keep its overflow within the next shard (the
    reference's shift_bits error)."""
    if not 0 <= n <= w * 32:
        raise ValueError(
            f"shift amount {n} out of range [0, {w * 32}]: overflow may only "
            "carry into the immediately following shard"
        )


def _shifted_plain(leaf: torch.Tensor, n: int, prev: Sequence[int]) -> torch.Tensor:
    """Stack row i shifted up by n bits, the top n bits of row prev[i]
    carried in below (none where prev[i] < 0)."""
    shifted, overflow = ob.shift_bits(leaf, n)
    has_prev = np.asarray(prev, np.int64) >= 0
    if not has_prev.any():
        return shifted
    dev = leaf.device
    take = torch.from_numpy(np.where(has_prev, np.asarray(prev, np.int64), 0)).to(dev)
    keep = torch.from_numpy(has_prev).to(dev)[:, None]
    return shifted | torch.where(keep, overflow[take], torch.zeros_like(shifted))


def plan_rows_plain(leaves, shifts, prog) -> Tuple[torch.Tensor, torch.Tensor]:
    vals = [
        leaf if sh is None or sh[0] == 0 else _shifted_plain(leaf, sh[0], sh[1])
        for leaf, sh in zip(leaves, shifts)
    ]
    rows, w = leaves[0].shape
    names = {v: k for k, v in BINOPS.items()}
    st: List[torch.Tensor] = []
    for ins in prog:
        if ins >= 0:
            st.append(vals[ins])
        elif ins == PUSH_ZERO:
            st.append(torch.zeros((rows, w), dtype=torch.int32, device=leaves[0].device))
        else:
            b = st.pop()
            a = st.pop()
            st.append(_apply_op(b, a, "andnot") if names[ins] == "rev_andnot" else _apply_op(a, b, names[ins]))
    out = st[0]
    if any(out is t for t in leaves):  # the result is always a fresh tensor
        out = out.clone()
    return out, popcount_words(out).sum(dim=-1, dtype=torch.int64)


def plan_rows(
    leaves: Sequence[torch.Tensor],
    shifts: Sequence[Optional[Tuple[int, Sequence[int]]]],
    prog: Sequence[int],
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The result words of one plan root and their per-row popcounts: the
    postfix program `prog` (plan_count's) over the [rows, W] leaf stacks,
    where leaf i enters shifted when shifts[i] is (n, prev): stack row r
    shifted up by n bits, the top n bits of row prev[r] carried in below
    (none where prev[r] < 0). Returns a fresh int32[rows, W] and int64[rows]
    on the leaves' device; the program has at least one leaf."""
    if not leaves:
        raise ValueError("plan_rows needs at least one leaf (it fixes the shape)")
    if len(shifts) != len(leaves):
        raise ValueError(f"plan_rows: {len(shifts)} shifts for {len(leaves)} leaves")
    check_program(len(leaves), prog)
    shape = tuple(leaves[0].shape)
    if len(shape) != 2:
        raise ValueError(f"plan_rows: leaf shape {shape}")
    rows, w = shape
    for t in leaves:
        _words(t, "plan_rows leaf")
        if tuple(t.shape) != shape:
            raise ValueError(f"plan_rows: leaf shape {tuple(t.shape)} vs {shape}")
    for sh in shifts:
        if sh is not None:
            check_shift(sh[0], w)
            if len(sh[1]) != rows or (len(sh[1]) and not -1 <= min(sh[1]) <= max(sh[1]) < rows):
                raise ValueError(f"plan_rows: predecessor table of {len(sh[1])} entries for {rows} rows")
    if _route(*leaves) == "cpu":
        return plan_rows_plain(leaves, shifts, prog)
    dev = leaves[0].device
    out = torch.empty(shape, dtype=torch.int32, device=dev)
    codes, pushes, slots = plan_micro_program(prog)
    if rows == 0 or w == 0 or not pushes:  # nothing to read: all zero
        return out.zero_(), torch.zeros(rows, dtype=torch.int64, device=dev)
    ptrs = [leaves[i].data_ptr() for i in pushes]
    ns, offs, tabs, tab_of = [], [], [], {}
    for i in pushes:
        sh = shifts[i]
        if sh is None or sh[0] == 0:
            ns.append(0)
            offs.append(-1)
            continue
        if i not in tab_of:
            tab_of[i] = rows * len(tabs)
            tabs.append(np.asarray(sh[1], np.int64))
        ns.append(sh[0])
        offs.append(tab_of[i])
    # the table: zeros for the counts, per push its pointer, shift and
    # predecessor offset, the codes, the predecessor tables
    table, rc = _STAGING.launch(
        dev,
        (np.zeros(rows, np.int64), ptrs, ns, offs, codes, *tabs),
        lambda host, nbytes, tab, stream: library().pt_plan_rows(
            host, nbytes, tab, rows, len(pushes), len(codes), slots, w, out.data_ptr(), stream
        ),
    )
    _launched("plan_rows", rc)
    return out, table[:rows]


# ---------------------------------------------------------------------------
# gather_tally  (ops/bitmap.py gather_tally_sorted)
# ---------------------------------------------------------------------------

# the most entries or segments one launch takes: int32 positions, with
# room for the kernel's segment search to probe past the last (mirrors
# pt_gather_tally)
_GATHER_MAX_COUNT = 2**31 - 1 - 256


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
    """Segment sums of popcount(src.flat[idx[k]] & mask[k]) over sorted,
    disjoint half-open [starts[g], ends[g]) entry ranges (starts[g] <=
    ends[g] <= starts[g + 1]; empty segments and entries in no segment are
    allowed) -> int32[n_seg], the bits of the reference's uint32 sums. The
    caller bounds the entry count by 2^27, so sums are exact. Every idx
    lies in [0, src.numel())."""
    for t, what in ((src, "src"), (idx, "idx"), (mask, "mask"), (starts, "starts"), (ends, "ends")):
        _words(t, f"gather_tally {what}")
    if idx.shape != mask.shape or starts.shape != ends.shape:
        raise ValueError("gather_tally: idx/mask or starts/ends shapes differ")
    if _route(src, idx, mask, starts, ends) == "cpu":
        return gather_tally_plain(src, idx, mask, starts, ends)
    n_ent, n_seg = idx.numel(), starts.numel()
    if max(n_ent, n_seg) > _GATHER_MAX_COUNT:
        raise ValueError(f"gather_tally: {n_ent} entries or {n_seg} segments over {_GATHER_MAX_COUNT}")
    out = torch.empty(n_seg, dtype=torch.int32, device=src.device)
    rc = library().pt_gather_tally(
        src.data_ptr(),
        src.numel(),
        idx.data_ptr(),
        mask.data_ptr(),
        n_ent,
        starts.data_ptr(),
        ends.data_ptr(),
        n_seg,
        out.data_ptr(),
        _stream(src),
    )
    _launched("gather_tally", rc)
    return out


# ---------------------------------------------------------------------------
# counts_cross / gather_and  (exec/groupby.py _counts_cross and the row
# selections, XLA programs). Stacks are int32[n, S, W].
# ---------------------------------------------------------------------------

counts_cross_plain = ob.counts_cross


def _stack3(t: torch.Tensor, what: str) -> None:
    _words(t, what)
    if t.dim() != 3:
        raise ValueError(f"{what}: want [n, S, W], got {tuple(t.shape)}")


def counts_cross(acc: torch.Tensor, planes: torch.Tensor) -> torch.Tensor:
    """Per-shard counts of popcount(acc[g, s] & planes[r, s]) for every
    prefix g of acc[G, S, W] and row r of planes[R, S, W]: int32[G, R, S]
    (a shard holds at most 2^20 bits, so no count wraps). One prefix (a
    filter stack) runs on rows_counts, the [R, S, W] stack viewed as R*S
    rows of which row r*S + s meets acc row s; more run on counts_cross."""
    _stack3(acc, "counts_cross acc")
    _stack3(planes, "counts_cross planes")
    if acc.shape[1:] != planes.shape[1:]:
        raise ValueError(f"counts_cross: acc {tuple(acc.shape)} vs planes {tuple(planes.shape)}")
    if acc.shape[0] == 1:
        r, s, w = planes.shape
        return rows_counts(planes.reshape(r * s, w), acc[0]).reshape(1, r, s)
    if _route(acc, planes) == "cpu":
        return counts_cross_plain(acc, planes)
    g, s, w = acc.shape
    r = planes.shape[0]
    out = torch.empty((g, r, s), dtype=torch.int32, device=acc.device)
    if out.numel() == 0 or w == 0:  # nothing to count: nothing to launch
        return out.zero_()
    rc = library().pt_counts_cross(
        acc.data_ptr(),
        g,
        planes.data_ptr(),
        r,
        s,
        w,
        int(w % 4 == 0 and _aligned(acc, planes)),
        out.data_ptr(),
        _stream(acc),
    )
    _launched("counts_cross", rc)
    return out


def _host_index(idx, n: int, what: str) -> np.ndarray:
    idx = np.asarray(idx, dtype=np.int64).reshape(-1)
    if len(idx) and (idx.min() < 0 or idx.max() >= n):
        raise IndexError(f"gather_and: {what} index outside [0, {n})")
    return idx


def gather_and_plain(a, ia, b, ib) -> torch.Tensor:
    return ob.gather_and(a, torch.as_tensor(ia), b, torch.as_tensor(ib))


def gather_and(a: torch.Tensor, ia, b: torch.Tensor, ib) -> torch.Tensor:
    """out[i] = a[ia[i]] & b[ib[i]]: int32[n, S, W] from a[A, S, W] and
    b[B, S, W] and host index sequences ia, ib of one length n. A filter
    broadcast is b = filter[None] with ib all zero."""
    _stack3(a, "gather_and a")
    _stack3(b, "gather_and b")
    if a.shape[1:] != b.shape[1:]:
        raise ValueError(f"gather_and: a {tuple(a.shape)} vs b {tuple(b.shape)}")
    ia = _host_index(ia, a.shape[0], "a")
    ib = _host_index(ib, b.shape[0], "b")
    if len(ia) != len(ib):
        raise ValueError(f"gather_and: {len(ia)} a indices vs {len(ib)} b indices")
    if _route(a, b) == "cpu":
        return gather_and_plain(a, torch.from_numpy(ia), b, torch.from_numpy(ib))
    n = len(ia)
    _, s, w = a.shape
    out = torch.empty((n, s, w), dtype=torch.int32, device=a.device)
    if n == 0 or s * w == 0:  # nothing to write: nothing to launch
        return out
    # both index vectors in one upload
    idx = torch.from_numpy(np.concatenate([ia, ib]).astype(np.int32)).to(a.device, non_blocking=False)
    rc = library().pt_gather_and(
        a.data_ptr(),
        idx.data_ptr(),
        b.data_ptr(),
        idx.data_ptr() + 4 * n,
        n,
        s * w,
        int((s * w) % 4 == 0 and _aligned(a, b, out)),
        out.data_ptr(),
        _stream(a),
    )
    _launched("gather_and", rc)
    return out


# ---------------------------------------------------------------------------
# BSI kernels: bsi_sum (Pallas sum_counts), bsi_min_max, bsi_range and the
# slab steps bsi_min_max_step and bsi_range_step (ops/bsi.py XLA programs).
# planes int32[D, S, W], row operands int32[S, W].
# ---------------------------------------------------------------------------


def _bsi_check(name: str, planes: torch.Tensor, rows) -> List[torch.Tensor]:
    """Validate a plane stack and its [S, W] row operands (None skipped);
    returns the tensors for routing."""
    _words(planes, f"{name} planes")
    if planes.dim() != 3:
        raise ValueError(f"{name}: want planes [D, S, W], got {tuple(planes.shape)}")
    d = planes.shape[0]
    if not 1 <= d <= obsi.MAX_DEPTH:
        raise ValueError(f"{name}: depth {d} outside [1, {obsi.MAX_DEPTH}]")
    ts = [planes]
    for what, t in rows:
        if t is None:
            continue
        _words(t, f"{name} {what}")
        if tuple(t.shape) != tuple(planes.shape[1:]):
            raise ValueError(f"{name}: {what} shape {tuple(t.shape)} vs planes {tuple(planes.shape)}")
        ts.append(t)
    return ts


def _grid_stride(n: int, vec: bool) -> int:
    items = n // 4 if vec else n
    cap = max(_MAX_GRID, -(-items // (_THREADS * _MAX_ITEMS_PER_THREAD)))
    return max(1, min(cap, -(-items // _THREADS)))


def bsi_sum_plain(planes, exists, sign=None, filt=None) -> torch.Tensor:
    return obsi.sum_counts_stacked(planes, exists, sign, filt).sum(dim=1)


def bsi_sum(
    planes: torch.Tensor,
    exists: torch.Tensor,
    sign: Optional[torch.Tensor] = None,
    filt: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The BSI sum tally over the whole stack: int64[1 + 2D] = [count of
    consider = exists & filt, pos[d] = pc(plane_d & consider & ~sign),
    neg[d] = pc(plane_d & consider & sign)]. sign None is an unsigned
    field (the negative counts are zero); filt None considers every
    column that holds a value."""
    ts = _bsi_check("bsi_sum", planes, (("exists", exists), ("sign", sign), ("filter", filt)))
    if _route(*ts) == "cpu":
        return bsi_sum_plain(planes, exists, sign, filt)
    d = planes.shape[0]
    n = exists.numel()
    out = torch.zeros(1 + 2 * d, dtype=torch.int64, device=planes.device)
    vec = n % 4 == 0 and _aligned(*ts)
    rc = library().pt_bsi_sum(
        planes.data_ptr(),
        exists.data_ptr(),
        0 if sign is None else sign.data_ptr(),
        0 if filt is None else filt.data_ptr(),
        d,
        n,
        int(vec),
        _grid_stride(n, vec),
        out.data_ptr(),
        _stream(planes),
    )
    _launched("bsi_sum", rc)
    return out


def bsi_min_max_plain(planes, exists, sign=None, filt=None, is_min: bool = True) -> torch.Tensor:
    return obsi.min_max_stream(planes, exists, sign, filt, is_min)


def _min_max_launch(name, planes, exists, sign, filt, state, is_min, first, last, key_bits):
    """One bsi_min_max_kernel launch over a slab (ops.bsi.min_max_step's
    contract); counted under `name`."""
    d = planes.shape[0]
    n = exists.numel()
    dev = planes.device
    wide = obsi.min_max_wide(key_bits)
    if first:
        fa = va = None
        if not last:
            fa = torch.empty_like(exists)
            va = torch.empty(exists.shape, dtype=torch.int64 if wide else torch.int32, device=dev)
    else:
        fa, va = state
    ts = [t for t in (planes, exists, sign, filt, fa, va) if t is not None]
    vec = n % 4 == 0 and _aligned(*ts)
    grid = _grid_stride(n, vec)
    partials = ticket = out = None
    if last:
        partials = torch.empty(2 * grid, dtype=torch.int64, device=dev)
        ticket = torch.zeros(1, dtype=torch.int32, device=dev)
        out = torch.empty(3, dtype=torch.int64, device=dev)
    ptr = lambda t: 0 if t is None else t.data_ptr()  # noqa: E731
    rc = library().pt_bsi_min_max(
        planes.data_ptr(),
        exists.data_ptr(),
        ptr(sign),
        ptr(filt),
        d,
        n,
        int(vec),
        int(is_min),
        int(first),
        int(last),
        ptr(fa),
        ptr(va),
        int(wide),
        grid,
        ptr(partials),
        ptr(ticket),
        ptr(out),
        _stream(planes),
    )
    _launched(name, rc)
    return out if last else (fa, va)


def bsi_min_max(
    planes: torch.Tensor,
    exists: torch.Tensor,
    sign: Optional[torch.Tensor],
    filt: Optional[torch.Tensor],
    is_min: bool,
) -> torch.Tensor:
    """Min or Max over the considered columns as the virtual-key ladder:
    int64[3] = [best key, any, count of columns at that key], decoded by
    ops.bsi.decode_min_max. The cross-word reduce finishes in the kernel
    (the last block to finish reduces every block's partial). This is
    bsi_min_max_step over the whole stack (first and last), counted on its
    own."""
    ts = _bsi_check("bsi_min_max", planes, (("exists", exists), ("sign", sign), ("filter", filt)))
    if _route(*ts) == "cpu":
        return bsi_min_max_plain(planes, exists, sign, filt, is_min)
    key_bits = planes.shape[0] + (sign is not None)
    return _min_max_launch("bsi_min_max", planes, exists, sign, filt, None, is_min, True, True, key_bits)


def bsi_min_max_step_plain(planes, exists, sign, filt, state, is_min, first, last, key_bits):
    return obsi.min_max_step(planes, exists, sign, filt, state, is_min, first, last, key_bits)


def bsi_min_max_step(
    planes: torch.Tensor,
    exists: torch.Tensor,
    sign: Optional[torch.Tensor],
    filt: Optional[torch.Tensor],
    state,
    is_min: bool,
    first: bool,
    last: bool,
    key_bits: int,
):
    """One slab of Min/Max (ops.bsi.min_max_step): slabs arrive MSB first;
    `state` is None on the first, else the (fa, va) pair the previous slab
    returned, which the kernel updates in place and returns. With `last`
    the result is int64[3] = [best key, any, count], as bsi_min_max gives
    it: the reference's separate finish program is this launch's last
    block. `key_bits` is the whole field's key width (depth, plus one when
    signed): over 32 bits va is int64 from the first slab on."""
    ts = _bsi_check("bsi_min_max_step", planes, (("exists", exists), ("sign", sign), ("filter", filt)))
    if not 1 <= key_bits <= obsi.MAX_DEPTH + 1:
        raise ValueError(f"bsi_min_max_step: key_bits {key_bits} outside [1, {obsi.MAX_DEPTH + 1}]")
    if not first:
        if state is None or len(state) != 2:
            raise ValueError("bsi_min_max_step: a later slab needs the (fa, va) state")
        fa, va = state
        want = torch.int64 if obsi.min_max_wide(key_bits) else torch.int32
        for what, t, dtype in (("fa", fa, torch.int32), ("va", va, want)):
            if t.dtype != dtype or tuple(t.shape) != tuple(exists.shape) or not t.is_contiguous():
                raise ValueError(f"bsi_min_max_step: {what} must be contiguous {dtype} {tuple(exists.shape)}")
            ts.append(t)
    if _route(*ts) == "cpu":
        return bsi_min_max_step_plain(planes, exists, sign, filt, state, is_min, first, last, key_bits)
    return _min_max_launch("bsi_min_max_step", planes, exists, sign, filt, state, is_min, first, last, key_bits)


def _range_args(sel: str, kind: str, mode: str, p0: int, p1: int, sign) -> None:
    if sel not in RANGE_SELS:
        raise ValueError(f"bsi_range: unknown sel {sel!r}")
    if kind not in RANGE_KINDS:
        raise ValueError(f"bsi_range: unknown kind {kind!r}")
    if mode not in RANGE_MODES:
        raise ValueError(f"bsi_range: unknown mode {mode!r}")
    if sel != "consider" and sign is None:
        raise ValueError(f"bsi_range: sel {sel!r} needs the sign row")
    for p in (p0, p1):
        if not 0 <= p <= MASK32:
            raise ValueError(f"bsi_range: predicate {p} is not a uint32 magnitude")


def bsi_range_plain(planes, base, sign, sel, kind, allow_eq, p0, p1, mode) -> torch.Tensor:
    _range_args(sel, kind, mode, p0, p1, sign)
    return obsi.range_single(planes, base, sign, sel, kind, allow_eq, p0, p1, mode)


def bsi_range(
    planes: torch.Tensor,
    base: torch.Tensor,
    sign: Optional[torch.Tensor],
    sel: str,
    kind: str,
    allow_eq: bool,
    p0: int,
    p1: int = 0,
    mode: str = "rows",
) -> torch.Tensor:
    """One BSI predicate ladder over magnitudes. The starting mask is
    `base` (sel "consider"), base & ~sign ("pos") or base & sign ("neg");
    kind is eq (== p0), lt / gt (< / > p0, or <= / >= with allow_eq) or
    between (p0 <= magnitude <= p1). Predicates are uint32 magnitudes.
    mode "rows" returns the int32[S, W] result words, "count" its int64[S]
    per-shard popcounts."""
    _range_args(sel, kind, mode, p0, p1, sign)
    ts = _bsi_check("bsi_range", planes, (("base", base), ("sign", sign)))
    if _route(*ts) == "cpu":
        return bsi_range_plain(planes, base, sign, sel, kind, allow_eq, p0, p1, mode)
    d, s, w = planes.shape
    dev = planes.device
    count = mode == "count"
    if count:
        out = torch.zeros(s, dtype=torch.int64, device=dev)
    else:
        out = torch.empty((s, w), dtype=torch.int32, device=dev)
    vec = w % 4 == 0 and _aligned(*ts, out)
    rc = library().pt_bsi_range(
        planes.data_ptr(),
        base.data_ptr(),
        0 if sign is None else sign.data_ptr(),
        d,
        s,
        w,
        RANGE_SELS[sel],
        RANGE_KINDS[kind],
        int(bool(allow_eq)),
        p0,
        p1,
        int(count),
        int(vec),
        out.data_ptr(),
        _stream(planes),
    )
    _launched("bsi_range", rc)
    return out


def _range_step_desc(planes, sign, jobs, preds, lo: int, first: bool, extras) -> List[int]:
    """Validate a range step's jobs and return the kernel's descriptor:
    n_jobs, n_extras, per job (kind, sel, allow_eq, lz, first state row,
    p0, p1), then the extras' selectors."""
    d = planes.shape[0]
    if not 1 <= len(jobs) <= 2 or len(extras) > 3:
        raise ValueError(f"bsi_range_step: want 1-2 jobs and at most 3 extras, got {len(jobs)} and {len(extras)}")
    if lo < 0 or lo + d > obsi.MAX_DEPTH:
        raise ValueError(f"bsi_range_step: planes [{lo}, {lo + d}) outside [0, {obsi.MAX_DEPTH})")
    if len(preds) != sum(obsi.range_npreds(kind) for kind, _, _ in jobs):
        raise ValueError(f"bsi_range_step: {len(preds)} predicates for jobs {jobs}")
    desc = [len(jobs), len(extras)]
    row = off = 0
    for kind, sel, allow_eq in jobs:
        p = list(preds[off : off + obsi.range_npreds(kind)]) + [0]
        _range_args(sel, kind, "count", p[0], p[1], sign)
        if first and any(x >> (lo + d) for x in p):
            raise ValueError(f"bsi_range_step: predicate {p[:-1]} has bits above the top slab's planes")
        lz = obsi.lt_leading_zeros(p[0], lo + d)
        desc += [RANGE_KINDS[kind], RANGE_SELS[sel], int(bool(allow_eq)), int(lz), row, p[0], p[1]]
        row += obsi.RANGE_STATE_ROWS[kind]
        off += obsi.range_npreds(kind)
    for sel in extras:
        _range_args(sel, "eq", "count", 0, 0, sign)
        desc.append(RANGE_SELS[sel])
    return desc


def bsi_range_step_plain(planes, exists, sign, state, jobs, preds, lo, first, last, extras=()):
    return obsi.range_step(planes, exists, sign, state, jobs, preds, lo, first, last, extras)


def bsi_range_step(
    planes: torch.Tensor,
    exists: torch.Tensor,
    sign: Optional[torch.Tensor],
    state: Optional[torch.Tensor],
    jobs,
    preds,
    lo: int,
    first: bool,
    last: bool,
    extras=(),
):
    """Every job of a condition's decomposition over one slab
    (ops.bsi.range_step): slabs arrive MSB first, planes[0] is absolute
    plane `lo`; the state int32[rows, S, W] is allocated on the first
    slab and updated in place on the others. With `last` the result is
    int64[len(jobs) + len(extras)]: each job's count, then each extra
    mask's. One launch reads each plane word once for every job."""
    ts = _bsi_check("bsi_range_step", planes, (("exists", exists), ("sign", sign)))
    desc = _range_step_desc(planes, sign, jobs, preds, lo, first, extras)
    rows = obsi.range_state_rows(jobs)
    if not first:
        shape = (rows, *exists.shape)
        if state is None or state.dtype != torch.int32 or tuple(state.shape) != shape or not state.is_contiguous():
            raise ValueError(f"bsi_range_step: a later slab needs its contiguous int32 {shape} state")
        ts.append(state)
    if _route(*ts) == "cpu":
        return bsi_range_step_plain(planes, exists, sign, state, jobs, preds, lo, first, last, extras)
    n = exists.numel()
    dev = planes.device
    if first and not last:
        state = torch.empty((rows, *exists.shape), dtype=torch.int32, device=dev)
    out = torch.zeros(len(jobs) + len(extras), dtype=torch.int64, device=dev) if last else None
    vec = n % 4 == 0 and _aligned(*ts, *([] if state is None else [state]))
    host = np.asarray(desc, dtype=np.int64)
    rc = library().pt_bsi_range_step(
        planes.data_ptr(),
        exists.data_ptr(),
        0 if sign is None else sign.data_ptr(),
        0 if state is None else state.data_ptr(),
        host.ctypes.data,
        planes.shape[0],
        lo,
        int(first),
        int(last),
        n,
        int(vec),
        _grid_stride(n, vec),
        0 if out is None else out.data_ptr(),
        _stream(planes),
    )
    _launched("bsi_range_step", rc)
    return out if last else state

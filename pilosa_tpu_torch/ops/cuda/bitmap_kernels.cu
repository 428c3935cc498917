// Hand-written Hopper (sm_90a) kernels for the port's query path.
//
// Words are 32-bit little-endian bitmap words (bit b of word w = in-shard
// column 32w + b). PyTorch holds them as int32; the kernels read them as
// uint32. Every kernel here but gather_and and plan_rows is a popcount
// reduction that reads each input word once (gather_tally: each word idx
// points at; counts_cross: each plane word once per 16 prefixes, on the
// tensor cores), gather_and is one AND per distinct slab word read, and
// plan_rows a few bitwise operations and one popcount per word read and
// written, so all seven are bound by device-memory bytes, not operations:
// loads are 128-bit (uint4) where the pointers and the row width allow it,
// popcount is one __popc per word, and partial sums stay in registers and
// shared memory (nothing intermediate is written to device memory).
//
// Kernels and what they replace:
//   count2_kernel      pilosa_tpu/ops/pallas_kernels.py _count2 / popcount
//   rows_counts_kernel pilosa_tpu/ops/pallas_kernels.py _rows_counts
//   plan_count_kernel  pilosa_tpu/exec/plan.py _eval_jit/_eval_multi_jit +
//                      _root_out ("count" mode), an XLA program
//   plan_count_multi_kernel pilosa_tpu/exec/plan.py _eval_multi_jit +
//                      _root_out ("count" mode): N roots, one launch
//   plan_rows_kernel   pilosa_tpu/exec/plan.py _eval_jit ("row" mode) with
//                      pilosa_tpu/ops/bitmap.py shift_bits, an XLA program
//   gather_tally_kernel pilosa_tpu/ops/bitmap.py gather_tally_sorted, an
//                      XLA program (bound by the 32-byte sectors it gathers)
//   counts_cross_kernel pilosa_tpu/exec/groupby.py _counts_cross, an XLA
//                      program (GroupBy's per-shard cross tally)
//   gather_and_kernel  pilosa_tpu/exec/groupby.py _select_rows_filtered,
//                      _select_pairs and _cross_expand, XLA programs
//
// Each C entry point launches on the caller's stream, does not synchronise,
// allocates nothing, and returns cudaGetLastError() as an int. count2,
// plan_count and plan_rows take a table the wrapper staged in pinned host memory: the
// entry point copies it (one asynchronous copy on the same stream) into a
// device buffer whose head is the kernel's output, so the same copy zeroes
// the output and no memset or pageable copy precedes the launch.

#include <cuda_runtime.h>
#include <stdint.h>

#include <utility>

#define PT_EXPORT extern "C" __attribute__((visibility("default")))

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

enum Op : int { OP_NONE = 0, OP_AND = 1, OP_OR = 2, OP_XOR = 3, OP_ANDNOT = 4 };

template <int OP>
__device__ __forceinline__ uint32_t apply(uint32_t a, uint32_t b) {
  if constexpr (OP == OP_AND) return a & b;
  if constexpr (OP == OP_OR) return a | b;
  if constexpr (OP == OP_XOR) return a ^ b;
  if constexpr (OP == OP_ANDNOT) return a & ~b;
  return a;
}

template <int OP>
__device__ __forceinline__ uint4 apply4(uint4 a, uint4 b) {
  return make_uint4(apply<OP>(a.x, b.x), apply<OP>(a.y, b.y), apply<OP>(a.z, b.z),
                    apply<OP>(a.w, b.w));
}

__device__ __forceinline__ uint32_t popc4(uint4 v) {
  return __popc(v.x) + __popc(v.y) + __popc(v.z) + __popc(v.w);
}

__device__ __forceinline__ uint32_t warp_sum(uint32_t v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

// Sum over a kThreads block; the result is valid in thread 0 only.
__device__ __forceinline__ uint32_t block_sum(uint32_t v, uint32_t* partial) {
  v = warp_sum(v);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) partial[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < kWarps ? partial[lane] : 0u;
    v = warp_sum(v);
  }
  return v;
}

// 64-bit sum over a kThreads block (valid in thread 0), callable any number
// of times per launch: it syncs again before `partial` can be rewritten.
__device__ __forceinline__ unsigned long long block_sum64(unsigned long long v,
                                                          unsigned long long* partial) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) partial[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < kWarps ? partial[lane] : 0ull;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  }
  __syncthreads();
  return v;
}

// Add the block's per-thread counts into *out with one 64-bit atomic.
__device__ __forceinline__ void flush_count(unsigned long long* out, uint32_t acc,
                                            unsigned long long* partial) {
  const unsigned long long total = block_sum64(acc, partial);
  if (threadIdx.x == 0 && total != 0ull) atomicAdd(out, total);
}

// The contiguous run [lo, hi) of work items this block owns: a grid sized
// to the resident blocks walks every item in one wave, and each block meets
// only the few segments or shards its run crosses.
__device__ __forceinline__ void block_items(int64_t n_items, int64_t* lo, int64_t* hi) {
  *lo = n_items * blockIdx.x / gridDim.x;
  *hi = n_items * (blockIdx.x + 1) / gridDim.x;
}

// ---------------------------------------------------------------------------
// count2: popcount(a_g op b_g) for a list of segments in one launch.
// ---------------------------------------------------------------------------

// uint4 loads a thread issues per operand and tile before its first popcount
constexpr int kVecLoads = 4;
constexpr int64_t kTileWords = (int64_t)kThreads * kVecLoads * 4;  // 4096

// meta: a[n_seg] and b[n_seg] word pointers (b unused for OP_NONE),
// len[n_seg] in words, first[n_seg + 1] the first tile item of each segment
// (first[n_seg] = n_items; an empty segment owns no item). out[g] is exact:
// each block adds its count of segment g once, as a 64-bit atomic. A
// segment whose pointers are 16-byte aligned is read as uint4 with a scalar
// tail for len % 4 words; any other is read word by word.
template <int OP>
__global__ void __launch_bounds__(kThreads)
count2_kernel(const int64_t* __restrict__ meta, int64_t n_seg, int64_t n_items,
              unsigned long long* __restrict__ out) {
  __shared__ unsigned long long partial[kWarps];
  const int64_t* a_of = meta;
  const int64_t* b_of = meta + n_seg;
  const int64_t* len_of = meta + 2 * n_seg;
  const int64_t* first = meta + 3 * n_seg;
  int64_t lo, hi;
  block_items(n_items, &lo, &hi);
  if (lo >= hi) return;
  // the segment holding item lo: first[g0] <= lo < first[g0 + 1]. Guess it
  // as if segments were equal (exact for a Row's equal-width segments),
  // widen a bracket around the guess exponentially, then bisect it: a few
  // dependent loads instead of log2(n_seg) before the first data load.
  int64_t g0 = lo * n_seg / n_items, g1 = g0 + 1;
  for (int64_t step = 1; g0 > 0 && first[g0] > lo; step *= 2) {
    g1 = g0;
    g0 = g0 > step ? g0 - step : 0;
  }
  for (int64_t step = 1; g1 < n_seg && first[g1] <= lo; step *= 2) {
    g0 = g1;
    g1 = g1 + step < n_seg ? g1 + step : n_seg;
  }
  while (g1 - g0 > 1) {
    const int64_t mid = (g0 + g1) / 2;
    if (first[mid] <= lo) g0 = mid; else g1 = mid;
  }
  int64_t g = g0;
  int64_t next = first[g + 1];
  int64_t t = lo - first[g];
  const int tid = threadIdx.x;
  uint32_t acc = 0;
  for (int64_t item = lo; item < hi; ++item) {
    if (item == next) {  // on to the next non-empty segment
      flush_count(out + g, acc, partial);
      acc = 0;
      do {
        ++g;
        next = first[g + 1];
      } while (next == item);
      t = 0;
    }
    const uint32_t* a = reinterpret_cast<const uint32_t*>(a_of[g]);
    const uint32_t* b = reinterpret_cast<const uint32_t*>(b_of[g]);
    const int64_t w0 = t * kTileWords;
    const int64_t rest = len_of[g] - w0;
    const int wn = (int)(rest < kTileWords ? rest : kTileWords);  // words in this tile
    if (((reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b)) & 15u) == 0) {
      const uint4* a4 = reinterpret_cast<const uint4*>(a + w0);
      const uint4* b4 = reinterpret_cast<const uint4*>(b + w0);
      const int q = wn / 4;
      uint4 x[kVecLoads], y[kVecLoads];
#pragma unroll
      for (int k = 0; k < kVecLoads; ++k) {
        const int j = tid + k * kThreads;
        x[k] = j < q ? __ldg(a4 + j) : make_uint4(0u, 0u, 0u, 0u);
        if constexpr (OP != OP_NONE) y[k] = j < q ? __ldg(b4 + j) : make_uint4(0u, 0u, 0u, 0u);
      }
#pragma unroll
      for (int k = 0; k < kVecLoads; ++k) {
        if constexpr (OP != OP_NONE) x[k] = apply4<OP>(x[k], y[k]);
        acc += popc4(x[k]);
      }
      const int tail = 4 * q + tid;  // the len % 4 words of a segment's last tile
      if (tail < wn) {
        uint32_t v = __ldg(a + w0 + tail);
        if constexpr (OP != OP_NONE) v = apply<OP>(v, __ldg(b + w0 + tail));
        acc += __popc(v);
      }
    } else {
      constexpr int kWordLoads = kTileWords / kThreads;
      uint32_t x[kWordLoads];
#pragma unroll
      for (int k = 0; k < kWordLoads; ++k) {
        const int j = tid + k * kThreads;
        x[k] = j < wn ? __ldg(a + w0 + j) : 0u;
        if constexpr (OP != OP_NONE) {
          if (j < wn) x[k] = apply<OP>(x[k], __ldg(b + w0 + j));
        }
      }
#pragma unroll
      for (int k = 0; k < kWordLoads; ++k) acc += __popc(x[k]);
    }
    ++t;
  }
  flush_count(out + g, acc, partial);
}

// One block per row r of stack[R, W]: out[r] = popcount(row & filt[r % F])
// (F = 0: no filter; F = 1: one broadcast filter row; F = S: a per-shard
// filter stack, row r of an [R/S, S, W] plane stack meeting shard r % S).
__global__ void __launch_bounds__(kThreads)
rows_counts_kernel(const uint32_t* __restrict__ stack, int64_t W,
                   const uint32_t* __restrict__ filt, int64_t F, int vec,
                   int32_t* __restrict__ out) {
  __shared__ uint32_t partial[kWarps];
  const int64_t r = blockIdx.x;
  const uint32_t* row = stack + r * W;
  const uint32_t* f = F == 0 ? nullptr : filt + (F == 1 ? 0 : r % F) * W;
  const int64_t w4 = vec ? W / 4 : 0;
  uint32_t acc = 0;
  const uint4* row4 = reinterpret_cast<const uint4*>(row);
  const uint4* f4 = reinterpret_cast<const uint4*>(f);
  for (int64_t i = threadIdx.x; i < w4; i += blockDim.x) {
    uint4 x = row4[i];
    if (f != nullptr) {
      const uint4 y = f4[i];
      x.x &= y.x;
      x.y &= y.y;
      x.z &= y.z;
      x.w &= y.w;
    }
    acc += popc4(x);
  }
  for (int64_t i = w4 * 4 + threadIdx.x; i < W; i += blockDim.x) {
    uint32_t x = row[i];
    if (f != nullptr) x &= f[i];
    acc += __popc(x);
  }
  acc = block_sum(acc, partial);
  if (threadIdx.x == 0) out[r] = (int32_t)acc;
}

// ---------------------------------------------------------------------------
// plan_count: a set-algebra tree over [S, W] leaf stacks, evaluated word by
// word from a postfix program, then popcount, then per-shard counts.
// ---------------------------------------------------------------------------

// Operand stack entries a postfix program may need. The compiler orders
// each n-ary node's children deepest first, so a program needs at most
// floor(log2(leaf occurrences)) + 1 entries; 32 covers any program under
// 2^31 instructions.
constexpr int kMaxStack = 32;
// leaf tiles in a block's shared-memory ring, of which kRing - 1 are being
// filled while the program consumes the oldest
constexpr int kRing = 4;
// the micro program and push pointers go to shared memory up to this size;
// a larger table is read from device memory (L1-cached broadcasts)
constexpr int kMetaSmemBytes = 16384;
// stack entries up to which a launch takes two uint4 per thread and push
// (VEC 2); a deeper program takes one, so its stack fits shared memory
constexpr int kWideStackSlots = 8;
// the most dynamic shared memory a launch asks for (VEC 1 at full depth)
constexpr int kMaxDynSmem =
    (kRing + kMaxStack - 1) * kThreads * (int)sizeof(uint4) + kMetaSmemBytes;

// Micro program (built on the host from the postfix program): code =
// kind * 8 + op. A push that an operator follows is folded into that
// operator, so only pushes that stay on the stack spill to it.
enum MicroKind : int {
  M_PUSH = 0,      // push the next staged leaf tile
  M_ZERO = 1,      // push zeros
  M_LEAF_OP = 2,   // top = op(top, next staged leaf tile)
  M_ZERO_OP = 3,   // top = op(top, zeros)
  M_STACK_OP = 4,  // top = op(popped entry, top)
};
// ops: 0 and, 1 or, 2 xor, 3 andnot (a & ~b), 4 rev_andnot (b & ~a), for
// op(a, b) with a the older operand

__device__ __forceinline__ uint4 binop(int op, uint4 a, uint4 b) {
  switch (op) {
    case 0:
      return make_uint4(a.x & b.x, a.y & b.y, a.z & b.z, a.w & b.w);
    case 1:
      return make_uint4(a.x | b.x, a.y | b.y, a.z | b.z, a.w | b.w);
    case 2:
      return make_uint4(a.x ^ b.x, a.y ^ b.y, a.z ^ b.z, a.w ^ b.w);
    case 3:
      return make_uint4(a.x & ~b.x, a.y & ~b.y, a.z & ~b.z, a.w & ~b.w);
    default:
      return make_uint4(b.x & ~a.x, b.y & ~a.y, b.z & ~a.z, b.w & ~a.w);
  }
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// Spin until the barrier's phase `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT_%=:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT_%=;\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// TMA 1-D bulk copy of `bytes` (a multiple of 16) from device memory into
// shared memory, completing on `bar`.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
          smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// Work items are (shard, tile) pairs, a tile being kThreads * VEC uint4 of
// a row, and a thread evaluates the program on its VEC uint4 of a tile;
// each block walks its contiguous run of items (block_items). Every leaf
// push, across items, is one TMA bulk copy of the leaf's tile into a
// shared-memory ring of kRing slots, issued by thread 0 kRing - 1 pushes
// ahead of the push that consumes it, so each block keeps kRing - 1 tiles
// of 8 KiB in flight with one instruction each. A slot's `full` barrier
// completes when its bytes land; its `empty` barrier when every warp has
// read it, and only then is it refilled. The top of the operand stack lives
// in registers and the entries below it in shared memory (VEC uint4 per
// thread and entry); with pushes folded into their operators, a wide union
// or a two-leaf intersection touches no stack. meta: the leaf pointer of
// each push in program order [n_push], then the micro program [n_code]; it
// is read once per block into shared memory when it fits. Each block adds
// its count of a shard into out[shard] once.
template <int VEC>
__global__ void __launch_bounds__(kThreads)
plan_count_kernel(const int64_t* __restrict__ meta, int32_t n_push, int32_t n_code,
                  int32_t stack_slots, int32_t meta_in_smem, int64_t w4, int64_t tiles,
                  int64_t n_items, unsigned long long* __restrict__ out) {
  constexpr int kTile = kThreads * VEC;
  extern __shared__ uint4 smem[];
  __shared__ unsigned long long partial[kWarps];
  __shared__ uint64_t full[kRing], empty[kRing];
  int64_t lo, hi;
  block_items(n_items, &lo, &hi);
  if (lo >= hi || n_push == 0) return;  // PUSH_ZERO alone: the table copy zeroed out
  const int tid = threadIdx.x;
  uint4* ring = smem;                            // [kRing][VEC * kThreads]
  uint4* stack = smem + kRing * VEC * kThreads;  // [stack_slots][VEC][kThreads]
  const int64_t* m = meta;
  if (meta_in_smem) {
    int64_t* sm = reinterpret_cast<int64_t*>(stack + (int64_t)stack_slots * VEC * kThreads);
    for (int i = tid; i < n_push + n_code; i += kThreads) sm[i] = meta[i];
    m = sm;
  }
  if (tid == 0) {
    for (int j = 0; j < kRing; ++j) {
      mbar_init(&full[j], 1);
      mbar_init(&empty[j], kWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int64_t* push_ptr = m;
  const int64_t* code = m + n_push;

  // thread 0's copy cursor: push q of the run, its item's row offset and
  // first column (uint4), and how many of that item's pushes are left
  const int64_t n_total = (hi - lo) * n_push;
  int64_t q = 0, q_row = 0, q_col = 0;
  int q_push = 0;
  uint32_t q_bytes = 0;
  auto set_item = [&](int64_t item) {
    const int64_t s = item / tiles;
    q_row = s * w4;
    q_col = (item - s * tiles) * kTile;
    const int64_t rest = w4 - q_col;
    q_bytes = (uint32_t)((rest < kTile ? rest : kTile) * sizeof(uint4));
  };
  auto issue = [&]() {  // thread 0: copy push q into slot q % kRing
    if (q >= n_total) return;
    const int j = (int)(q % kRing);
    const int64_t use = q / kRing;
    if (use > 0) mbar_wait(&empty[j], (uint32_t)((use - 1) & 1));
    mbar_expect_tx(&full[j], q_bytes);
    const uint4* src = reinterpret_cast<const uint4*>(push_ptr[q_push]) + q_row + q_col;
    bulk_copy(ring + j * kTile, src, q_bytes, &full[j]);
    ++q;
    if (++q_push == n_push) {
      q_push = 0;
      if (q < n_total) set_item(lo + q / n_push);
    }
  };
  if (tid == 0) {
    set_item(lo);
    for (int k = 0; k < kRing - 1; ++k) issue();
  }

  int slot = 0;
  uint32_t phase = 0;
  int64_t s = lo / tiles, t = lo % tiles, cur = s;
  uint32_t acc = 0;
  for (int64_t item = lo; item < hi; ++item) {
    if (s != cur) {
      flush_count(out + cur, acc, partial);
      acc = 0;
      cur = s;
    }
    const int64_t col = t * kTile + tid;  // the thread's first column (uint4)
    uint4 top[VEC];
    int sp = 0;  // entries below top, in stack[0, sp)
    for (int pc = 0; pc < n_code; ++pc) {
      const int c = (int)code[pc];
      const int kind = c >> 3, op = c & 7;
      if (kind == M_STACK_OP) {
        --sp;
#pragma unroll
        for (int k = 0; k < VEC; ++k) {
          top[k] = binop(op, stack[(sp * VEC + k) * kThreads + tid], top[k]);
        }
        continue;
      }
      uint4 v[VEC];
      if (kind == M_PUSH || kind == M_LEAF_OP) {
        mbar_wait(&full[slot], phase);
        const uint4* tile = ring + slot * kTile;
#pragma unroll
        for (int k = 0; k < VEC; ++k) {
          // past the row's end the slot holds stale bytes: read zeros
          v[k] = col + k * kThreads < w4 ? tile[k * kThreads + tid] : make_uint4(0u, 0u, 0u, 0u);
        }
        __syncwarp();
        if ((tid & 31) == 0) mbar_arrive(&empty[slot]);
        if (tid == 0) issue();
        if (++slot == kRing) {
          slot = 0;
          phase ^= 1u;
        }
      } else {
#pragma unroll
        for (int k = 0; k < VEC; ++k) v[k] = make_uint4(0u, 0u, 0u, 0u);
      }
      if (kind >= M_LEAF_OP) {
#pragma unroll
        for (int k = 0; k < VEC; ++k) top[k] = binop(op, top[k], v[k]);
      } else {
        if (pc > 0) {  // every push but the first has a value under it
#pragma unroll
          for (int k = 0; k < VEC; ++k) stack[(sp * VEC + k) * kThreads + tid] = top[k];
          ++sp;
        }
#pragma unroll
        for (int k = 0; k < VEC; ++k) top[k] = v[k];
      }
    }
#pragma unroll
    for (int k = 0; k < VEC; ++k) acc += popc4(top[k]);
    if (++t == tiles) {
      t = 0;
      ++s;
    }
  }
  flush_count(out + cur, acc, partial);
}

// ---------------------------------------------------------------------------
// plan_count_multi: N plan roots over one shared leaf set in one launch,
// per-root per-shard counts.
// ---------------------------------------------------------------------------
//
// Replaces pilosa_tpu/exec/plan.py _eval_multi_jit (with _root_out in
// "count" mode), an XLA program that evaluates several roots with one
// memo, so an operand shared by roots is read from HBM once a dispatch.
//
// Bound: bytes. Each distinct leaf is read once a launch and the [N, S]
// counts written once, over 3.35 TB/s. The roots' programs read the leaf
// tiles from shared memory once a code (a root of k Rows: k reads) and
// popcount each root's words once; the kernel's first design, which ran
// every root on every thread's uint4 and reduced each root across its
// warp every item, spent most of its time in its programs, not its
// copies (PERF.md section 6).
//
// Design. Work items are (shard, tile) pairs, a tile being kMultiThreads
// * VEC uint4 of a row (VEC * 2 KiB). A fifth, producer warp walks the
// block's run of items (block_items) and copies each item's tile of every
// distinct leaf into that leaf's slot of one of `nbuf` ring buffers with
// one TMA bulk copy each, all completing on the buffer's `full` barrier;
// it refills a buffer as soon as its `empty` barrier completes, which
// each of the four consumer warps arrives on once past its reads: no
// block-wide barrier sits in the item loop. The roots are split between
// the consumer warps (the host balances their codes), and a warp runs
// each of its roots over the whole tile, L uint4 a lane at a time (4 * VEC
// / L passes an item), so a code's read, decode and branch serve 32 * L
// uint4 and leave L loads in flight. A flat root (one n-ary node over
// leaves, as the batcher's Counts are) runs a loop with its op hoisted
// out; any other runs plan_count's micro program (32-bit codes, the leaf's
// slot in the high bits, read one ahead) with a per-warp operand stack. A
// lane adds each root's popcount into its own 32-bit counter in shared
// memory: no shuffle, atomic or barrier per item. Bits past a row's end
// are evaluated from stale slot bytes and masked out of the popcount
// (every op is bitwise, so a column's result reads only that column). At
// a shard change and at the end of its run a warp sums each of its roots'
// counters over its lanes (__reduce_add_sync) and adds the sum into
// out[root * shards + shard] with one 64-bit atomic. The programs, not the
// copies, bound the kernel, and they are bound by the loads a warp keeps
// in flight, so the host picks the VEC, nbuf and L that keep the most
// uint4 loads in flight an SM (resident blocks x L): a shallow ring in
// several resident blocks beats a deep ring in one (ops/kernels.py
// plan_count_multi_layout). The host groups the roots so each launch's
// distinct leaves, its deepest stack and its counters fit the shared
// memory at VEC 1, L 1 and one buffer, as the first design's did.
constexpr int kMultiThreads = 128;  // consumer threads; a producer warp beside them
constexpr int kMultiWarps = kMultiThreads / 32;
constexpr int kMultiMaxRoots = 64;
// the card's 227 KiB a block less 1 KiB for the static barriers
constexpr int kMultiMaxDynSmem = 226 * 1024;
// a launch's leaf and stack slots (2 KiB each at VEC and L 1) leave this
// much beside them for the counters and, where it fits, the table
constexpr int kMultiCounterSmemBytes = 16384;
// the table's 32-bit entries are copied to shared memory up to this
// many; a longer table is read from device memory
constexpr int kMultiTableSmemEntries = 2048;
constexpr int kMultiMaxBuf = 4;

// blocks of the kernel at L an SM holds by registers: its
// __launch_bounds__ (the host's layout choice reads these as
// MULTI_LANE_BLOCKS in ops/kernels.py)
__host__ __device__ constexpr int multi_min_blocks(int lanes_vec) {
  return lanes_vec >= 8 ? 3 : lanes_vec >= 4 ? 5 : lanes_vec >= 2 ? 7 : 8;
}

// bytes of dynamic shared memory a plan_count_multi launch takes: the
// ring, the warps' stacks (L uint4 a lane and entry), the counters and the
// table where it is kept there (table_entries > 0)
__host__ __device__ constexpr int64_t multi_smem_bytes(int64_t n_root, int64_t n_leaf,
                                                       int64_t stack_slots, int64_t vec,
                                                       int64_t nbuf, int64_t lanes_vec,
                                                       int64_t table_entries) {
  return (nbuf * n_leaf * vec + stack_slots * lanes_vec) * kMultiThreads * 16 + n_root * 32 * 4 +
         (table_entries * 4 + 15) / 16 * 16;
}

// micro op OP (0 and, 1 or, 2 xor, 3 andnot, 4 rev_andnot) of (a, b)
template <int OP>
__device__ __forceinline__ uint4 micro_op(uint4 a, uint4 b) {
  if constexpr (OP == 0) return make_uint4(a.x & b.x, a.y & b.y, a.z & b.z, a.w & b.w);
  if constexpr (OP == 1) return make_uint4(a.x | b.x, a.y | b.y, a.z | b.z, a.w | b.w);
  if constexpr (OP == 2) return make_uint4(a.x ^ b.x, a.y ^ b.y, a.z ^ b.z, a.w ^ b.w);
  if constexpr (OP == 3) return make_uint4(a.x & ~b.x, a.y & ~b.y, a.z & ~b.z, a.w & ~b.w);
  return make_uint4(b.x & ~a.x, b.y & ~a.y, b.z & ~a.z, b.w & ~a.w);
}

template <int OP, int L>
__device__ __forceinline__ void micro_op_into(uint4 (&top)[L], const uint4 (&v)[L]) {
#pragma unroll
  for (int m = 0; m < L; ++m) top[m] = micro_op<OP>(top[m], v[m]);
}

// top = op(top, v) for L uint4, one warp-uniform branch
template <int L>
__device__ __forceinline__ void op_into(int op, uint4 (&top)[L], const uint4 (&v)[L]) {
  switch (op) {
    case 0: micro_op_into<0, L>(top, v); break;
    case 1: micro_op_into<1, L>(top, v); break;
    case 2: micro_op_into<2, L>(top, v); break;
    case 3: micro_op_into<3, L>(top, v); break;
    default: micro_op_into<4, L>(top, v); break;
  }
}

// A flat root (a leaf, then leaf_op OP over each further leaf: one n-ary
// node over leaves, the batcher's usual Count) over the codes [pc, pc1):
// the op is a template, so a code costs its slot's address and L loads.
template <int OP, int L>
__device__ __forceinline__ void flat_chain(uint4 (&top)[L], const uint4* part, int64_t tv,
                                           const int32_t* code, int pc, int pc1) {
  uint32_t c = (uint32_t)code[pc];  // read one ahead
  for (; pc < pc1; ++pc) {
    const uint32_t next = (uint32_t)code[pc + 1];
    const uint4* slot = part + (int64_t)(c >> 6) * tv;
#pragma unroll
    for (int m = 0; m < L; ++m) top[m] = micro_op<OP>(top[m], slot[m * 32]);
    c = next;
  }
}

// meta: the n_leaf leaf pointers, then the table's 32-bit entries: the
// first root of each consumer warp (kMultiWarps + 1), each root's output
// row (plus 256 * (1 + its op) for a flat root), each root's first code
// and the end, the codes and one padding entry (roots in warp order).
template <int L>
__global__ void __launch_bounds__(kMultiThreads + 32, multi_min_blocks(L))
plan_count_multi_kernel(const int64_t* __restrict__ meta, int32_t n_leaf, int32_t n_root,
                        int32_t n_code, int32_t stack_slots, int32_t vec, int32_t nbuf,
                        int32_t table_in_smem, int64_t w4, int64_t tiles, int64_t n_items,
                        int64_t shards, unsigned long long* __restrict__ out) {
  constexpr int T = kMultiThreads;
  extern __shared__ uint4 smem[];
  __shared__ uint64_t full[kMultiMaxBuf], empty[kMultiMaxBuf];
  int64_t lo, hi;
  block_items(n_items, &lo, &hi);
  if (lo >= hi) return;
  const int tid = threadIdx.x;
  const int64_t tv = (int64_t)T * vec;  // uint4 of one leaf's tile
  uint4* bufs = smem;                                        // [nbuf][n_leaf][tv]
  uint4* stacks = smem + (int64_t)nbuf * n_leaf * tv;        // [warp][stack_slots][L][32]
  uint32_t* cnt = reinterpret_cast<uint32_t*>(stacks + (int64_t)stack_slots * L * T);  // [n_root][32]
  const int32_t* tab = reinterpret_cast<const int32_t*>(meta + n_leaf);
  if (table_in_smem) {
    int32_t* st = reinterpret_cast<int32_t*>(cnt + n_root * 32);
    for (int i = tid; i < kMultiWarps + 3 + 2 * n_root + n_code; i += blockDim.x) st[i] = tab[i];
    tab = st;
  }
  for (int i = tid; i < n_root * 32; i += blockDim.x) cnt[i] = 0u;
  if (tid == 0) {
    for (int b = 0; b < nbuf; ++b) {
      mbar_init(&full[b], 1);
      mbar_init(&empty[b], kMultiWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int64_t n_run = hi - lo;

  if (tid >= T) {  // the producer warp: one lane issues every copy
    if (tid == T) {
      int64_t s = lo / tiles, t = lo - s * tiles;
      int b = 0;
      uint32_t phase = 0;  // of buffer b's empty barrier, once it has been used
      for (int64_t q = 0; q < n_run; ++q) {
        if (q >= nbuf) mbar_wait(&empty[b], phase);
        const int64_t col = t * tv;
        const int64_t rest = w4 - col;
        const uint32_t bytes = (uint32_t)((rest < tv ? rest : tv) * sizeof(uint4));
        mbar_expect_tx(&full[b], bytes * (uint32_t)n_leaf);
        uint4* dst = bufs + (int64_t)b * n_leaf * tv;
        for (int l = 0; l < n_leaf; ++l) {
          const uint4* src = reinterpret_cast<const uint4*>(__ldg(meta + l)) + s * w4 + col;
          bulk_copy(dst + (int64_t)l * tv, src, bytes, &full[b]);
        }
        if (++t == tiles) {
          t = 0;
          ++s;
        }
        if (++b == nbuf) {
          b = 0;
          if (q >= nbuf) phase ^= 1u;
        }
      }
    }
    return;
  }

  const int warp = tid >> 5, lane = tid & 31;
  const int32_t* rows = tab + kMultiWarps + 1;
  const int32_t* starts = rows + n_root;
  const int32_t* code = starts + n_root + 1;
  const int r0 = tab[warp], r1 = tab[warp + 1];
  uint4* stack = stacks + (int64_t)warp * stack_slots * L * 32 + lane;
  uint32_t* my_cnt = cnt + lane;
  auto flush = [&](int64_t s) {  // this warp's roots' counts of shard s, then zero
    for (int r = r0; r < r1; ++r) {
      const uint32_t v = my_cnt[r * 32];
      my_cnt[r * 32] = 0u;
      const uint32_t n = __reduce_add_sync(0xffffffffu, v);
      if (lane == 0 && n != 0u) {
        atomicAdd(out + (int64_t)(rows[r] & 255) * shards + s, (unsigned long long)n);
      }
    }
  };
  const int passes = 4 * vec / L;
  int64_t s = lo / tiles, t = lo - s * tiles, cur = s;
  int b = 0;
  uint32_t phase = 0;  // of buffer b's full barrier
  for (int64_t k = 0; k < n_run; ++k) {
    if (s != cur) {
      flush(cur);
      cur = s;
    }
    mbar_wait(&full[b], phase);
    const uint4* tile = bufs + (int64_t)b * n_leaf * tv + lane;
    for (int p = 0; p < passes; ++p) {
      const int i0 = p * L * 32;  // the pass's first uint4 of the tile
      // columns past the row's end hold stale bytes: evaluated, not counted
      bool valid[L];
#pragma unroll
      for (int m = 0; m < L; ++m) valid[m] = t * tv + i0 + m * 32 + lane < w4;
      const uint4* part = tile + i0;
      for (int r = r0; r < r1; ++r) {
        const int pc0 = starts[r], pc1 = starts[r + 1];
        const int flat = rows[r] >> 8;  // a flat root's op + 1, else 0
        uint4 top[L];
        if (flat) {
          const uint4* slot = part + (int64_t)((uint32_t)code[pc0] >> 6) * tv;
#pragma unroll
          for (int m = 0; m < L; ++m) top[m] = slot[m * 32];
          switch (flat - 1) {
            case 0: flat_chain<0, L>(top, part, tv, code, pc0 + 1, pc1); break;
            case 1: flat_chain<1, L>(top, part, tv, code, pc0 + 1, pc1); break;
            case 2: flat_chain<2, L>(top, part, tv, code, pc0 + 1, pc1); break;
            case 3: flat_chain<3, L>(top, part, tv, code, pc0 + 1, pc1); break;
            default: flat_chain<4, L>(top, part, tv, code, pc0 + 1, pc1); break;
          }
        } else {
#pragma unroll
          for (int m = 0; m < L; ++m) top[m] = make_uint4(0u, 0u, 0u, 0u);
          uint32_t c = (uint32_t)code[pc0];  // the next code, read one ahead
          int sp = 0;  // entries below top, in stack[0, sp)
          for (int pc = pc0; pc < pc1; ++pc) {
            const uint32_t next = (uint32_t)code[pc + 1];
            const int kind = (int)((c >> 3) & 7), op = (int)(c & 7);
            uint4 v[L];
            if (kind == M_STACK_OP) {  // top = op(below, top), as rev(op)(top, below)
              --sp;
#pragma unroll
              for (int m = 0; m < L; ++m) v[m] = stack[(sp * L + m) * 32];
              op_into<L>(op >= 3 ? 7 - op : op, top, v);
            } else {
              if (kind == M_PUSH || kind == M_LEAF_OP) {
                const uint4* slot = part + (int64_t)(c >> 6) * tv;
#pragma unroll
                for (int m = 0; m < L; ++m) v[m] = slot[m * 32];
              } else {
#pragma unroll
                for (int m = 0; m < L; ++m) v[m] = make_uint4(0u, 0u, 0u, 0u);
              }
              if (kind >= M_LEAF_OP) {
                op_into<L>(op, top, v);
              } else {
                if (pc > pc0) {  // every push but the first has a value under it
#pragma unroll
                  for (int m = 0; m < L; ++m) stack[(sp * L + m) * 32] = top[m];
                  ++sp;
                }
#pragma unroll
                for (int m = 0; m < L; ++m) top[m] = v[m];
              }
            }
            c = next;
          }
        }
        uint32_t n = 0;
#pragma unroll
        for (int m = 0; m < L; ++m) n += valid[m] ? popc4(top[m]) : 0u;
        my_cnt[r * 32] += n;  // root r's count in this lane
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[b]);
    if (++t == tiles) {
      t = 0;
      ++s;
    }
    if (++b == nbuf) {
      b = 0;
      phase ^= 1u;
    }
  }
  flush(cur);
}

// ---------------------------------------------------------------------------
// plan_rows: the same postfix program, storing the result words of every
// stack row and each row's popcount, with Shift as a kind of push.
// ---------------------------------------------------------------------------
//
// Replaces pilosa_tpu/exec/plan.py _eval_jit(plan, "row", ...) with
// pilosa_tpu/ops/bitmap.py shift_bits fused into it (an XLA program): a
// plan tree's [S, W] result words, the n-ary and/or/xor/andnot of its leaf
// stacks, and Shift carrying each row's high bits into the next shard's
// row.
//
// Bound: bytes. Every distinct leaf is read once and the result written
// once; a shifted leaf reads each word twice, the second time from L1.
//
// Design. The micro program and its folded pushes are plan_count's; each
// push also carries a shift n (0: none) and, when shifted, the offset of its
// predecessor table prev[S] (stack row of shard - 1, or -1). A shifted push
// of stack row i reads word k as (E[k - q] << r) | (E[k - q - 1] >> (32 -
// r)), q, r = divmod(n, 32), over the row's words extended downwards by its
// predecessor's: E[j] = leaf[i][j] for j >= 0, leaf[prev[i]][W + j] for j <
// 0 (0 where prev[i] < 0); n <= 32 W, so j never falls below -W. Only a leaf
// can be shifted: a Shift over any other subtree is two launches, the first
// materializing the subtree, the second shifting it as a leaf. Those reads
// sit at any word offset, which TMA's 16-byte bulk copies cannot serve, so
// this kernel reads words directly: an item is a tile of kPrTile words of
// one row, thread t evaluating words t + j * kThreads (j < kPrWords), so
// every load of a warp covers 128 consecutive bytes of a row, at any
// alignment and any W. The stack below the top lives in shared memory
// (kPrWords words per thread and entry). Blocks walk contiguous runs of
// items (block_items) and add each row's count into counts[row] with one
// 64-bit atomic per block and row.
constexpr int kPrWords = 4;
constexpr int64_t kPrTile = (int64_t)kThreads * kPrWords;  // 1024 words
constexpr int kPrMaxDynSmem = (kMaxStack - 1) * kPrWords * kThreads * (int)sizeof(uint32_t);

__device__ __forceinline__ uint32_t binop1(int op, uint32_t a, uint32_t b) {
  switch (op) {
    case 0:
      return a & b;
    case 1:
      return a | b;
    case 2:
      return a ^ b;
    case 3:
      return a & ~b;
    default:
      return b & ~a;
  }
}

// Word j of stack row `row` extended downwards by row `prev` (see above).
__device__ __forceinline__ uint32_t extended_word(const uint32_t* __restrict__ leaf, int64_t row,
                                                  int64_t prev, int64_t w, int64_t j) {
  if (j >= 0) return __ldg(leaf + row * w + j);
  if (prev < 0) return 0u;
  return __ldg(leaf + prev * w + w + j);
}

// meta: the leaf pointer of each push in program order [n_push], its shift
// n [n_push], its predecessor table's offset in prev_tab [n_push] (-1:
// unshifted), then the micro program [n_code].
__global__ void __launch_bounds__(kThreads)
plan_rows_kernel(const int64_t* __restrict__ meta, const int64_t* __restrict__ prev_tab,
                 int32_t n_push, int32_t n_code, int64_t w, int64_t tiles, int64_t n_items,
                 uint32_t* __restrict__ out, unsigned long long* __restrict__ counts) {
  extern __shared__ uint32_t stack[];  // [stack_slots][kPrWords][kThreads]
  __shared__ unsigned long long partial[kWarps];
  int64_t lo, hi;
  block_items(n_items, &lo, &hi);
  if (lo >= hi) return;
  const int tid = threadIdx.x;
  const int64_t* push_ptr = meta;
  const int64_t* push_shift = meta + n_push;
  const int64_t* push_prev = meta + 2 * (int64_t)n_push;
  const int64_t* code = meta + 3 * (int64_t)n_push;
  int64_t s = lo / tiles, t = lo % tiles, cur = s;
  uint32_t acc = 0;
  for (int64_t item = lo; item < hi; ++item) {
    if (s != cur) {
      flush_count(counts + cur, acc, partial);
      acc = 0;
      cur = s;
    }
    const int64_t k0 = t * kPrTile + tid;
    uint32_t top[kPrWords];
    int sp = 0, push = 0;
    for (int pc = 0; pc < n_code; ++pc) {
      const int c = (int)__ldg(code + pc);
      const int kind = c >> 3, op = c & 7;
      if (kind == M_STACK_OP) {
        --sp;
#pragma unroll
        for (int j = 0; j < kPrWords; ++j) {
          top[j] = binop1(op, stack[(sp * kPrWords + j) * kThreads + tid], top[j]);
        }
        continue;
      }
      uint32_t v[kPrWords];
      if (kind == M_PUSH || kind == M_LEAF_OP) {
        const uint32_t* leaf = reinterpret_cast<const uint32_t*>(__ldg(push_ptr + push));
        const int64_t n = __ldg(push_shift + push);
        if (n == 0) {
#pragma unroll
          for (int j = 0; j < kPrWords; ++j) {
            const int64_t k = k0 + j * kThreads;
            v[j] = k < w ? __ldg(leaf + s * w + k) : 0u;
          }
        } else {
          const int64_t q = n >> 5;
          const int r = (int)(n & 31);
          const int64_t prev = __ldg(prev_tab + __ldg(push_prev + push) + s);
#pragma unroll
          for (int j = 0; j < kPrWords; ++j) {
            const int64_t k = k0 + j * kThreads;
            uint32_t x = 0u;
            if (k < w) {
              x = extended_word(leaf, s, prev, w, k - q);
              if (r != 0) {
                x = (x << r) | (extended_word(leaf, s, prev, w, k - q - 1) >> (32 - r));
              }
            }
            v[j] = x;
          }
        }
        ++push;
      } else {
#pragma unroll
        for (int j = 0; j < kPrWords; ++j) v[j] = 0u;
      }
      if (kind >= M_LEAF_OP) {
#pragma unroll
        for (int j = 0; j < kPrWords; ++j) top[j] = binop1(op, top[j], v[j]);
      } else {
        if (pc > 0) {  // every push but the first has a value under it
#pragma unroll
          for (int j = 0; j < kPrWords; ++j) stack[(sp * kPrWords + j) * kThreads + tid] = top[j];
          ++sp;
        }
#pragma unroll
        for (int j = 0; j < kPrWords; ++j) top[j] = v[j];
      }
    }
#pragma unroll
    for (int j = 0; j < kPrWords; ++j) {
      const int64_t k = k0 + j * kThreads;
      if (k < w) {
        out[s * w + k] = top[j];
        acc += __popc(top[j]);
      }
    }
    if (++t == tiles) {
      t = 0;
      ++s;
    }
  }
  flush_count(counts + cur, acc, partial);
}

// ---------------------------------------------------------------------------
// gather_tally: out[g] = sum over k in [starts[g], ends[g]) of
// popcount(src[idx[k]] & mask[k]), segments sorted and disjoint.
// ---------------------------------------------------------------------------
//
// Replaces pilosa_tpu/ops/bitmap.py gather_tally_sorted (an XLA program):
// the sparse half of the filtered TopN tally, one entry per live word of a
// sparse candidate row and one segment per (shard, row).
//
// Bound: bytes. Each entry streams 8 B (idx, mask), each segment 12 B
// (starts, ends, out), and src is read only where idx points: HBM moves
// whole 32-byte sectors, so the least the card can move for src is 32 B
// per distinct sector that idx touches (at the main path's 8 rows x ~985
// words per shard, about 85% of each shard's 128 KiB slice), not 4 B per
// gather.
//
// Design. Work is balanced over entries, not segments: the entry axis is
// cut into chunks of 32 * kGtRun entries, one per warp, and the warps of a
// persistent grid take chunks in turn (chunk c goes to warp c mod warps),
// so a segment of any length is shared among as many warps as its entries
// fill. A warp reads its chunk's idx and mask 128 coalesced bytes at a
// time as streaming loads (evict first: they are read once), lane l taking
// entries c0 + l + 32 i, and issues all kGtRun gathers of src of each lane
// before its first popcount; the 32 gathers of one load then fall on
// neighbouring words of one row, a few sectors apart. Because the warps in
// flight hold neighbouring chunks, the card works on a window of about
// warps * 32 * kGtRun consecutive entries at a time; with entries laid out
// shard-major (the executor puts every row's entries for shard j next to
// each other) that window spans a few hundred shards' src slices, well
// inside L2, so the rows of one shard that gather from the same sector
// meet it in L1 or L2 and HBM delivers it once. The popcounts go through
// shared memory to lane-major order (lane l holds entries c0 + l * kGtRun
// + i), where a lane walks its run through starts/ends. The segment of a
// lane's first entry comes from a 32-way warp search of starts: one round
// over the 32 segments around a guess from the mean segment length for the
// chunk's first entry, one from there for its last, a wider search only
// when the answer lies outside, then a short search between the two. A
// lane adds a segment piece it finishes with an atomic, and the warp sums
// the lanes' last pieces with a segmented shuffle reduction (the lanes'
// segments are in order), one atomic per segment piece and warp. The sums
// are integers, so the atomics' order cannot change a result; they are
// uint32, wrapping as the reference's uint32 cumsum does (the caller keeps
// entries under 2^27, so no segment wraps). The entry point zeroes out
// with a memset on the same stream first.
constexpr int kGtThreads = 256;             // threads per block
constexpr int kGtWarps = kGtThreads / 32;
constexpr int kGtRun = 8;                   // entries per lane and chunk
constexpr int kGtChunk = 32 * kGtRun;       // entries per warp chunk

// The number of g in [lo, hi) with starts[g] <= x, plus lo (starts sorted):
// each round every lane probes one of 32 evenly spaced points, so a range
// of n segments takes about log32(n) rounds. Every lane of the warp calls it
// with the same arguments and gets the same answer.
__device__ __forceinline__ int warp_upper_bound(const int32_t* __restrict__ starts, int lo, int hi,
                                                int32_t x, int lane) {
  while (lo < hi) {
    const int step = (hi - lo + 31) / 32;
    const int p = lo + (lane + 1) * step - 1;
    const bool le = p < hi && __ldg(starts + p) <= x;
    const int c = __popc(__ballot_sync(0xffffffffu, le));
    lo += c * step;
    hi = min(hi, lo + step - 1);
  }
  return lo;
}

// The same count, found first in one round over the 32 segments from
// `near` on (a guess), and by warp_upper_bound over what lies beyond that
// window only when the answer is outside it.
__device__ __forceinline__ int warp_upper_bound_near(const int32_t* __restrict__ starts, int n_seg,
                                                     int32_t x, int64_t near, int lane) {
  const int64_t top = (int64_t)n_seg - 32;
  const int b = (int)(near < 0 || top < 0 ? 0 : near < top ? near : top);
  const int p = b + lane;
  const bool le = p < n_seg && __ldg(starts + p) <= x;
  const int cnt = __popc(__ballot_sync(0xffffffffu, le));
  if (cnt == 0 && b > 0) return warp_upper_bound(starts, 0, b, x, lane);
  if (cnt == 32 && b + 32 < n_seg) return warp_upper_bound(starts, b + 32, n_seg, x, lane);
  return b + cnt;
}

__global__ void __launch_bounds__(kGtThreads)
gather_tally_kernel(const uint32_t* __restrict__ src, int64_t n_src,
                    const int32_t* __restrict__ idx, const uint32_t* __restrict__ mask,
                    int32_t n_ent, const int32_t* __restrict__ starts,
                    const int32_t* __restrict__ ends, int32_t n_seg,
                    unsigned int* __restrict__ out) {
  // each warp's chunk of popcounts, turned from the load order (entry
  // c0 + lane + 32 i) to the walk order (entry c0 + lane * kGtRun + i)
  __shared__ __align__(16) uint32_t vals[kGtWarps][kGtChunk];
  const int lane = threadIdx.x & 31;
  uint32_t* wv = vals[threadIdx.x >> 5];
  const int64_t warps = (int64_t)gridDim.x * kGtWarps;
  const int64_t n_chunks = ((int64_t)n_ent + kGtChunk - 1) / kGtChunk;
  for (int64_t c = (int64_t)blockIdx.x * kGtWarps + (threadIdx.x >> 5); c < n_chunks; c += warps) {
    const int64_t c0 = c * kGtChunk;
    // idx and mask of entries c0 + lane + 32 i (each load 128 coalesced
    // bytes), then every gather, before anything waits on them: the 32
    // gathers of one load hit neighbouring words of one row
    int32_t ix[kGtRun];
    uint32_t mk[kGtRun];
#pragma unroll
    for (int i = 0; i < kGtRun; ++i) {
      const int64_t k = c0 + lane + 32 * i;
      const bool in = k < n_ent;
      ix[i] = in ? __ldcs(idx + k) : -1;
      mk[i] = in ? __ldcs(mask + k) : 0u;
    }
    uint32_t v[kGtRun];
#pragma unroll
    for (int i = 0; i < kGtRun; ++i) {
      // an idx outside src (outside the contract) reads nothing, counts 0
      v[i] = (uint64_t)(uint32_t)ix[i] < (uint64_t)n_src ? __ldg(src + ix[i]) : 0u;
    }
    // the segment of the lane's run c0 + lane * kGtRun ...: the last g with
    // starts[g] <= its first entry (-1 if none); the chunk's first and last
    // entries bound the search for every lane
    const int64_t k0 = c0 + lane * kGtRun;
    const int32_t c_last = (int32_t)(c0 + kGtChunk < n_ent ? c0 + kGtChunk - 1 : n_ent - 1);
    const int ga = warp_upper_bound_near(starts, n_seg, (int32_t)c0, c0 * n_seg / n_ent - 16, lane);
    const int gb = warp_upper_bound_near(starts, n_seg, c_last, ga - 1, lane);
    int lo = ga, hi = gb;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (__ldg(starts + mid) <= k0) lo = mid + 1; else hi = mid;
    }
    int g = lo - 1;
    int32_t end = g >= 0 ? __ldg(ends + g) : 0;
    int32_t nxt = g + 1 < n_seg ? __ldg(starts + g + 1) : INT32_MAX;
#pragma unroll
    for (int i = 0; i < kGtRun; ++i) wv[lane + 32 * i] = __popc(v[i] & mk[i]);
    __syncwarp();
    uint32_t r[kGtRun];
#pragma unroll
    for (int h = 0; h < kGtRun / 4; ++h) {
      const uint4 q = reinterpret_cast<const uint4*>(wv + lane * kGtRun)[h];
      r[4 * h] = q.x, r[4 * h + 1] = q.y, r[4 * h + 2] = q.z, r[4 * h + 3] = q.w;
    }
    __syncwarp();  // every lane has read its run before the next chunk's writes
    uint32_t acc = 0;
#pragma unroll
    for (int i = 0; i < kGtRun; ++i) {
      const int64_t k = k0 + i;
      if (k >= n_ent) break;
      while (k >= nxt) {  // k lies past segment g: on to the next one
        if (acc != 0u) atomicAdd(out + g, acc);
        acc = 0u;
        ++g;
        end = __ldg(ends + g);
        nxt = g + 1 < n_seg ? __ldg(starts + g + 1) : INT32_MAX;
      }
      if (k < end) acc += r[i];
    }
    // the lanes' last pieces: keys g are in lane order, so a suffix sum
    // over equal keys leaves each run's total in its first lane
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const uint32_t a = __shfl_down_sync(0xffffffffu, acc, o);
      const int kg = __shfl_down_sync(0xffffffffu, g, o);
      if (lane + o < 32 && kg == g) acc += a;
    }
    const int prev = __shfl_up_sync(0xffffffffu, g, 1);
    if ((lane == 0 || prev != g) && g >= 0 && acc != 0u) atomicAdd(out + g, acc);
  }
}

int sm_count() {
  static const int sms = [] {
    int dev = 0, n = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    return n > 0 ? n : 1;
  }();
  return sms;
}

// Every block of `kernel` that fits on the card at once, at most `items`.
template <typename Kernel>
int resident_grid(Kernel kernel, size_t smem, int64_t items, int threads = kThreads) {
  int per_sm = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  int64_t g = (int64_t)(per_sm > 0 ? per_sm : 1) * sm_count();
  if (g > items) g = items;
  return (int)(g > 0 ? g : 1);
}

template <int OP>
void launch_count2(const int64_t* meta, int64_t n_seg, int64_t n_items,
                   unsigned long long* out, cudaStream_t st) {
  const int grid = resident_grid(count2_kernel<OP>, 0, n_items);
  count2_kernel<OP><<<grid, kThreads, 0, st>>>(meta, n_seg, n_items, out);
}

}  // namespace

// `host_table` (pinned) holds n_seg zeros (the output), then count2_kernel's
// meta; it is copied to `dev_table` and the kernel counts every segment.
PT_EXPORT int pt_count2(const void* host_table, int64_t table_bytes, void* dev_table,
                        int64_t n_seg, int64_t n_items, int op, void* stream) {
  if (n_seg < 1 || n_items < 1 || op < OP_NONE || op > OP_ANDNOT) {
    return (int)cudaErrorInvalidValue;
  }
  auto st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      cudaMemcpyAsync(dev_table, host_table, table_bytes, cudaMemcpyHostToDevice, st);
  if (err != cudaSuccess) return (int)err;
  auto* out = static_cast<unsigned long long*>(dev_table);
  const int64_t* meta = static_cast<const int64_t*>(dev_table) + n_seg;
  switch (op) {
    case OP_NONE:
      launch_count2<OP_NONE>(meta, n_seg, n_items, out, st);
      break;
    case OP_AND:
      launch_count2<OP_AND>(meta, n_seg, n_items, out, st);
      break;
    case OP_OR:
      launch_count2<OP_OR>(meta, n_seg, n_items, out, st);
      break;
    case OP_XOR:
      launch_count2<OP_XOR>(meta, n_seg, n_items, out, st);
      break;
    default:
      launch_count2<OP_ANDNOT>(meta, n_seg, n_items, out, st);
      break;
  }
  return (int)cudaGetLastError();
}

PT_EXPORT int pt_rows_counts(const void* stack, int64_t rows, int64_t w,
                             const void* filt, int64_t f_rows, int vec,
                             void* out, void* stream) {
  if (rows > 0) {
    rows_counts_kernel<<<(unsigned int)rows, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(stack), w,
        static_cast<const uint32_t*>(filt), f_rows, vec,
        static_cast<int32_t*>(out));
  }
  return (int)cudaGetLastError();
}

namespace {

template <int VEC>
int launch_plan_count(const int64_t* meta, int64_t shards, int64_t n_push, int64_t n_code,
                      int64_t stack_slots, int64_t w, unsigned long long* out, cudaStream_t st) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      plan_count_kernel<VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxDynSmem);
  if (attr != cudaSuccess) return (int)attr;
  const int64_t w4 = w / 4;
  const int64_t tiles = (w4 + kThreads * VEC - 1) / (kThreads * VEC);
  const int64_t n_meta = n_push + n_code;
  const int meta_in_smem = n_meta * (int64_t)sizeof(int64_t) <= kMetaSmemBytes;
  const size_t smem = (size_t)(kRing + stack_slots) * VEC * kThreads * sizeof(uint4) +
                      (meta_in_smem ? (size_t)n_meta * sizeof(int64_t) : 0);
  const int64_t n_items = shards * tiles;
  const int grid = resident_grid(plan_count_kernel<VEC>, smem, n_items);
  plan_count_kernel<VEC><<<grid, kThreads, smem, st>>>(
      meta, (int32_t)n_push, (int32_t)n_code, (int32_t)stack_slots, meta_in_smem, w4, tiles,
      n_items, out);
  return (int)cudaGetLastError();
}

}  // namespace

// `host_table` (pinned) holds `shards` zeros (the output), then the leaf
// pointer of each of the n_push pushes in program order, then the n_code
// micro program entries; the caller has built them from a checked program
// (stack_slots < kMaxStack entries below the top) and checked that every
// leaf is 16-byte aligned and that w % 4 == 0.
PT_EXPORT int pt_plan_count(const void* host_table, int64_t table_bytes, void* dev_table,
                            int64_t shards, int64_t n_push, int64_t n_code, int64_t stack_slots,
                            int64_t w, void* stream) {
  if (shards < 1 || n_push < 0 || n_code < 1 || stack_slots < 0 || stack_slots >= kMaxStack ||
      w < 4 || w % 4 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  auto st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      cudaMemcpyAsync(dev_table, host_table, table_bytes, cudaMemcpyHostToDevice, st);
  if (err != cudaSuccess) return (int)err;
  const int64_t* meta = static_cast<const int64_t*>(dev_table) + shards;
  auto* out = static_cast<unsigned long long*>(dev_table);
  if (stack_slots <= kWideStackSlots) {
    return launch_plan_count<2>(meta, shards, n_push, n_code, stack_slots, w, out, st);
  }
  return launch_plan_count<1>(meta, shards, n_push, n_code, stack_slots, w, out, st);
}

namespace {

template <int L>
int launch_plan_count_multi(const int64_t* meta, int64_t shards, int64_t n_root, int64_t n_leaf,
                            int64_t n_code, int64_t stack_slots, int64_t vec, int64_t nbuf,
                            int64_t table_in_smem, int64_t w, unsigned long long* out,
                            cudaStream_t st) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      plan_count_multi_kernel<L>, cudaFuncAttributeMaxDynamicSharedMemorySize, kMultiMaxDynSmem);
  if (attr != cudaSuccess) return (int)attr;
  const int64_t w4 = w / 4;
  const int64_t tiles = (w4 + kMultiThreads * vec - 1) / (kMultiThreads * vec);
  const size_t smem = (size_t)multi_smem_bytes(
      n_root, n_leaf, stack_slots, vec, nbuf, L,
      table_in_smem ? kMultiWarps + 3 + 2 * n_root + n_code : 0);
  const int64_t n_items = shards * tiles;
  const int grid = resident_grid(plan_count_multi_kernel<L>, smem, n_items, kMultiThreads + 32);
  plan_count_multi_kernel<L><<<grid, kMultiThreads + 32, smem, st>>>(
      meta, (int32_t)n_leaf, (int32_t)n_root, (int32_t)n_code, (int32_t)stack_slots, (int32_t)vec,
      (int32_t)nbuf, (int32_t)table_in_smem, w4, tiles, n_items, shards, out);
  return (int)cudaGetLastError();
}

}  // namespace

// `host_table` (pinned) holds n_root * shards zeros (the [N, S] output),
// then the n_leaf distinct leaf pointers, then as 32-bit entries the first
// root of each of the kMultiWarps consumer warps and the end, each root's
// output row plus 256 * (1 + its op) if it is flat (0 if not), the n_root
// + 1 offsets of each root's codes, the n_code
// micro program entries of every root (each code plan_count's kind * 8 +
// op plus 64 * the leaf slot it reads) and one padding entry, the roots
// in warp order. The caller has built them from checked programs,
// checked alignment and w % 4 == 0, grouped the roots so that n_leaf +
// stack_slots slots of kMultiThreads uint4 leave kMultiCounterSmemBytes
// of kMultiMaxDynSmem, and chosen VEC, the ring's nbuf, L (uint4 a lane
// a pass) and where the table lives (ops/kernels.py
// plan_count_multi_layout); a layout that does not fit is refused.
PT_EXPORT int pt_plan_count_multi(const void* host_table, int64_t table_bytes, void* dev_table,
                                  int64_t shards, int64_t n_root, int64_t n_leaf,
                                  int64_t n_code, int64_t stack_slots, int64_t vec,
                                  int64_t nbuf, int64_t lanes_vec, int64_t table_in_smem,
                                  int64_t w, void* stream) {
  const int64_t tile_bytes = (int64_t)kMultiThreads * sizeof(uint4);
  const int64_t entries = kMultiWarps + 3 + 2 * n_root + n_code;
  if (shards < 1 || n_root < 1 || n_root > kMultiMaxRoots || n_leaf < 0 || n_code < n_root ||
      stack_slots < 0 || stack_slots >= kMaxStack || w < 4 || w % 4 != 0 ||
      (n_leaf + stack_slots) * tile_bytes + kMultiCounterSmemBytes > kMultiMaxDynSmem ||
      (vec != 1 && vec != 2) || nbuf < 1 || nbuf > kMultiMaxBuf ||
      (lanes_vec != 1 && lanes_vec != 2 && lanes_vec != 4 && lanes_vec != 8) ||
      lanes_vec > 4 * vec || table_in_smem < 0 || table_in_smem > 1 ||
      (table_in_smem && entries > kMultiTableSmemEntries) ||
      multi_smem_bytes(n_root, n_leaf, stack_slots, vec, nbuf, lanes_vec,
                       table_in_smem ? entries : 0) > kMultiMaxDynSmem) {
    return (int)cudaErrorInvalidValue;
  }
  auto st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      cudaMemcpyAsync(dev_table, host_table, table_bytes, cudaMemcpyHostToDevice, st);
  if (err != cudaSuccess) return (int)err;
  if (n_leaf == 0) return (int)cudaGetLastError();  // every root is zero
  auto* out = static_cast<unsigned long long*>(dev_table);
  const int64_t* meta = static_cast<const int64_t*>(dev_table) + n_root * shards;
  switch (lanes_vec) {
    case 8:
      return launch_plan_count_multi<8>(meta, shards, n_root, n_leaf, n_code, stack_slots, vec,
                                        nbuf, table_in_smem, w, out, st);
    case 4:
      return launch_plan_count_multi<4>(meta, shards, n_root, n_leaf, n_code, stack_slots, vec,
                                        nbuf, table_in_smem, w, out, st);
    case 2:
      return launch_plan_count_multi<2>(meta, shards, n_root, n_leaf, n_code, stack_slots, vec,
                                        nbuf, table_in_smem, w, out, st);
    default:
      return launch_plan_count_multi<1>(meta, shards, n_root, n_leaf, n_code, stack_slots, vec,
                                        nbuf, table_in_smem, w, out, st);
  }
}

// `host_table` (pinned) holds `rows` zeros (the per-row counts), then per
// push in program order its leaf pointer, its shift n (0: none) and the
// offset of its predecessor table (-1: none), then the n_code micro program
// entries, then the predecessor tables (`rows` entries each). The caller
// has checked the program (stack_slots < kMaxStack), every leaf's shape
// [rows, w], each shift 0 <= n <= 32 w and each table entry in [-1, rows).
// out: [rows, w] words.
PT_EXPORT int pt_plan_rows(const void* host_table, int64_t table_bytes, void* dev_table,
                           int64_t rows, int64_t n_push, int64_t n_code, int64_t stack_slots,
                           int64_t w, void* out, void* stream) {
  if (rows < 1 || n_push < 1 || n_code < 1 || stack_slots < 0 || stack_slots >= kMaxStack ||
      w < 1) {
    return (int)cudaErrorInvalidValue;
  }
  static const cudaError_t attr = cudaFuncSetAttribute(
      plan_rows_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kPrMaxDynSmem);
  if (attr != cudaSuccess) return (int)attr;
  auto st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      cudaMemcpyAsync(dev_table, host_table, table_bytes, cudaMemcpyHostToDevice, st);
  if (err != cudaSuccess) return (int)err;
  auto* counts = static_cast<unsigned long long*>(dev_table);
  const int64_t* meta = static_cast<const int64_t*>(dev_table) + rows;
  const int64_t* prev_tab = meta + 3 * n_push + n_code;
  const int64_t tiles = (w + kPrTile - 1) / kPrTile;
  const int64_t n_items = rows * tiles;
  const size_t smem = (size_t)stack_slots * kPrWords * kThreads * sizeof(uint32_t);
  const int grid = resident_grid(plan_rows_kernel, smem, n_items);
  plan_rows_kernel<<<grid, kThreads, smem, st>>>(meta, prev_tab, (int32_t)n_push, (int32_t)n_code,
                                                 w, tiles, n_items, static_cast<uint32_t*>(out),
                                                 counts);
  return (int)cudaGetLastError();
}

// n_src words of src; n_ent entries of idx and mask; n_seg segments of
// starts, ends and out.
PT_EXPORT int pt_gather_tally(const void* src, int64_t n_src, const void* idx, const void* mask,
                              int64_t n_ent, const void* starts, const void* ends, int64_t n_seg,
                              void* out, void* stream) {
  constexpr int64_t kMaxCount = INT32_MAX - 256;
  if (n_src < 0 || n_ent < 0 || n_ent > kMaxCount || n_seg < 0 || n_seg > kMaxCount) {
    return (int)cudaErrorInvalidValue;
  }
  if (n_seg == 0) return (int)cudaGetLastError();
  auto st = static_cast<cudaStream_t>(stream);
  const cudaError_t err = cudaMemsetAsync(out, 0, (size_t)n_seg * sizeof(int32_t), st);
  if (err != cudaSuccess || n_ent == 0) return (int)err;
  const int64_t n_chunks = (n_ent + kGtChunk - 1) / kGtChunk;
  const int grid =
      resident_grid(gather_tally_kernel, 0, (n_chunks + kGtWarps - 1) / kGtWarps, kGtThreads);
  gather_tally_kernel<<<grid, kGtThreads, 0, st>>>(
      static_cast<const uint32_t*>(src), n_src, static_cast<const int32_t*>(idx),
      static_cast<const uint32_t*>(mask), (int32_t)n_ent, static_cast<const int32_t*>(starts),
      static_cast<const int32_t*>(ends), (int32_t)n_seg, static_cast<unsigned int*>(out));
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// GroupBy's cross tally (pilosa_tpu/exec/groupby.py, XLA programs there):
//   counts_cross_kernel  _counts_cross: out[g, r, s] = popcount(acc[g, s] &
//                        planes[r, s]) for every live prefix g and candidate
//                        row r, int32 (a shard holds at most 2^20 bits)
//   gather_and_kernel    _select_rows_filtered, _select_pairs and
//                        _cross_expand: out[i] = A[ia[i]] & B[ib[i]] over
//                        whole [S, W] slabs
// Both are bound by device-memory bytes. gather_and reads each distinct
// operand slab once and writes each output slab once, where eager PyTorch
// writes both gathered slabs (repeats included) before the AND.
//
// counts_cross is, shard by shard, a binary matrix product: [G x 32W bits]
// times [32W bits x R] with AND as the multiply and popcount as the add.
// On the CUDA cores that is G * R popcounts for every G + R words read, and
// at the cluster legs' G = 11 x R = 8 the popcount pipe (16 a clock per SM
// on compute capability 9.0) held the kernel at 37% of its byte bound. The
// tensor cores compute exactly this product: mma.sync m16n8k256 .b1 with
// .and.popc takes a 16 x 256-bit tile of acc rows and a 256-bit x 8 tile of
// plane rows into a 16 x 8 tile of s32 counts. So a warp holds one 16 x 8
// count tile (4 registers a thread) across its share of a shard's words,
// and every acc and plane word is read once (G <= 16, R <= 8; a wider
// product reads acc once per 8 plane rows and the planes once per 16
// prefixes). Prefixes past G and rows past R are zero words in the tile:
// they cost tensor time, not bytes.
// ---------------------------------------------------------------------------

namespace {

// counts_cross: warps per block, words of a row per warp step (four mma's
// of 8 words each), and steps whose loads a warp keeps in flight together
constexpr int kCxWarps = 8;
constexpr int kCxThreads = kCxWarps * 32;
constexpr int kCxStep = 32;
constexpr int kCxUnroll = 4;  // 2 on the word-by-word path (VEC = 0), which spills at 4
// blocks a launch aims for (16 per SM): a shard's words are split among
// blocks until the grid has about this many
constexpr int64_t kCxBlocks = 132 * 16;

// This thread's WPT words of the tile starting at word `base` of a W-word
// row: uint4 q = base / 4 + k * kThreads + tid for k < WPT / 4 (VEC), else
// word base + k * kThreads + tid; zero past the row's end.
template <int WPT, int VEC>
__device__ __forceinline__ void tile_words(const uint32_t* __restrict__ row, int64_t base,
                                           int64_t W, uint32_t (&out)[WPT]) {
  if constexpr (VEC) {
    const uint4* row4 = reinterpret_cast<const uint4*>(row);
    const int64_t w4 = W / 4;
#pragma unroll
    for (int k = 0; k < WPT / 4; ++k) {
      const int64_t q = base / 4 + (int64_t)k * kThreads + threadIdx.x;
      const uint4 v = q < w4 ? row4[q] : make_uint4(0u, 0u, 0u, 0u);
      out[4 * k] = v.x;
      out[4 * k + 1] = v.y;
      out[4 * k + 2] = v.z;
      out[4 * k + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int k = 0; k < WPT; ++k) {
      const int64_t i = base + (int64_t)k * kThreads + threadIdx.x;
      out[k] = i < W ? row[i] : 0u;
    }
  }
}

// One m16n8k256 tile of the binary product, accumulated into c: a0/a2 are
// 32-bit slots t and t + 4 (t = lane % 4) of prefix row lane / 4, a1/a3 the
// same slots of row lane / 4 + 8; b0/b1 slots t and t + 4 of plane row
// lane / 4; c0/c1 count rows lane / 4, c2/c3 rows lane / 4 + 8, at columns
// 2t and 2t + 1.
__device__ __forceinline__ void mma_and_popc(int (&c)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                             uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// This lane's 8 words of one warp step of a row: x[0..3] = words base + 4t
// .. base + 4t + 3 and x[4..7] = words base + 16 + 4t .. (t = lane % 4), so
// the four lanes of a row read its 128 bytes as two 64-byte runs; zero past
// the row's end or for an absent row (row == nullptr). VEC: W % 4 == 0 and
// the row 16-byte aligned.
template <int VEC>
__device__ __forceinline__ void step_words(const uint32_t* __restrict__ row, int64_t base, int64_t W,
                                           int t, uint32_t (&x)[8]) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int64_t i = base + 16 * h + 4 * t;
    if constexpr (VEC) {
      const uint4 v = (row != nullptr && i < W) ? __ldg(reinterpret_cast<const uint4*>(row + i))
                                                : make_uint4(0u, 0u, 0u, 0u);
      x[4 * h] = v.x;
      x[4 * h + 1] = v.y;
      x[4 * h + 2] = v.z;
      x[4 * h + 3] = v.w;
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k) x[4 * h + k] = (row != nullptr && i + k < W) ? __ldg(row + i + k) : 0u;
    }
  }
}

// One block per (shard s, split of its words, 16-prefix x 8-row tile). The
// split's warp steps go to the block's warps in turn (warp w takes steps
// w, w + 8, ...), kCxUnroll steps' loads at once. A step covers kCxStep * P
// words of every row. A product narrower than the tile (P > 1: P * G <= 16
// prefixes and P * R <= 8 rows) packs P word ranges into it: tile row
// p * G + g holds prefix g over the step's p-th 32 words, tile column
// p * R + r plane row r over the same words, and only the P diagonal
// blocks of the count tile are kept, so P times as many bytes are in
// flight for the same registers. Within 32 words, word 4t + m (m < 4) of
// every row fills 32-bit slot t of mma m and word 16 + 4t + m its slot
// t + 4, for prefix and plane rows alike: the product sums over all
// words, so it may take them in any order that pairs acc word w with plane
// word w. The warps' tiles meet in shared memory, and the block adds each
// non-zero count to out[g, r, s] with one atomic (out zeroed by the entry
// point; a shard holds at most 2^20 bits, so no count wraps). The entry
// point may hand the kernel the plane rows as its "prefixes" and the
// prefixes as its "rows" (a product of fewer than 8 prefixes over more
// rows packs more word ranges that way): tile row g and column r add to
// out[g * oa + r * ob + s].
template <int VEC>
__global__ void __launch_bounds__(kCxThreads, 2)
counts_cross_kernel(const uint32_t* __restrict__ acc, const uint32_t* __restrict__ planes,
                    int64_t G, int64_t R, int64_t S, int64_t W, int P, int64_t splits, int64_t per,
                    int64_t n_tiles, int64_t oa, int64_t ob, unsigned int* __restrict__ out) {
  __shared__ int tile[16 * 8];
  const int64_t s = blockIdx.x / splits;
  const int64_t st0 = (blockIdx.x % splits) * per;
  const int64_t span = (int64_t)kCxStep * P;
  const int64_t steps = (W + span - 1) / span;
  const int64_t st1 = st0 + per < steps ? st0 + per : steps;
  const int64_t g0 = (int64_t)(blockIdx.y / n_tiles) * 16;
  const int64_t r0 = (int64_t)(blockIdx.y % n_tiles) * 8;
  // tile rows and columns per word range: the whole tile when P == 1
  const int gt = P == 1 ? 16 : (int)G;
  const int rt = P == 1 ? 8 : (int)R;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int q = lane >> 2;
  const int t = lane & 3;
  // this lane's rows (prefix rows q and q + 8, plane row q) and the offset
  // of each one's word range within a step
  const uint32_t* lo = nullptr;
  const uint32_t* hi = nullptr;
  const uint32_t* pl = nullptr;
  int64_t off_lo = 0, off_hi = 0, off_pl = 0;
  if (q / gt < P && g0 + q % gt < G) {
    lo = acc + ((g0 + q % gt) * S + s) * W;
    off_lo = (int64_t)(q / gt) * kCxStep;
  }
  if ((q + 8) / gt < P && g0 + (q + 8) % gt < G) {
    hi = acc + ((g0 + (q + 8) % gt) * S + s) * W;
    off_hi = (int64_t)((q + 8) / gt) * kCxStep;
  }
  if (q / rt < P && r0 + q % rt < R) {
    pl = planes + ((r0 + q % rt) * S + s) * W;
    off_pl = (int64_t)(q / rt) * kCxStep;
  }
  if (threadIdx.x < 16 * 8) tile[threadIdx.x] = 0;
  constexpr int U = VEC ? kCxUnroll : 2;
  int c[4] = {0, 0, 0, 0};
  for (int64_t st = st0 + warp; st < st1; st += kCxWarps * U) {
    uint32_t a[U][8], b[U][8], p[U][8];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int64_t su = st + (int64_t)u * kCxWarps;
      const bool in = su < st1;
      step_words<VEC>(in ? lo : nullptr, su * span + off_lo, W, t, a[u]);
      step_words<VEC>(in ? hi : nullptr, su * span + off_hi, W, t, b[u]);
      step_words<VEC>(in ? pl : nullptr, su * span + off_pl, W, t, p[u]);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        mma_and_popc(c, a[u][m], b[u][m], a[u][4 + m], b[u][4 + m], p[u][m], p[u][4 + m]);
      }
    }
  }
  __syncthreads();  // the tile is zeroed
  if (c[0] != 0) atomicAdd(&tile[q * 8 + 2 * t], c[0]);
  if (c[1] != 0) atomicAdd(&tile[q * 8 + 2 * t + 1], c[1]);
  if (c[2] != 0) atomicAdd(&tile[(q + 8) * 8 + 2 * t], c[2]);
  if (c[3] != 0) atomicAdd(&tile[(q + 8) * 8 + 2 * t + 1], c[3]);
  __syncthreads();
  if (threadIdx.x < gt * rt) {
    const int gi = threadIdx.x / rt;
    const int rj = threadIdx.x % rt;
    int v = 0;
    for (int k = 0; k < P; ++k) v += tile[(k * gt + gi) * 8 + k * rt + rj];
    const int64_t g = g0 + gi;
    const int64_t r = r0 + rj;
    if (v != 0 && g < G && r < R) atomicAdd(out + g * oa + r * ob + s, (unsigned int)v);
  }
}

// The b1 tensor-core rate probe (b1_probe.py): every warp runs `iters`
// rounds of kProbeChains independent m16n8k256 and.popc mma's on register
// words, and one lane stores the sums so none is dead code.
constexpr int kProbeChains = 8;

__global__ void b1_mma_probe_kernel(int64_t iters, int* __restrict__ sink) {
  uint32_t x = 0x9e3779b9u * (threadIdx.x + 1) + blockIdx.x;
  int c[kProbeChains][4] = {};
  for (int64_t i = 0; i < iters; ++i) {
#pragma unroll
    for (int k = 0; k < kProbeChains; ++k) {
      mma_and_popc(c[k], x, x ^ (uint32_t)k, x + (uint32_t)k, ~x, x * 3u, x >> 1);
    }
    x ^= x << 13;
  }
  int sum = 0;
#pragma unroll
  for (int k = 0; k < kProbeChains; ++k) sum += c[k][0] + c[k][1] + c[k][2] + c[k][3];
  if (sum == 0x7fffffff) sink[blockIdx.x] = sum;
}

// Store this thread's WPT words of the tile starting at word `base` of a
// W-word row, in tile_words' layout; words past the row's end are dropped.
template <int WPT, int VEC>
__device__ __forceinline__ void tile_store(uint32_t* __restrict__ row, int64_t base, int64_t W,
                                           const uint32_t (&v)[WPT]) {
  if constexpr (VEC) {
    uint4* row4 = reinterpret_cast<uint4*>(row);
    const int64_t w4 = W / 4;
#pragma unroll
    for (int k = 0; k < WPT / 4; ++k) {
      const int64_t q = base / 4 + (int64_t)k * kThreads + threadIdx.x;
      if (q < w4) row4[q] = make_uint4(v[4 * k], v[4 * k + 1], v[4 * k + 2], v[4 * k + 3]);
    }
  } else {
#pragma unroll
    for (int k = 0; k < WPT; ++k) {
      const int64_t i = base + (int64_t)k * kThreads + threadIdx.x;
      if (i < W) row[i] = v[k];
    }
  }
}

// gather_and: outputs a block writes in turn, and words per thread
constexpr int kGaOuts = 16;
constexpr int kGaWords = 16;

// out[i] = a[ia[i]] & b[ib[i]] over slabs of `len` words. Block x covers
// word tile x / chunks (kThreads * kGaWords words) of the kGaOuts outputs
// of chunk x % chunks, in order. An operand whose index repeats the
// previous output's stays in registers, so a filter broadcast, or a run of
// pairs with one prefix, reads that operand once per tile and chunk; the
// chunks of one tile are neighbouring blocks, so an operand repeated
// across chunks (the plane rows of a cross expansion) comes again from L2.
template <int VEC>
__global__ void __launch_bounds__(kThreads)
gather_and_kernel(const uint32_t* __restrict__ a, const int32_t* __restrict__ ia,
                  const uint32_t* __restrict__ b, const int32_t* __restrict__ ib, int64_t n,
                  int64_t len, int64_t chunks, uint32_t* __restrict__ out) {
  const int64_t chunk = blockIdx.x % chunks;
  const int64_t base = (blockIdx.x / chunks) * (int64_t)(kThreads * kGaWords);
  const int64_t end = (chunk + 1) * kGaOuts < n ? (chunk + 1) * kGaOuts : n;
  uint32_t x[kGaWords], y[kGaWords], o[kGaWords];
  int32_t ja = -1, jb = -1;
  for (int64_t i = chunk * kGaOuts; i < end; ++i) {
    const int32_t na = __ldg(ia + i);
    const int32_t nb = __ldg(ib + i);
    if (na != ja) {
      tile_words<kGaWords, VEC>(a + (int64_t)na * len, base, len, x);
      ja = na;
    }
    if (nb != jb) {
      tile_words<kGaWords, VEC>(b + (int64_t)nb * len, base, len, y);
      jb = nb;
    }
#pragma unroll
    for (int k = 0; k < kGaWords; ++k) o[k] = x[k] & y[k];
    tile_store<kGaWords, VEC>(out + i * len, base, len, o);
  }
}

}  // namespace

// acc[g, s, w] x planes[r, s, w] -> out int32[g, r, s] (zeroed here), on
// the tensor cores. vec: w % 4 == 0 and both stacks 16-byte aligned.
PT_EXPORT int pt_counts_cross(const void* acc, int64_t g, const void* planes, int64_t r,
                              int64_t s, int64_t w, int vec, void* out, void* stream) {
  if (g < 1 || r < 1 || s < 1 || w < 1 || (vec && w % 4 != 0)) return (int)cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  const cudaError_t err = cudaMemsetAsync(out, 0, (size_t)(g * r * s) * sizeof(int32_t), st);
  if (err != cudaSuccess) return (int)err;
  // one 16 x 8 tile of the product per grid row, or P word ranges packed
  // into one tile when the product is narrower, the prefixes on the tile's
  // rows or, where that packs more, on its columns; a shard's words split
  // among blocks until the grid has about kCxBlocks of them, each split
  // keeping at least one round of kCxUnroll steps for every warp
  auto* x = static_cast<const uint32_t*>(acc);
  auto* p = static_cast<const uint32_t*>(planes);
  auto* o = static_cast<unsigned int*>(out);
  const int pack = g <= 16 && r <= 8 ? (int)(16 / g < 8 / r ? 16 / g : 8 / r) : 1;
  const int swapped = r <= 16 && g <= 8 ? (int)(16 / r < 8 / g ? 16 / r : 8 / g) : 1;
  int64_t oa = r * s, ob = s;
  int P = pack;
  if (swapped > pack) {
    std::swap(x, p);
    std::swap(g, r);
    std::swap(oa, ob);
    P = swapped;
  }
  const int64_t tiles = ((g + 15) / 16) * ((r + 7) / 8);
  const int64_t steps = (w + kCxStep * P - 1) / (kCxStep * P);
  int64_t splits = (kCxBlocks + s * tiles - 1) / (s * tiles);
  const int64_t most = steps / (kCxWarps * kCxUnroll);
  splits = splits < most ? splits : (most > 1 ? most : 1);
  const int64_t per = (steps + splits - 1) / splits;
  splits = (steps + per - 1) / per;
  if (s * splits > INT32_MAX || tiles > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned int)(s * splits), (unsigned int)tiles);
  const int64_t n_tiles = (r + 7) / 8;
  if (vec) {
    counts_cross_kernel<1><<<grid, kCxThreads, 0, st>>>(x, p, g, r, s, w, P, splits, per, n_tiles, oa, ob, o);
  } else {
    counts_cross_kernel<0><<<grid, kCxThreads, 0, st>>>(x, p, g, r, s, w, P, splits, per, n_tiles, oa, ob, o);
  }
  return (int)cudaGetLastError();
}

// The b1 mma probe: `blocks` blocks of kCxThreads threads, each warp
// running iters * kProbeChains mma's; `sink` holds `blocks` ints.
PT_EXPORT int pt_b1_mma_probe(int64_t blocks, int64_t iters, void* sink, void* stream) {
  if (blocks < 1 || blocks > INT32_MAX || iters < 1) return (int)cudaErrorInvalidValue;
  b1_mma_probe_kernel<<<(unsigned int)blocks, kCxThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      iters, static_cast<int*>(sink));
  return (int)cudaGetLastError();
}

// out[i] = a[ia[i]] & b[ib[i]] for i < n, each a slab of `len` words; ia
// and ib (int32, on the card) index within a and b (checked by the caller).
// vec: len % 4 == 0 and a, b and out 16-byte aligned.
PT_EXPORT int pt_gather_and(const void* a, const void* ia, const void* b, const void* ib,
                            int64_t n, int64_t len, int vec, void* out, void* stream) {
  if (n < 1 || len < 1 || (vec && len % 4 != 0)) return (int)cudaErrorInvalidValue;
  const int64_t chunks = (n + kGaOuts - 1) / kGaOuts;
  const int64_t tiles = (len + kThreads * kGaWords - 1) / (kThreads * kGaWords);
  if (chunks * tiles > INT32_MAX) return (int)cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  auto* x = static_cast<const uint32_t*>(a);
  auto* y = static_cast<const uint32_t*>(b);
  auto* jx = static_cast<const int32_t*>(ia);
  auto* jy = static_cast<const int32_t*>(ib);
  auto* o = static_cast<uint32_t*>(out);
  const unsigned int grid = (unsigned int)(chunks * tiles);
  if (vec) {
    gather_and_kernel<1><<<grid, kThreads, 0, st>>>(x, jx, y, jy, n, len, chunks, o);
  } else {
    gather_and_kernel<0><<<grid, kThreads, 0, st>>>(x, jx, y, jy, n, len, chunks, o);
  }
  return (int)cudaGetLastError();
}

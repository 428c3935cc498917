// Hand-written Hopper (sm_90a) kernels for the port's query path.
//
// Words are 32-bit little-endian bitmap words (bit b of word w = in-shard
// column 32w + b). PyTorch holds them as int32; the kernels read them as
// uint32. Every kernel here is a popcount reduction that reads each input
// word once, so all four are bound by device-memory bytes, not operations:
// loads are 128-bit (uint4) where the pointers and the row width allow it,
// popcount is one __popc per word, and partial sums stay in registers and
// shared memory (nothing intermediate is written to device memory).
//
// Kernels and what they replace:
//   count2_kernel      pilosa_tpu/ops/pallas_kernels.py _count2 / popcount
//   rows_counts_kernel pilosa_tpu/ops/pallas_kernels.py _rows_counts
//   plan_count_kernel  pilosa_tpu/exec/plan.py _eval_jit/_eval_multi_jit +
//                      _root_out ("count" mode), an XLA program
//   gather_tally_kernel pilosa_tpu/ops/bitmap.py gather_tally_sorted, an
//                      XLA program
//
// Each C entry point launches on the caller's stream, does not synchronise,
// allocates nothing, and returns cudaGetLastError() as an int.

#include <cuda_runtime.h>
#include <stdint.h>

#define PT_EXPORT extern "C" __attribute__((visibility("default")))

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// resident blocks for grid-stride kernels: 132 SMs x 16
constexpr int kMaxGrid = 132 * 16;

enum Op : int { OP_NONE = 0, OP_AND = 1, OP_OR = 2, OP_XOR = 3, OP_ANDNOT = 4 };

template <int OP>
__device__ __forceinline__ uint32_t apply(uint32_t a, uint32_t b) {
  if constexpr (OP == OP_AND) return a & b;
  if constexpr (OP == OP_OR) return a | b;
  if constexpr (OP == OP_XOR) return a ^ b;
  if constexpr (OP == OP_ANDNOT) return a & ~b;
  return a;
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

// Sum of popcount(a op b) over n words, wrapping mod 2^32 like the Pallas
// kernel's int32 accumulator. OP_NONE is plain popcount (b unused).
template <int OP>
__global__ void __launch_bounds__(kThreads)
count2_kernel(const uint32_t* __restrict__ a, const uint32_t* __restrict__ b,
              int64_t n, int vec, uint32_t* __restrict__ out) {
  __shared__ uint32_t partial[kWarps];
  const int64_t tid = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const int64_t n4 = vec ? n / 4 : 0;
  uint32_t acc = 0;
  const uint4* a4 = reinterpret_cast<const uint4*>(a);
  const uint4* b4 = reinterpret_cast<const uint4*>(b);
  for (int64_t i = tid; i < n4; i += stride) {
    uint4 x = a4[i];
    if constexpr (OP != OP_NONE) {
      uint4 y = b4[i];
      x.x = apply<OP>(x.x, y.x);
      x.y = apply<OP>(x.y, y.y);
      x.z = apply<OP>(x.z, y.z);
      x.w = apply<OP>(x.w, y.w);
    }
    acc += popc4(x);
  }
  for (int64_t i = n4 * 4 + tid; i < n; i += stride) {
    uint32_t x = a[i];
    if constexpr (OP != OP_NONE) x = apply<OP>(x, b[i]);
    acc += __popc(x);
  }
  acc = block_sum(acc, partial);
  if (threadIdx.x == 0) atomicAdd(out, acc);
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

// Operand stack entries per thread. The compiler orders each n-ary node's
// children deepest first, so a program needs at most floor(log2(leaf
// occurrences)) + 1 entries; 32 covers any program under 2^31 instructions.
constexpr int kMaxStack = 32;

// program instructions: >= 0 pushes that leaf; the rest are below
constexpr int64_t kPushZero = -1;
constexpr int64_t kAnd = -2;
constexpr int64_t kOr = -3;
constexpr int64_t kXor = -4;
constexpr int64_t kAndNot = -5;     // below & ~top
constexpr int64_t kRevAndNot = -6;  // top & ~below

__device__ __forceinline__ uint4 binop(int64_t ins, uint4 a, uint4 b) {
  switch (ins) {
    case kAnd:
      return make_uint4(a.x & b.x, a.y & b.y, a.z & b.z, a.w & b.w);
    case kOr:
      return make_uint4(a.x | b.x, a.y | b.y, a.z | b.z, a.w | b.w);
    case kXor:
      return make_uint4(a.x ^ b.x, a.y ^ b.y, a.z ^ b.z, a.w ^ b.w);
    case kAndNot:
      return make_uint4(a.x & ~b.x, a.y & ~b.y, a.z & ~b.z, a.w & ~b.w);
    default:  // kRevAndNot
      return make_uint4(b.x & ~a.x, b.y & ~a.y, b.z & ~a.z, b.w & ~a.w);
  }
}

// `table` is one device buffer: n_leaves leaf pointers (each an [S, W]
// stack of uint4-aligned words) followed by n_prog instructions; every
// thread reads the same entry at once, so each read is one L1 broadcast.
// Block b works on shard b / bps and adds its partial count into
// out[shard] once. Every thread runs the same program, so there is no
// divergence; the operand stack lives in local memory and no intermediate
// bitmap is written anywhere.
__global__ void __launch_bounds__(kThreads)
plan_count_kernel(const int64_t* __restrict__ table, int64_t n_leaves,
                  int64_t n_prog, int64_t w4, int32_t bps,
                  unsigned long long* __restrict__ out) {
  __shared__ uint32_t partial[kWarps];
  const int64_t* prog = table + n_leaves;
  const int64_t s = blockIdx.x / bps;
  const int64_t part = blockIdx.x % bps;
  const int64_t base = s * w4;
  const int64_t step = (int64_t)bps * blockDim.x;
  uint32_t acc = 0;
  for (int64_t i = part * blockDim.x + threadIdx.x; i < w4; i += step) {
    uint4 st[kMaxStack];
    int sp = 0;
    for (int64_t pc = 0; pc < n_prog; ++pc) {
      const int64_t ins = __ldg(prog + pc);
      if (ins >= 0) {
        st[sp++] = reinterpret_cast<const uint4*>(__ldg(table + ins))[base + i];
      } else if (ins == kPushZero) {
        st[sp++] = make_uint4(0u, 0u, 0u, 0u);
      } else {
        const uint4 rhs = st[--sp];
        st[sp - 1] = binop(ins, st[sp - 1], rhs);
      }
    }
    acc += popc4(st[0]);
  }
  acc = block_sum(acc, partial);
  if (threadIdx.x == 0 && acc != 0u) {
    atomicAdd(out + s, (unsigned long long)acc);
  }
}

// One warp per segment: out[g] = sum over k in [starts[g], ends[g]) of
// popcount(src[idx[k]] & mask[k]). Entries are bounded by 2^27 by the
// caller, so the int32 sum is exact.
__global__ void __launch_bounds__(kThreads)
gather_tally_kernel(const uint32_t* __restrict__ src,
                    const int32_t* __restrict__ idx,
                    const uint32_t* __restrict__ mask,
                    const int32_t* __restrict__ starts,
                    const int32_t* __restrict__ ends, int64_t n_seg,
                    int32_t* __restrict__ out) {
  const int64_t seg = (blockIdx.x * (int64_t)blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (seg >= n_seg) return;  // uniform across the warp
  const int32_t lo = starts[seg];
  const int32_t hi = ends[seg];
  uint32_t acc = 0;
  for (int32_t k = lo + lane; k < hi; k += 32) acc += __popc(src[idx[k]] & mask[k]);
  acc = warp_sum(acc);
  if (lane == 0) out[seg] = (int32_t)acc;
}

int grid_for(int64_t items) {
  int64_t g = (items + kThreads - 1) / kThreads;
  if (g < 1) g = 1;
  if (g > kMaxGrid) g = kMaxGrid;
  return (int)g;
}

}  // namespace

PT_EXPORT int pt_count2(const void* a, const void* b, int64_t n, int op, int vec,
                        void* out, void* stream) {
  const auto* pa = static_cast<const uint32_t*>(a);
  const auto* pb = static_cast<const uint32_t*>(b);
  auto* po = static_cast<uint32_t*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  const int grid = grid_for(vec ? n / 4 : n);
  switch (op) {
    case OP_NONE:
      count2_kernel<OP_NONE><<<grid, kThreads, 0, st>>>(pa, pb, n, vec, po);
      break;
    case OP_AND:
      count2_kernel<OP_AND><<<grid, kThreads, 0, st>>>(pa, pb, n, vec, po);
      break;
    case OP_OR:
      count2_kernel<OP_OR><<<grid, kThreads, 0, st>>>(pa, pb, n, vec, po);
      break;
    case OP_XOR:
      count2_kernel<OP_XOR><<<grid, kThreads, 0, st>>>(pa, pb, n, vec, po);
      break;
    case OP_ANDNOT:
      count2_kernel<OP_ANDNOT><<<grid, kThreads, 0, st>>>(pa, pb, n, vec, po);
      break;
    default:
      return (int)cudaErrorInvalidValue;
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

// `table` (device memory) holds n_leaves leaf pointers then n_prog
// instructions; the caller has checked the program (leaf indices in range,
// stack depth <= kMaxStack, one value left).
PT_EXPORT int pt_plan_count(const void* table, int64_t n_leaves, int64_t n_prog,
                            int64_t shards, int64_t w, void* out, void* stream) {
  if (n_leaves < 1 || n_prog < 1 || w % 4 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const int64_t w4 = w / 4;
  // about four uint4 per thread per pass
  int64_t bps = (w4 + kThreads * 4 - 1) / (kThreads * 4);
  if (bps < 1) bps = 1;
  const int64_t grid = shards * bps;
  if (grid > 0) {
    plan_count_kernel<<<(unsigned int)grid, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int64_t*>(table), n_leaves, n_prog, w4, (int32_t)bps,
        static_cast<unsigned long long*>(out));
  }
  return (int)cudaGetLastError();
}

PT_EXPORT int pt_gather_tally(const void* src, const void* idx, const void* mask,
                              const void* starts, const void* ends,
                              int64_t n_seg, void* out, void* stream) {
  if (n_seg > 0) {
    const int64_t blocks = (n_seg + kWarps - 1) / kWarps;
    gather_tally_kernel<<<(unsigned int)blocks, kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(src), static_cast<const int32_t*>(idx),
        static_cast<const uint32_t*>(mask),
        static_cast<const int32_t*>(starts), static_cast<const int32_t*>(ends),
        n_seg, static_cast<int32_t*>(out));
  }
  return (int)cudaGetLastError();
}

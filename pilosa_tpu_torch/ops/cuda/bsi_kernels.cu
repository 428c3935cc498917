// Hand-written Hopper (sm_90a) kernels for int (BSI) fields.
//
// An int field stores each column's value (minus the field's base) as sign
// + magnitude bit planes: planes[d] holds magnitude bit d of every column,
// `exists` marks columns that hold a value, `sign` the negative ones. All
// operands are 32-bit little-endian bitmap words (PyTorch int32, read here
// as uint32): planes is [D, S, W] (plane stride S * W words), every row
// operand [S, W].
//
// Kernels and what they replace:
//   bsi_sum_kernel        pilosa_tpu/ops/pallas_kernels.py sum_counts
//                         (_bsi_sum_kernel), the fused BSI sum tally; over
//                         one slab it is sum_stream_slab (ops/bsi.py)
//   bsi_min_max_kernel    pilosa_tpu/ops/bsi.py min_max_stream (_vkey_init +
//                         _vkey_ladder + _vkey_reduce) and, over one slab of
//                         planes with carried state, min_max_stream_step
//                         and min_max_stream_finish: XLA programs
//   bsi_range_kernel      pilosa_tpu/ops/bsi.py range_eq/lt/gt/between_unsigned,
//                         XLA programs
//   bsi_range_step_kernel pilosa_tpu/ops/bsi.py range_stream_single,
//                         range_stream_step and range_stream_finish: every
//                         job of a condition over one slab, XLA programs
//
// All of them read every plane word once and do a few bitwise operations and
// at most two popcounts per word, so they are bound by device-memory bytes.
// Each thread loads one word group (four words as a uint4 where the row
// width and the pointers allow it) of the row operands, forms the masks in
// registers and walks the D planes of that group; nothing intermediate is
// written to device memory, except the ladder state that the step kernels
// carry from one slab of planes to the next (read and written once a slab).
// Reductions finish inside the kernels: per-block sums are added once into
// the output with 64-bit atomics (bsi_sum, the range counts), and the
// min/max key is reduced by the last block to finish (an atomic ticket after
// a __threadfence), so the host reads one small result per launch.
//
// Each C entry point launches on the caller's stream, does not synchronise,
// allocates nothing, and returns cudaGetLastError() as an int.

#include <cuda_runtime.h>
#include <stdint.h>

#define PT_EXPORT extern "C" __attribute__((visibility("default")))

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxDepth = 32;

// range ladder kinds and base-mask selectors (mirrored in ops/kernels.py)
enum Kind : int { KIND_EQ = 0, KIND_LT = 1, KIND_GT = 2, KIND_BETWEEN = 3 };
enum Sel : int { SEL_CONSIDER = 0, SEL_POS = 1, SEL_NEG = 2 };

// VEC consecutive words of one operand
template <int VEC>
struct Words {
  uint32_t v[VEC];
};

template <int VEC>
__device__ __forceinline__ Words<VEC> load(const uint32_t* __restrict__ p, int64_t i) {
  Words<VEC> r;
  if constexpr (VEC == 4) {
    const uint4 q = __ldg(reinterpret_cast<const uint4*>(p) + i);
    r.v[0] = q.x;
    r.v[1] = q.y;
    r.v[2] = q.z;
    r.v[3] = q.w;
  } else {
    r.v[0] = __ldg(p + i);
  }
  return r;
}

template <int VEC>
__device__ __forceinline__ void store(uint32_t* __restrict__ p, int64_t i, const Words<VEC>& w) {
  if constexpr (VEC == 4) {
    reinterpret_cast<uint4*>(p)[i] = make_uint4(w.v[0], w.v[1], w.v[2], w.v[3]);
  } else {
    p[i] = w.v[0];
  }
}

__device__ __forceinline__ uint32_t warp_sum(uint32_t v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

// ---------------------------------------------------------------------------
// bsi_sum: consider = exists & filter; out[0] = pc(consider),
// out[1 + d] = pc(plane_d & consider & ~sign), out[1 + D + d] =
// pc(plane_d & consider & sign). Unsigned fields (SIGNED false) read no
// sign row and leave the negative counts at zero.
// ---------------------------------------------------------------------------

// Adds a per-thread count into a shared-memory counter of the block.
__device__ __forceinline__ void block_add(uint32_t v, uint32_t* counter) {
  v = warp_sum(v);
  if ((threadIdx.x & 31) == 0 && v != 0u) atomicAdd(counter, v);
}

// A block walks chunks of kSumItems word groups per thread. Each thread
// keeps its groups' consider and sign words in registers, then walks the
// planes with a runtime loop: per plane it issues its kSumItems loads
// together (unconditional: a group past the end reloads the last one and
// counts nothing), and the block's counters for that plane take one
// shared-memory atomic per warp. Counters stay in shared memory, so the
// registers, and with them the occupancy, do not grow with the depth.
// Each block adds its 1 + 2D counters into `out` once. The caller sizes
// the grid so that no thread walks more than 256 groups: a block's 32-bit
// counters then hold at most 256 x 256 x 128 bits.
constexpr int kSumItems = 4;

template <int VEC, bool SIGNED, bool FILT>
__global__ void __launch_bounds__(kThreads)
bsi_sum_kernel(const uint32_t* __restrict__ planes, const uint32_t* __restrict__ exists,
               const uint32_t* __restrict__ sign, const uint32_t* __restrict__ filt,
               int depth, int64_t items, int64_t n, unsigned long long* __restrict__ out) {
  __shared__ uint32_t counters[1 + 2 * kMaxDepth];
  const int n_out = 1 + (SIGNED ? 2 : 1) * depth;
  for (int c = threadIdx.x; c < n_out; c += blockDim.x) counters[c] = 0u;
  __syncthreads();
  const int64_t chunk = (int64_t)kThreads * kSumItems;
  for (int64_t base = blockIdx.x * chunk; base < items; base += (int64_t)gridDim.x * chunk) {
    int64_t at[kSumItems];
    Words<VEC> cons[kSumItems];
    Words<VEC> sg[kSumItems];
    uint32_t cnt = 0;
#pragma unroll
    for (int k = 0; k < kSumItems; ++k) {
      const int64_t i = base + k * kThreads + threadIdx.x;
      const uint32_t live = i < items ? 0xffffffffu : 0u;
      at[k] = i < items ? i : items - 1;
      cons[k] = load<VEC>(exists, at[k]);
      if constexpr (FILT) {
        const Words<VEC> f = load<VEC>(filt, at[k]);
#pragma unroll
        for (int j = 0; j < VEC; ++j) cons[k].v[j] &= f.v[j];
      }
      if constexpr (SIGNED) sg[k] = load<VEC>(sign, at[k]);
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        cons[k].v[j] &= live;
        cnt += __popc(cons[k].v[j]);
      }
    }
    block_add(cnt, counters);
    for (int d = 0; d < depth; ++d) {
      const uint32_t* plane = planes + d * n;
      Words<VEC> p[kSumItems];
#pragma unroll
      for (int k = 0; k < kSumItems; ++k) p[k] = load<VEC>(plane, at[k]);
      uint32_t pos = 0u, neg = 0u;
#pragma unroll
      for (int k = 0; k < kSumItems; ++k) {
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          const uint32_t x = p[k].v[j] & cons[k].v[j];
          if constexpr (SIGNED) {
            pos += __popc(x & ~sg[k].v[j]);
            neg += __popc(x & sg[k].v[j]);
          } else {
            pos += __popc(x);
          }
        }
      }
      block_add(pos, counters + 1 + d);
      if constexpr (SIGNED) block_add(neg, counters + 1 + depth + d);
    }
  }
  __syncthreads();
  for (int c = threadIdx.x; c < n_out; c += blockDim.x) {
    if (counters[c] != 0u) atomicAdd(out + c, (unsigned long long)counters[c]);
  }
}

// ---------------------------------------------------------------------------
// bsi_min_max: the word-local virtual-key ladder. Within each word the
// ladder narrows fa to the columns holding the word's largest key and
// builds that key in va, MSB first: for a signed field the first key bit
// is the sign step (for Min a negative value outranks every positive one),
// then one bit per magnitude plane, with the plane complemented where a
// smaller magnitude must rank higher. max(key) over all words is the
// answer; the count is the sum of popcount(fa) over the words at that key.
// out = [best key, any, count], decoded on the host.
//
// One launch walks one slab of planes. `first` builds fa and va from the
// mask (exists & filter) and the sign step; otherwise they are read from
// the state the previous slab wrote. `last` reduces them to `out`;
// otherwise they are written back in place. first && last is the whole
// field in one launch. fa is nonzero exactly where the mask is (the ladder
// narrows it only to a non-empty subset), so the reduce needs no mask.
// va_state is uint64 where the key has over 32 bits (WIDE), else uint32.
// ---------------------------------------------------------------------------

// (best, count) over the block: the largest best, and the sum of the
// counts of the threads that hold it. The result is valid in thread 0.
__device__ __forceinline__ void block_best(long long& best, unsigned long long& cnt,
                                           long long* s_best, unsigned long long* s_cnt) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  long long wb = best;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const long long other = __shfl_xor_sync(0xffffffffu, wb, o);
    wb = other > wb ? other : wb;
  }
  unsigned long long wc = best == wb ? cnt : 0ull;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) wc += __shfl_xor_sync(0xffffffffu, wc, o);
  if (lane == 0) {
    s_best[warp] = wb;
    s_cnt[warp] = wc;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    long long b = s_best[0];
    for (int w = 1; w < kWarps; ++w) b = s_best[w] > b ? s_best[w] : b;
    unsigned long long c = 0;
    for (int w = 0; w < kWarps; ++w) c += s_best[w] == b ? s_cnt[w] : 0ull;
    best = b;
    cnt = c;
  }
  __syncthreads();
}

template <int VEC>
__device__ __forceinline__ void load_keys(const void* __restrict__ p, int64_t i, bool wide,
                                          unsigned long long (&va)[VEC]) {
  if (wide) {
    const auto* q = static_cast<const unsigned long long*>(p);
    if constexpr (VEC == 4) {
      const ulonglong2 a = __ldg(reinterpret_cast<const ulonglong2*>(q) + 2 * i);
      const ulonglong2 b = __ldg(reinterpret_cast<const ulonglong2*>(q) + 2 * i + 1);
      va[0] = a.x;
      va[1] = a.y;
      va[2] = b.x;
      va[3] = b.y;
    } else {
      va[0] = __ldg(q + i);
    }
  } else {
    const Words<VEC> w = load<VEC>(static_cast<const uint32_t*>(p), i);
#pragma unroll
    for (int j = 0; j < VEC; ++j) va[j] = w.v[j];
  }
}

template <int VEC>
__device__ __forceinline__ void store_keys(void* __restrict__ p, int64_t i, bool wide,
                                           const unsigned long long (&va)[VEC]) {
  if (wide) {
    auto* q = static_cast<unsigned long long*>(p);
    if constexpr (VEC == 4) {
      reinterpret_cast<ulonglong2*>(q)[2 * i] = make_ulonglong2(va[0], va[1]);
      reinterpret_cast<ulonglong2*>(q)[2 * i + 1] = make_ulonglong2(va[2], va[3]);
    } else {
      q[i] = va[0];
    }
  } else {
    Words<VEC> w;
#pragma unroll
    for (int j = 0; j < VEC; ++j) w.v[j] = (uint32_t)va[j];
    store<VEC>(static_cast<uint32_t*>(p), i, w);
  }
}

template <int VEC, bool SIGNED, bool FILT>
__global__ void __launch_bounds__(kThreads)
bsi_min_max_kernel(const uint32_t* __restrict__ planes, const uint32_t* __restrict__ exists,
                   const uint32_t* __restrict__ sign, const uint32_t* __restrict__ filt,
                   int depth, int64_t items, int64_t n, int is_min, int first, int last,
                   uint32_t* __restrict__ fa_state, void* __restrict__ va_state, int wide,
                   long long* __restrict__ partials, unsigned int* __restrict__ ticket,
                   long long* __restrict__ out) {
  __shared__ long long s_best[kWarps];
  __shared__ unsigned long long s_cnt[kWarps];
  __shared__ bool s_last;
  long long best = -1;  // no considered column seen yet
  unsigned long long cnt = 0;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < items; i += stride) {
    Words<VEC> fa;
    Words<VEC> tx;  // per-column key transform of the magnitude planes
    unsigned long long va[VEC];
    Words<VEC> sg{};
    if constexpr (SIGNED) sg = load<VEC>(sign, i);
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      if constexpr (SIGNED) {
        tx.v[j] = is_min ? ~sg.v[j] : sg.v[j];
      } else {
        tx.v[j] = is_min ? 0xffffffffu : 0u;
      }
    }
    if (first) {
      fa = load<VEC>(exists, i);
      if constexpr (FILT) {
        const Words<VEC> f = load<VEC>(filt, i);
#pragma unroll
        for (int j = 0; j < VEC; ++j) fa.v[j] &= f.v[j];
      }
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        va[j] = 0ull;
        if constexpr (SIGNED) {
          const uint32_t top = fa.v[j] & (is_min ? sg.v[j] : ~sg.v[j]);
          if (top != 0u) {
            fa.v[j] = top;
            va[j] = 1ull;
          }
        }
      }
    } else {
      fa = load<VEC>(fa_state, i);
      load_keys<VEC>(va_state, i, wide != 0, va);
    }
    for (int k = depth - 1; k >= 0; --k) {
      const Words<VEC> p = load<VEC>(planes + k * n, i);
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        const uint32_t ra = fa.v[j] & (p.v[j] ^ tx.v[j]);
        const bool nz = ra != 0u;
        if (nz) fa.v[j] = ra;
        va[j] = (va[j] << 1) | (nz ? 1ull : 0ull);
      }
    }
    if (!last) {
      store<VEC>(fa_state, i, fa);
      store_keys<VEC>(va_state, i, wide != 0, va);
      continue;
    }
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      if (fa.v[j] != 0u) {
        const long long key = (long long)va[j];
        const unsigned long long c = __popc(fa.v[j]);
        if (key > best) {
          best = key;
          cnt = c;
        } else if (key == best) {
          cnt += c;
        }
      }
    }
  }
  if (!last) return;
  block_best(best, cnt, s_best, s_cnt);
  if (threadIdx.x == 0) {
    partials[2 * blockIdx.x] = best;
    partials[2 * blockIdx.x + 1] = (long long)cnt;
    __threadfence();
    s_last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!s_last) return;
  // the last block to finish reduces every block's partial
  __threadfence();
  best = -1;
  cnt = 0;
  for (unsigned int g = threadIdx.x; g < gridDim.x; g += blockDim.x) {
    const long long b = __ldcg(partials + 2 * g);
    const unsigned long long c = (unsigned long long)__ldcg(partials + 2 * g + 1);
    if (b > best) {
      best = b;
      cnt = c;
    } else if (b == best) {
      cnt += c;
    }
  }
  block_best(best, cnt, s_best, s_cnt);
  if (threadIdx.x == 0) {
    out[0] = best < 0 ? 0 : best;
    out[1] = best < 0 ? 0 : 1;
    out[2] = best < 0 ? 0 : (long long)cnt;
  }
}

// ---------------------------------------------------------------------------
// bsi_range: the predicate ladders of range_eq/lt/gt/between_unsigned over
// magnitudes, from the top plane down, starting from the base mask `m`
// (base, base & ~sign or base & sign). Predicates are uniform across the
// launch, so every branch on a predicate bit is uniform too. Rows mode
// writes the result words; count mode adds per-shard popcounts.
// ---------------------------------------------------------------------------

// One plane (absolute index i; b0, b1 its bits of p0, p1) of a ladder on
// VEC words: range_eq/lt/gt/between_unsigned's loop body. `lz` is the lt
// ladder's leading-zeros flag (the predicate's bits above i all zero).
template <int VEC, int KIND>
__device__ __forceinline__ void ladder_plane(const Words<VEC>& p, int i, bool b0, bool b1,
                                             bool allow_eq, bool& lz, Words<VEC>& f,
                                             Words<VEC>& keep, Words<VEC>& keep2) {
  if constexpr (KIND == KIND_EQ) {
#pragma unroll
    for (int j = 0; j < VEC; ++j) f.v[j] = b0 ? (f.v[j] & p.v[j]) : (f.v[j] & ~p.v[j]);
  } else if constexpr (KIND == KIND_LT) {
    const bool in_lz_skip = lz && !b0;
    lz = in_lz_skip;
    if (i == 0 && !allow_eq) {
      // strict final: bit 0 keeps only kept columns (so `< 0` is empty);
      // bit 1 removes the columns equal to the predicate
#pragma unroll
      for (int j = 0; j < VEC; ++j) f.v[j] = !b0 ? keep.v[j] : (f.v[j] & ~(p.v[j] & ~keep.v[j]));
      return;
    }
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      if (in_lz_skip) {
        f.v[j] &= ~p.v[j];
      } else if (!b0) {
        f.v[j] &= ~(p.v[j] & ~keep.v[j]);
      } else if (i > 0) {
        keep.v[j] |= f.v[j] & ~p.v[j];
      }
    }
  } else if constexpr (KIND == KIND_GT) {
    if (i == 0 && !allow_eq) {
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        f.v[j] = b0 ? keep.v[j] : (f.v[j] & ~((f.v[j] & ~p.v[j]) & ~keep.v[j]));
      }
      return;
    }
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      if (b0) {
        f.v[j] &= ~((f.v[j] & ~p.v[j]) & ~keep.v[j]);
      } else if (i > 0) {
        keep.v[j] |= f.v[j] & p.v[j];
      }
    }
  } else {  // KIND_BETWEEN: >= p0 and <= p1 in one pass
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      if (b0) {
        f.v[j] &= ~((f.v[j] & ~p.v[j]) & ~keep.v[j]);
      } else if (i > 0) {
        keep.v[j] |= f.v[j] & p.v[j];
      }
      if (!b1) {
        f.v[j] &= ~(p.v[j] & ~keep2.v[j]);
      } else if (i > 0) {
        keep2.v[j] |= f.v[j] & ~p.v[j];
      }
    }
  }
}

template <int VEC, int KIND>
__device__ __forceinline__ Words<VEC> ladder(const uint32_t* __restrict__ planes, int64_t n,
                                             int64_t g, Words<VEC> f, int depth, uint32_t p0,
                                             uint32_t p1, bool allow_eq) {
  Words<VEC> keep, keep2;
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    keep.v[j] = 0u;
    keep2.v[j] = 0u;
  }
  bool lz = true;  // lt: still in the predicate's leading zeros
  for (int i = depth - 1; i >= 0; --i) {
    const Words<VEC> p = load<VEC>(planes + i * n, g);
    ladder_plane<VEC, KIND>(p, i, (p0 >> i) & 1u, (p1 >> i) & 1u, allow_eq, lz, f, keep, keep2);
  }
  return f;
}

// Block b works on shard b / bps (its part b % bps of the shard's items).
template <int VEC, int KIND, bool COUNT>
__global__ void __launch_bounds__(kThreads)
bsi_range_kernel(const uint32_t* __restrict__ planes, const uint32_t* __restrict__ base,
                 const uint32_t* __restrict__ sign, int sel, int depth, int64_t w_items,
                 int64_t n, uint32_t p0, uint32_t p1, int allow_eq, int32_t bps,
                 uint32_t* __restrict__ rows_out, unsigned long long* __restrict__ counts_out) {
  __shared__ uint32_t partial[kWarps];
  const int64_t s = blockIdx.x / bps;
  const int64_t part = blockIdx.x % bps;
  const int64_t step = (int64_t)bps * blockDim.x;
  uint32_t acc = 0;
  for (int64_t i = part * blockDim.x + threadIdx.x; i < w_items; i += step) {
    const int64_t g = s * w_items + i;
    Words<VEC> m = load<VEC>(base, g);
    if (sel != SEL_CONSIDER) {
      const Words<VEC> sg = load<VEC>(sign, g);
#pragma unroll
      for (int j = 0; j < VEC; ++j) m.v[j] &= sel == SEL_POS ? ~sg.v[j] : sg.v[j];
    }
    const Words<VEC> r = ladder<VEC, KIND>(planes, n, g, m, depth, p0, p1, allow_eq != 0);
    if constexpr (COUNT) {
#pragma unroll
      for (int j = 0; j < VEC; ++j) acc += __popc(r.v[j]);
    } else {
      store<VEC>(rows_out, g, r);
    }
  }
  if constexpr (COUNT) {
    acc = warp_sum(acc);
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    if (lane == 0) partial[warp] = acc;
    __syncthreads();
    if (threadIdx.x == 0) {
      unsigned long long total = 0;
      for (int w = 0; w < kWarps; ++w) total += partial[w];
      if (total != 0ull) atomicAdd(counts_out + s, total);
    }
  }
}

// ---------------------------------------------------------------------------
// bsi_range_step: every job of a condition's decomposition (at most two:
// _decompose in exec/bsistream.py) advanced over one slab of d planes,
// absolute planes [lo, lo + d), MSB first, each plane word read once for
// all jobs. A job's state is its result words, then its keeps
// (RANGE_STATE_ROWS in ops/bsi.py), rows of `state` from `row`. `first`
// builds each job's starting mask from exists and sign; otherwise the state
// is read. `last` counts each job's result and each extra mask (exists,
// exists & ~sign or exists & sign) into `out`; otherwise the state is
// written back in place. The lt leading-zeros flag on entering the slab
// comes from the host (it depends only on the predicate's bits).
// ---------------------------------------------------------------------------

constexpr int kMaxJobs = 2;
constexpr int kMaxExtras = 3;

struct RangeJobs {
  int n_jobs;
  int n_extras;
  int kind[kMaxJobs];
  int sel[kMaxJobs];
  int allow_eq[kMaxJobs];
  int lz[kMaxJobs];
  int row[kMaxJobs];
  uint32_t p0[kMaxJobs];
  uint32_t p1[kMaxJobs];
  int extra_sel[kMaxExtras];
};

template <int VEC>
__device__ __forceinline__ Words<VEC> sel_mask(int sel, const Words<VEC>& ex, const Words<VEC>& sg) {
  Words<VEC> m = ex;
  if (sel != SEL_CONSIDER) {
#pragma unroll
    for (int j = 0; j < VEC; ++j) m.v[j] &= sel == SEL_POS ? ~sg.v[j] : sg.v[j];
  }
  return m;
}

template <int VEC>
__device__ __forceinline__ uint32_t popc_words(const Words<VEC>& w) {
  uint32_t c = 0;
#pragma unroll
  for (int j = 0; j < VEC; ++j) c += __popc(w.v[j]);
  return c;
}

template <int VEC>
__global__ void __launch_bounds__(kThreads)
bsi_range_step_kernel(const uint32_t* __restrict__ planes, const uint32_t* __restrict__ exists,
                      const uint32_t* __restrict__ sign, uint32_t* __restrict__ state,
                      const RangeJobs jobs, int d, int lo, int first, int last, int64_t items,
                      int64_t n, unsigned long long* __restrict__ out) {
  __shared__ uint32_t counters[kMaxJobs + kMaxExtras];
  const int n_out = jobs.n_jobs + jobs.n_extras;
  if (last) {
    for (int c = threadIdx.x; c < n_out; c += blockDim.x) counters[c] = 0u;
    __syncthreads();
  }
  // per-thread counts: each job's result, each extra mask (kept apart so
  // that every index is a constant after unrolling: registers, no stack)
  uint32_t jcnt[kMaxJobs], ecnt[kMaxExtras];
#pragma unroll
  for (int t = 0; t < kMaxJobs; ++t) jcnt[t] = 0u;
#pragma unroll
  for (int e = 0; e < kMaxExtras; ++e) ecnt[e] = 0u;
  const bool rows = first || (last && jobs.n_extras > 0);
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < items; i += stride) {
    Words<VEC> ex{}, sg{};
    if (rows) {
      ex = load<VEC>(exists, i);
      if (sign != nullptr) sg = load<VEC>(sign, i);
    }
    Words<VEC> f[kMaxJobs], keep[kMaxJobs], keep2[kMaxJobs];
    bool lz[kMaxJobs];
#pragma unroll
    for (int t = 0; t < kMaxJobs; ++t) {
      lz[t] = jobs.lz[t] != 0;
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        f[t].v[j] = 0u;
        keep[t].v[j] = 0u;
        keep2[t].v[j] = 0u;
      }
      if (t >= jobs.n_jobs) continue;
      const int kind = jobs.kind[t];
      if (first) {
        f[t] = sel_mask<VEC>(jobs.sel[t], ex, sg);
      } else {
        const uint32_t* st = state + jobs.row[t] * n;
        f[t] = load<VEC>(st, i);
        if (kind != KIND_EQ) keep[t] = load<VEC>(st + n, i);
        if (kind == KIND_BETWEEN) keep2[t] = load<VEC>(st + 2 * n, i);
      }
    }
    for (int k = d - 1; k >= 0; --k) {
      const Words<VEC> p = load<VEC>(planes + k * n, i);
      const int a = lo + k;
#pragma unroll
      for (int t = 0; t < kMaxJobs; ++t) {
        if (t >= jobs.n_jobs) continue;
        const bool b0 = (jobs.p0[t] >> a) & 1u;
        const bool b1 = (jobs.p1[t] >> a) & 1u;
        const bool ae = jobs.allow_eq[t] != 0;
        switch (jobs.kind[t]) {
          case KIND_EQ:
            ladder_plane<VEC, KIND_EQ>(p, a, b0, b1, ae, lz[t], f[t], keep[t], keep2[t]);
            break;
          case KIND_LT:
            ladder_plane<VEC, KIND_LT>(p, a, b0, b1, ae, lz[t], f[t], keep[t], keep2[t]);
            break;
          case KIND_GT:
            ladder_plane<VEC, KIND_GT>(p, a, b0, b1, ae, lz[t], f[t], keep[t], keep2[t]);
            break;
          default:
            ladder_plane<VEC, KIND_BETWEEN>(p, a, b0, b1, ae, lz[t], f[t], keep[t], keep2[t]);
            break;
        }
      }
    }
#pragma unroll
    for (int t = 0; t < kMaxJobs; ++t) {
      if (t >= jobs.n_jobs) continue;
      if (last) {
        jcnt[t] += popc_words<VEC>(f[t]);
        continue;
      }
      uint32_t* st = state + jobs.row[t] * n;
      store<VEC>(st, i, f[t]);
      if (jobs.kind[t] != KIND_EQ) store<VEC>(st + n, i, keep[t]);
      if (jobs.kind[t] == KIND_BETWEEN) store<VEC>(st + 2 * n, i, keep2[t]);
    }
    if (last) {
#pragma unroll
      for (int e = 0; e < kMaxExtras; ++e) {
        if (e < jobs.n_extras) ecnt[e] += popc_words<VEC>(sel_mask<VEC>(jobs.extra_sel[e], ex, sg));
      }
    }
  }
  if (!last) return;
#pragma unroll
  for (int t = 0; t < kMaxJobs; ++t) {
    if (t < jobs.n_jobs) block_add(jcnt[t], counters + t);
  }
#pragma unroll
  for (int e = 0; e < kMaxExtras; ++e) {
    if (e < jobs.n_extras) block_add(ecnt[e], counters + jobs.n_jobs + e);
  }
  __syncthreads();
  for (int c = threadIdx.x; c < n_out; c += blockDim.x) {
    if (counters[c] != 0u) atomicAdd(out + c, (unsigned long long)counters[c]);
  }
}

template <int VEC, int KIND>
void launch_range(int grid, cudaStream_t st, const uint32_t* planes, const uint32_t* base,
                  const uint32_t* sign, int sel, int depth, int64_t w_items, int64_t n,
                  uint32_t p0, uint32_t p1, int allow_eq, int32_t bps, int count,
                  void* out) {
  if (count) {
    bsi_range_kernel<VEC, KIND, true><<<grid, kThreads, 0, st>>>(
        planes, base, sign, sel, depth, w_items, n, p0, p1, allow_eq, bps, nullptr,
        static_cast<unsigned long long*>(out));
  } else {
    bsi_range_kernel<VEC, KIND, false><<<grid, kThreads, 0, st>>>(
        planes, base, sign, sel, depth, w_items, n, p0, p1, allow_eq, bps,
        static_cast<uint32_t*>(out), nullptr);
  }
}

template <int VEC>
int dispatch_range(int grid, cudaStream_t st, const uint32_t* planes, const uint32_t* base,
                   const uint32_t* sign, int sel, int kind, int depth, int64_t w_items,
                   int64_t n, uint32_t p0, uint32_t p1, int allow_eq, int32_t bps, int count,
                   void* out) {
  switch (kind) {
    case KIND_EQ:
      launch_range<VEC, KIND_EQ>(grid, st, planes, base, sign, sel, depth, w_items, n, p0, p1,
                                 allow_eq, bps, count, out);
      break;
    case KIND_LT:
      launch_range<VEC, KIND_LT>(grid, st, planes, base, sign, sel, depth, w_items, n, p0, p1,
                                 allow_eq, bps, count, out);
      break;
    case KIND_GT:
      launch_range<VEC, KIND_GT>(grid, st, planes, base, sign, sel, depth, w_items, n, p0, p1,
                                 allow_eq, bps, count, out);
      break;
    case KIND_BETWEEN:
      launch_range<VEC, KIND_BETWEEN>(grid, st, planes, base, sign, sel, depth, w_items, n, p0,
                                      p1, allow_eq, bps, count, out);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return 0;
}

template <int VEC>
void dispatch_min_max(int grid, cudaStream_t st, const uint32_t* planes, const uint32_t* exists,
                      const uint32_t* sign, const uint32_t* filt, int depth, int64_t items,
                      int64_t n, int is_min, int first, int last, uint32_t* fa, void* va,
                      int wide, long long* partials, unsigned int* ticket, long long* out) {
  if (sign != nullptr) {
    if (filt != nullptr) {
      bsi_min_max_kernel<VEC, true, true><<<grid, kThreads, 0, st>>>(
          planes, exists, sign, filt, depth, items, n, is_min, first, last, fa, va, wide,
          partials, ticket, out);
    } else {
      bsi_min_max_kernel<VEC, true, false><<<grid, kThreads, 0, st>>>(
          planes, exists, sign, filt, depth, items, n, is_min, first, last, fa, va, wide,
          partials, ticket, out);
    }
  } else if (filt != nullptr) {
    bsi_min_max_kernel<VEC, false, true><<<grid, kThreads, 0, st>>>(
        planes, exists, sign, filt, depth, items, n, is_min, first, last, fa, va, wide, partials,
        ticket, out);
  } else {
    bsi_min_max_kernel<VEC, false, false><<<grid, kThreads, 0, st>>>(
        planes, exists, sign, filt, depth, items, n, is_min, first, last, fa, va, wide, partials,
        ticket, out);
  }
}

template <int VEC>
void dispatch_sum(int grid, cudaStream_t st, const uint32_t* planes, const uint32_t* exists,
                  const uint32_t* sign, const uint32_t* filt, int depth, int64_t items,
                  int64_t n, unsigned long long* out) {
  if (sign != nullptr) {
    if (filt != nullptr) {
      bsi_sum_kernel<VEC, true, true><<<grid, kThreads, 0, st>>>(planes, exists, sign, filt,
                                                                 depth, items, n, out);
    } else {
      bsi_sum_kernel<VEC, true, false><<<grid, kThreads, 0, st>>>(planes, exists, sign, filt,
                                                                  depth, items, n, out);
    }
  } else if (filt != nullptr) {
    bsi_sum_kernel<VEC, false, true><<<grid, kThreads, 0, st>>>(planes, exists, sign, filt,
                                                                depth, items, n, out);
  } else {
    bsi_sum_kernel<VEC, false, false><<<grid, kThreads, 0, st>>>(planes, exists, sign, filt,
                                                                 depth, items, n, out);
  }
}

}  // namespace

// n words per plane (S * W); vec: n % 4 == 0 and every pointer 16-byte
// aligned; `grid` blocks of 256 threads walk the n / (vec ? 4 : 1) items,
// at most 256 items per thread (the bound of the block counters).
// `out` is int64[1 + 2 * depth], zeroed by the caller.
PT_EXPORT int pt_bsi_sum(const void* planes, const void* exists, const void* sign,
                         const void* filt, int depth, int64_t n, int vec, int grid, void* out,
                         void* stream) {
  if (depth < 1 || depth > kMaxDepth || grid < 1) return (int)cudaErrorInvalidValue;
  const int64_t items = vec ? n / 4 : n;
  if ((items + (int64_t)grid * kThreads - 1) / ((int64_t)grid * kThreads) > 256) {
    return (int)cudaErrorInvalidValue;
  }
  const auto* pp = static_cast<const uint32_t*>(planes);
  const auto* pe = static_cast<const uint32_t*>(exists);
  const auto* ps = static_cast<const uint32_t*>(sign);
  const auto* pf = static_cast<const uint32_t*>(filt);
  auto* po = static_cast<unsigned long long*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  if (vec) {
    dispatch_sum<4>(grid, st, pp, pe, ps, pf, depth, n / 4, n, po);
  } else {
    dispatch_sum<1>(grid, st, pp, pe, ps, pf, depth, n, n, po);
  }
  return (int)cudaGetLastError();
}

// One slab of `depth` planes (n words each) of Min/Max. first: fa/va are
// built from exists, filt and sign, else read from fa (int32[n]) and va
// (int64[n] when wide, else int32[n]); last: `partials` holds 2 * grid int64
// of scratch, `ticket` one zeroed uint32, and `out` gets int64[3] = [best
// key, any, count], else fa and va are written back. first && last needs
// no fa or va.
PT_EXPORT int pt_bsi_min_max(const void* planes, const void* exists, const void* sign,
                             const void* filt, int depth, int64_t n, int vec, int is_min,
                             int first, int last, void* fa, void* va, int wide, int grid,
                             void* partials, void* ticket, void* out, void* stream) {
  if (depth < 1 || depth > kMaxDepth || grid < 1) return (int)cudaErrorInvalidValue;
  if (!(first && last) && (fa == nullptr || va == nullptr)) return (int)cudaErrorInvalidValue;
  const auto* pp = static_cast<const uint32_t*>(planes);
  const auto* pe = static_cast<const uint32_t*>(exists);
  const auto* ps = static_cast<const uint32_t*>(sign);
  const auto* pf = static_cast<const uint32_t*>(filt);
  auto* pa = static_cast<uint32_t*>(fa);
  auto* part = static_cast<long long*>(partials);
  auto* tk = static_cast<unsigned int*>(ticket);
  auto* po = static_cast<long long*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  if (vec) {
    dispatch_min_max<4>(grid, st, pp, pe, ps, pf, depth, n / 4, n, is_min, first, last, pa, va,
                        wide, part, tk, po);
  } else {
    dispatch_min_max<1>(grid, st, pp, pe, ps, pf, depth, n, n, is_min, first, last, pa, va, wide,
                        part, tk, po);
  }
  return (int)cudaGetLastError();
}

// planes [depth, shards, w], base/sign [shards, w]; vec: w % 4 == 0 and
// every pointer 16-byte aligned. count != 0: `out` is int64[shards], zeroed
// by the caller; else `out` is int32[shards, w].
PT_EXPORT int pt_bsi_range(const void* planes, const void* base, const void* sign,
                           int depth, int64_t shards, int64_t w, int sel, int kind,
                           int allow_eq, uint32_t p0, uint32_t p1, int count, int vec,
                           void* out, void* stream) {
  if (depth < 1 || depth > kMaxDepth) return (int)cudaErrorInvalidValue;
  if (sel != SEL_CONSIDER && sign == nullptr) return (int)cudaErrorInvalidValue;
  if (shards < 1 || w < 1) return (int)cudaGetLastError();
  const int64_t w_items = vec ? w / 4 : w;
  // about four items per thread per pass
  int64_t bps = (w_items + kThreads * 4 - 1) / (kThreads * 4);
  if (bps < 1) bps = 1;
  const int64_t grid = shards * bps;
  const auto* pp = static_cast<const uint32_t*>(planes);
  const auto* pb = static_cast<const uint32_t*>(base);
  const auto* ps = static_cast<const uint32_t*>(sign);
  auto st = static_cast<cudaStream_t>(stream);
  const int64_t n = shards * w;
  int rc;
  if (vec) {
    rc = dispatch_range<4>((int)grid, st, pp, pb, ps, sel, kind, depth, w_items, n, p0, p1,
                           allow_eq, (int32_t)bps, count, out);
  } else {
    rc = dispatch_range<1>((int)grid, st, pp, pb, ps, sel, kind, depth, w_items, n, p0, p1,
                           allow_eq, (int32_t)bps, count, out);
  }
  if (rc != 0) return rc;
  return (int)cudaGetLastError();
}

// One slab of d planes (absolute [lo, lo + d), n words each) of a range
// count. `desc` is a host int64 array: n_jobs, n_extras, then per job (kind,
// sel, allow_eq, lz, first state row, p0, p1), then the extras' selectors.
// state: int32[rows, n] (unused when first && last); last: `out` is
// int64[n_jobs + n_extras], zeroed by the caller. vec: n % 4 == 0 and every
// pointer 16-byte aligned; at most 256 items per thread.
PT_EXPORT int pt_bsi_range_step(const void* planes, const void* exists, const void* sign,
                                void* state, const int64_t* desc, int d, int lo, int first,
                                int last, int64_t n, int vec, int grid, void* out, void* stream) {
  if (d < 1 || d > kMaxDepth || lo < 0 || lo + d > kMaxDepth || grid < 1) {
    return (int)cudaErrorInvalidValue;
  }
  RangeJobs jobs = {};
  jobs.n_jobs = (int)desc[0];
  jobs.n_extras = (int)desc[1];
  if (jobs.n_jobs < 0 || jobs.n_jobs > kMaxJobs || jobs.n_extras < 0 ||
      jobs.n_extras > kMaxExtras) {
    return (int)cudaErrorInvalidValue;
  }
  const int64_t* q = desc + 2;
  for (int t = 0; t < jobs.n_jobs; ++t, q += 7) {
    jobs.kind[t] = (int)q[0];
    jobs.sel[t] = (int)q[1];
    jobs.allow_eq[t] = (int)q[2];
    jobs.lz[t] = (int)q[3];
    jobs.row[t] = (int)q[4];
    jobs.p0[t] = (uint32_t)q[5];
    jobs.p1[t] = (uint32_t)q[6];
    if (jobs.kind[t] < KIND_EQ || jobs.kind[t] > KIND_BETWEEN) return (int)cudaErrorInvalidValue;
    if (jobs.sel[t] != SEL_CONSIDER && sign == nullptr) return (int)cudaErrorInvalidValue;
  }
  for (int e = 0; e < jobs.n_extras; ++e) {
    jobs.extra_sel[e] = (int)q[e];
    if (jobs.extra_sel[e] != SEL_CONSIDER && sign == nullptr) return (int)cudaErrorInvalidValue;
  }
  if (!(first && last) && jobs.n_jobs > 0 && state == nullptr) return (int)cudaErrorInvalidValue;
  const int64_t items = vec ? n / 4 : n;
  if ((items + (int64_t)grid * kThreads - 1) / ((int64_t)grid * kThreads) > 256) {
    return (int)cudaErrorInvalidValue;
  }
  const auto* pp = static_cast<const uint32_t*>(planes);
  const auto* pe = static_cast<const uint32_t*>(exists);
  const auto* ps = static_cast<const uint32_t*>(sign);
  auto* pst = static_cast<uint32_t*>(state);
  auto* po = static_cast<unsigned long long*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  if (vec) {
    bsi_range_step_kernel<4><<<grid, kThreads, 0, st>>>(pp, pe, ps, pst, jobs, d, lo, first,
                                                         last, items, n, po);
  } else {
    bsi_range_step_kernel<1><<<grid, kThreads, 0, st>>>(pp, pe, ps, pst, jobs, d, lo, first,
                                                         last, items, n, po);
  }
  return (int)cudaGetLastError();
}

// Hand-written Hopper (sm_90a) kernels for the staged-ingest merge barrier
// and the in-place patch of resident extents.
//
//   merge_mark_kernel  pilosa_tpu/ops/merge.py _merge_sorted_u64 (the part
//                      after the sort), an XLA program: over keys already
//                      sorted on the card, the first-occurrence mask
//                      keep[i] = i == 0 || s[i] != s[i - 1] and the word
//                      bit bit[i] = keep[i] ? 1 << (s[i] & 31) : 0, in one
//                      pass. The sort before it (torch.sort) and the
//                      inclusive scan and compaction after it are library
//                      calls, as the reference's jnp.sort is no Pallas
//                      kernel either.
//   or_words_kernel    pilosa_tpu/core/view.py _patch_entry's device part
//                      (gather | OR | scatter of dense delta blocks):
//                      entry[off[k]] |= val[k] over the sparse (flat word
//                      offset, OR value) pairs of a merged delta.
//
// Both are bound by device-memory bytes. merge_mark reads each 8-byte key
// once (its neighbour's read hits the same or the previous 32-byte sector,
// which L1/L2 serve) and writes 4 + 1 bytes per key: n x 13 B. or_words
// reads 8 + 4 bytes per pair and reads and writes the 32-byte sector of its
// target word: K x (12 + 64) B. The offsets are unique (the merge
// deduplicated the bits and word_or_from_sorted folded them per word), so
// no two threads touch one word and no atomics are needed; they lie in
// [0, n_words), which the wrapper (ops/merge.py or_words) checks on the
// host copy of the pairs before it uploads them. One thread per element,
// grid-stride, 64-bit indices.
//
// Each C entry point launches on the caller's stream, does not synchronise,
// allocates nothing, and returns cudaGetLastError() as an int.

#include <cuda_runtime.h>
#include <stdint.h>

#define PT_EXPORT extern "C" __attribute__((visibility("default")))

namespace {

constexpr int kThreads = 256;
constexpr int64_t kMaxBlocks = 132 * 32;

__global__ void merge_mark_kernel(const long long* __restrict__ s, int64_t n,
                                  unsigned char* __restrict__ keep,
                                  uint32_t* __restrict__ bit) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    const long long v = __ldg(s + i);
    const bool first = i == 0 || __ldg(s + i - 1) != v;
    keep[i] = first ? 1 : 0;
    bit[i] = first ? (1u << (unsigned)(v & 31)) : 0u;
  }
}

__global__ void or_words_kernel(uint32_t* __restrict__ entry, const long long* __restrict__ off,
                                const uint32_t* __restrict__ val, int64_t k) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < k; i += stride)
    entry[__ldg(off + i)] |= __ldg(val + i);
}

int64_t blocks_for(int64_t n) {
  int64_t b = (n + kThreads - 1) / kThreads;
  return b < kMaxBlocks ? b : kMaxBlocks;
}

}  // namespace

PT_EXPORT int pt_merge_mark(const void* s, int64_t n, void* keep, void* bit, void* stream) {
  if (n <= 0) return 0;
  merge_mark_kernel<<<(unsigned)blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(
      (const long long*)s, n, (unsigned char*)keep, (uint32_t*)bit);
  return (int)cudaGetLastError();
}

PT_EXPORT int pt_or_words(void* entry, const void* off, const void* val, int64_t k, void* stream) {
  if (k <= 0) return 0;
  or_words_kernel<<<(unsigned)blocks_for(k), kThreads, 0, (cudaStream_t)stream>>>(
      (uint32_t*)entry, (const long long*)off, (const uint32_t*)val, k);
  return (int)cudaGetLastError();
}

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
//   or_bits_kernel     pilosa_tpu/core/view.py _patch_entry's device part
//                      (gather | OR | scatter of dense 128 KiB delta
//                      blocks per dirty (plane, shard)): ORs the merge
//                      barrier's sorted unique bit keys into a resident
//                      entry in place. For each row (key_start, key_end,
//                      dst_word_base) of a chunk table and each key k in
//                      [key_start, key_end): col = k & col_mask, then
//                      entry[dst_word_base + (col >> 5)] |= 1 << (col & 31).
//
// Both are bound by device-memory bytes. merge_mark reads each 8-byte key
// once (its neighbour's read hits the same or the previous 32-byte sector,
// which L1/L2 serve) and writes 4 + 1 bytes per key: n x 13 B (one thread
// per key, grid-stride, 64-bit indices).
//
// or_bits reads 8 bytes per key and reads and writes each distinct
// 32-byte sector of the entry that the keys touch: 8 K + 64 x sectors. Its
// design follows from that count:
//   - a CTA takes one chunk of at most kOrBitsChunk keys of one segment
//     (the wrapper, ops/merge.py or_bits, cuts the segments into chunks
//     and copies the chunk table to the card with the launch), so the CTA
//     reads one table row and no search is needed;
//   - the keys are read coalesced: in round j lane l of warp w loads key
//     j * kOrBitsThreads + w * 32 + l of the chunk, so each warp load is
//     256 contiguous bytes (8 whole sectors) and every thread has all
//     kOrBitsKeysPerThread loads in flight before it uses one. A 16-byte
//     vector load would move the same sectors and break the one-key-per-
//     lane layout the combining below relies on;
//   - the keys are sorted, so a warp's 32 keys of one round cover
//     consecutive words and the keys of one word sit in consecutive
//     lanes: a segmented OR scan over __shfl_down_sync gives the first
//     lane of each run the OR of its run, and only that lane updates;
//   - a word's run can straddle two rounds, two warps or two CTAs, so the
//     update is atomicOr with its result unused, which compiles to
//     red.global.or.b32: a reduction the L2 performs, so the SM never
//     waits on the entry's sector (a load, OR and store from the SM would
//     hold each thread until its sector came back from HBM).
// The wrapper checks the table on the host (keys in range, every row's
// destination a whole row of the entry); the kernel trusts it. Keys are
// unique, so each bit is set once; a duplicate key would still be right.
//
// Each C entry point launches on the caller's stream, does not synchronise,
// allocates nothing, and returns cudaGetLastError() as an int (pt_or_bits
// also returns the status of its asynchronous table copy).

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

// or_bits geometry (mirrored by ops/merge.py OR_BITS_CHUNK)
constexpr int kOrBitsThreads = 256;
constexpr int kOrBitsKeysPerThread = 4;
constexpr int64_t kOrBitsChunk = (int64_t)kOrBitsThreads * kOrBitsKeysPerThread;

// table: three columns of n_chunks int64 each, key_start, key_end and
// dst_word_base; key_end - key_start <= kOrBitsChunk
__global__ void __launch_bounds__(kOrBitsThreads)
    or_bits_kernel(uint32_t* __restrict__ entry, const long long* __restrict__ keys,
                   const long long* __restrict__ table, int64_t n_chunks, long long col_mask) {
  const unsigned lane = threadIdx.x & 31u;
  for (int64_t c = blockIdx.x; c < n_chunks; c += gridDim.x) {
    const int64_t start = __ldg(table + c);
    const int64_t end = __ldg(table + n_chunks + c);
    uint32_t* __restrict__ dst = entry + __ldg(table + 2 * n_chunks + c);
    long long k[kOrBitsKeysPerThread];
#pragma unroll
    for (int j = 0; j < kOrBitsKeysPerThread; ++j) {
      const int64_t i = start + j * kOrBitsThreads + threadIdx.x;
      k[j] = i < end ? __ldg(keys + i) : -1;  // keys are >= 0
    }
#pragma unroll
    for (int j = 0; j < kOrBitsKeysPerThread; ++j) {
      const bool valid = k[j] >= 0;
      const unsigned col = valid ? (unsigned)(k[j] & col_mask) : 0u;
      // lanes past the chunk's end sit at the warp's tail and never
      // match a real word (word < 2^25)
      const unsigned word = valid ? col >> 5 : 0xFFFFFFFFu;
      unsigned acc = valid ? 1u << (col & 31u) : 0u;
      // after the step with offset off, acc is the OR over lanes
      // [lane, min(lane + 2 off - 1, last lane of the run)]
#pragma unroll
      for (unsigned off = 1; off < 32; off <<= 1) {
        const unsigned w = __shfl_down_sync(0xFFFFFFFFu, word, off);
        const unsigned a = __shfl_down_sync(0xFFFFFFFFu, acc, off);
        if (lane + off < 32 && w == word) acc |= a;
      }
      const unsigned prev = __shfl_up_sync(0xFFFFFFFFu, word, 1);
      if (valid && (lane == 0 || prev != word)) atomicOr(dst + word, acc);
    }
  }
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

// host_table (pinned, table_bytes = 3 x n_chunks x 8) is copied into
// dev_table on the stream, then the kernel runs on it; a null host_table
// launches on a dev_table already filled (to time the kernel alone)
PT_EXPORT int pt_or_bits(const void* host_table, int64_t table_bytes, void* dev_table, void* entry,
                         const void* keys, int64_t n_chunks, int64_t col_mask, void* stream) {
  if (n_chunks <= 0) return 0;
  auto st = static_cast<cudaStream_t>(stream);
  if (host_table != nullptr) {
    if (table_bytes != 3 * n_chunks * (int64_t)sizeof(int64_t)) return (int)cudaErrorInvalidValue;
    const cudaError_t err = cudaMemcpyAsync(dev_table, host_table, table_bytes, cudaMemcpyHostToDevice, st);
    if (err != cudaSuccess) return (int)err;
  }
  const int64_t blocks = n_chunks < kMaxBlocks ? n_chunks : kMaxBlocks;
  or_bits_kernel<<<(unsigned)blocks, kOrBitsThreads, 0, st>>>(
      (uint32_t*)entry, (const long long*)keys, (const long long*)dev_table, n_chunks, (long long)col_mask);
  return (int)cudaGetLastError();
}

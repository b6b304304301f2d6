// The bucketing half of the engine's record exchange: rows of 32-bit words, each with a
// destination shard, scattered into per-destination buckets in source row order.
//
// Replaces: pathway_tpu/parallel/exchange.py `bucketed_all_to_all`, the body inside shard_map
// (lines 51-79), jitted per shape class by pathway_tpu/engine/mesh_exchange.py `_cached_kernel`.
// There each source shard computes slot = running count of its rows with the same destination
// (one_hot + cumsum), drops rows with dest < 0 or slot >= cap_bucket, scatter-adds the kept rows
// into zeroed [n_dst, cap_bucket, w] buckets with a validity mask, and `lax.all_to_all` swaps
// bucket b to device b. With every source block on one card, the all-to-all is a layout: the
// kernel writes source s's bucket for destination d straight to out[d, s*cap_bucket + slot], so
// out[d] is what device d holds after the JAX collective. Across ranks, the caller runs this with
// one source block and swaps the buckets with torch.distributed's all_to_all_single.
//
// Slots are taken in source row order (a row's slot counts the EARLIER rows of its block with the
// same destination), never by atomics: the engine re-zips columns that travel on the host with
// the dense arrivals by (source, emission order), so the order is part of the contract. The
// payload is bits (64-bit keys as word pairs, negative diffs, NaN floats): words are copied,
// never converted.
//
// Bound on the H100: bytes. Each input word is read once and each output word written once (the
// zeroed buckets included); there is no arithmetic to speak of.
//
// Design: one block of 1024 threads per source block walks its rows in tiles of 1024. Inside a
// warp, __match_any_sync groups the lanes by destination, so a lane's rank among the warp's
// earlier lanes with its destination is a popcount; each group's leader writes the group's size
// to shared memory. Then one thread per destination scans the 32 warps' counts in order on top of
// a running base carried across tiles, and every lane writes its row to base + warp offset + rank.
// The launcher clears both outputs with cudaMemsetAsync first: slots no row reaches stay zero, as
// JAX's scatter-add into zeros leaves them. A first, simple kernel: at most n_src blocks run, so
// the card is far from its memory rate at the engine's shapes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxDst = 32;

__global__ void bucket_exchange_kernel(const int32_t* __restrict__ values,
                                       const int32_t* __restrict__ dest, int cap_in, int w,
                                       int n_dst, int cap_bucket, int32_t* __restrict__ out,
                                       uint8_t* __restrict__ valid) {
  __shared__ int warp_count[kWarps][kMaxDst];
  __shared__ int warp_base[kWarps][kMaxDst];
  __shared__ int base[kMaxDst];

  const int s = blockIdx.x;
  const int n_src = gridDim.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const unsigned lanes_below = (1u << lane) - 1u;
  const long long out_rows = static_cast<long long>(n_src) * cap_bucket;  // rows per destination

  if (threadIdx.x < kMaxDst) base[threadIdx.x] = 0;

  for (int tile = 0; tile < cap_in; tile += kThreads) {
    for (int i = threadIdx.x; i < kWarps * kMaxDst; i += kThreads)
      (&warp_count[0][0])[i] = 0;
    __syncthreads();

    const int r = tile + threadIdx.x;
    const long long row = static_cast<long long>(s) * cap_in + r;
    int d = r < cap_in ? dest[row] : -1;
    if (d >= n_dst) d = -1;  // out of range: dropped, as JAX drops an out-of-bounds scatter
    const unsigned same = __match_any_sync(0xffffffffu, d);
    const int rank = __popc(same & lanes_below);
    if (d >= 0 && rank == 0) warp_count[warp][d] = __popc(same);
    __syncthreads();

    if (threadIdx.x < n_dst) {
      const int dd = threadIdx.x;
      int running = base[dd];
      for (int k = 0; k < kWarps; ++k) {
        warp_base[k][dd] = running;
        running += warp_count[k][dd];
      }
      base[dd] = running;
    }
    __syncthreads();

    if (d >= 0) {
      const int pos = warp_base[warp][d] + rank;
      if (pos < cap_bucket) {
        const long long o = static_cast<long long>(d) * out_rows +
                            static_cast<long long>(s) * cap_bucket + pos;
        const int32_t* src = values + row * w;
        int32_t* dst = out + o * w;
        for (int k = 0; k < w; ++k) dst[k] = src[k];
        valid[o] = 1;
      }
    }
    __syncthreads();  // warp_base is read above before the next tile rewrites it
  }
}

}  // namespace

// values: int32 [n_src * cap_in, w] (row-major), dest: int32 [n_src * cap_in];
// out: int32 [n_dst, n_src * cap_bucket, w], valid: uint8 [n_dst, n_src * cap_bucket].
// 1 <= n_dst <= 32. Clears both outputs and launches on `stream`; returns cudaGetLastError().
extern "C" int bucket_exchange(const void* values, const void* dest, int n_src, int cap_in, int w,
                               int n_dst, int cap_bucket, void* out, void* valid, void* stream) {
  if (n_src < 1 || cap_in < 1 || w < 1 || n_dst < 1 || n_dst > kMaxDst || cap_bucket < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t out_rows = static_cast<size_t>(n_dst) * n_src * cap_bucket;
  cudaError_t err = cudaMemsetAsync(out, 0, out_rows * w * sizeof(int32_t), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaMemsetAsync(valid, 0, out_rows, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  bucket_exchange_kernel<<<n_src, kThreads, 0, st>>>(
      static_cast<const int32_t*>(values), static_cast<const int32_t*>(dest), cap_in, w, n_dst,
      cap_bucket, static_cast<int32_t*>(out), static_cast<uint8_t*>(valid));
  return static_cast<int>(cudaGetLastError());
}

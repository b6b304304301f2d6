// The global top-k of the sharded KNN search: merge the candidates that the shards' local top-k
// lists gathered into one row per query.
//
// Replaces: pathway_tpu/ops/knn.py `sharded_knn_search`, the merge after the all-gather (lines
// 124-126): `lax.top_k` over the [q, P*k] gathered scores and `take_along_axis` of the ids. The
// JAX package has no Pallas kernel there: XLA compiles it inside shard_map. For each query row it
// returns the k best (score, id) pairs in `lax.top_k`'s order: higher score first, and among equal
// scores the lower position in the row first. The gathered row is shard-major and each shard's
// list is already in that order, so equal scores come lower shard first, then lower row: the order
// the unsharded search gives. Rows masked to -inf tie among themselves and never pass a real row.
// torch.topk does not promise this tie order, hence a kernel.
//
// Bound on the H100: bytes, a few microseconds at any shape a caller gives (64 queries, P*k
// candidates of 12 bytes each); a launch costs more than that.
//
// Design: one block per query. Each candidate becomes one 64-bit key, the score's bits mapped to
// an unsigned order (-0 taken as +0) above the complement of its position, so that one descending
// sort of unique keys gives the order above. The keys sit in shared memory (at most 8192 of them,
// 64 KB), padded with zeros to a power of two, and a bitonic sort orders them; the first k keys
// give the positions whose scores and ids are copied out.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxCandidates = 8192;

__device__ __forceinline__ unsigned long long order_key(float score, int pos) {
  const uint32_t u = __float_as_uint(score + 0.f);  // -0 + 0 = +0: the two zeros compare equal
  const uint32_t ordered = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return (static_cast<unsigned long long>(ordered) << 32) | (0xFFFFFFFFu - static_cast<uint32_t>(pos));
}

__global__ void topk_merge_kernel(const float* __restrict__ scores,
                                  const long long* __restrict__ ids, int m, int m_pow2, int k,
                                  float* __restrict__ out_s, long long* __restrict__ out_i) {
  extern __shared__ unsigned long long keys[];
  const long long row = blockIdx.x;
  const float* srow = scores + row * m;
  for (int j = threadIdx.x; j < m_pow2; j += blockDim.x)
    keys[j] = j < m ? order_key(srow[j], j) : 0ull;
  __syncthreads();

  // bitonic sort, descending
  for (int size = 2; size <= m_pow2; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int t = threadIdx.x; t < m_pow2 / 2; t += blockDim.x) {
        const int i = 2 * t - (t & (stride - 1));
        const int j = i + stride;
        const unsigned long long a = keys[i], b = keys[j];
        const bool descending = (i & size) == 0;
        if ((a < b) == descending) {
          keys[i] = b;
          keys[j] = a;
        }
      }
      __syncthreads();
    }
  }

  for (int r = threadIdx.x; r < k; r += blockDim.x) {
    const int pos = static_cast<int>(0xFFFFFFFFu - static_cast<uint32_t>(keys[r]));
    out_s[row * k + r] = srow[pos];
    out_i[row * k + r] = ids[row * m + pos];
  }
}

}  // namespace

// scores: f32 [q, m], ids: int64 [q, m], both contiguous, 1 <= k <= m <= 8192; out_s f32 [q, k],
// out_i int64 [q, k]. Launches on `stream` and returns cudaGetLastError().
extern "C" int topk_merge(const void* scores, const void* ids, int q, int m, int k, void* out_s,
                          void* out_i, void* stream) {
  if (q < 1 || m < 1 || m > kMaxCandidates || k < 1 || k > m)
    return static_cast<int>(cudaErrorInvalidValue);
  int m_pow2 = 1;
  while (m_pow2 < m) m_pow2 <<= 1;
  if (m_pow2 < 2) m_pow2 = 2;
  const int threads = m_pow2 / 2 < 32 ? 32 : (m_pow2 / 2 > 1024 ? 1024 : m_pow2 / 2);
  const size_t smem = static_cast<size_t>(m_pow2) * sizeof(unsigned long long);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        topk_merge_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  topk_merge_kernel<<<q, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(scores), static_cast<const long long*>(ids), m, m_pow2, k,
      static_cast<float*>(out_s), static_cast<long long*>(out_i));
  return static_cast<int>(cudaGetLastError());
}

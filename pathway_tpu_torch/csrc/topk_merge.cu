// The global top-k of the sharded KNN search: merge the candidates that the shards' local top-k
// lists gathered into one row per query.
//
// Replaces: pathway_tpu/ops/knn.py `sharded_knn_search`, the merge after the all-gather (lines
// 121-126): the shift of each shard's ids to global rows, `lax.top_k` over the [q, P*k] gathered
// scores and `take_along_axis` of the ids. The JAX package has no Pallas kernel there: XLA compiles
// it inside shard_map. For each query row it returns the k best (score, id) pairs in `lax.top_k`'s
// order: higher score first, and among equal scores the lower position in the row first. The
// gathered row is shard-major and each shard's list is already in that order, so equal scores come
// lower shard first, then lower row: the order the unsharded search gives. Rows masked to -inf tie
// among themselves and never pass a real row. torch.topk does not promise this tie order, hence a
// kernel.
//
// The entry `topk_merge_shards` reads the candidates where they lie: the all-gather's own output,
// [P, q, k] shard-major scores and local ids, and it adds shard * rows_per_shard to the ids it
// writes. The sharded search then needs no offset add and no transposing copy between the
// collective and the merge; a [q, m] row per query is the case P = 1.
//
// Bound on the H100: bytes, a few microseconds at any shape a caller gives (64 queries, P*k
// candidates of 12 bytes each); a launch costs more than that.
//
// Design: each candidate becomes one 64-bit key, the score's bits mapped to an unsigned order (-0
// taken as +0) above the complement of its position, so that one descending sort of unique keys
// gives the order above. Up to 256 candidates a query (every sharded search of 8 shards at k <= 32)
// one warp sorts them: each lane holds up to 8 keys in registers, element e = r * 32 + lane, and a
// bitonic sort swaps within a lane's registers or across lanes by __shfl_xor_sync; no shared memory
// and no block barrier, four queries a block. Above 256 (at most 8192) one block per query sorts
// the keys in shared memory (64 KB at most), padded with zeros to a power of two. In both the first
// k keys give the positions whose scores and ids are copied out.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxCandidates = 8192;
constexpr int kWarpMax = 256;  // candidates a warp sorts in registers
constexpr int kWarpsPerBlock = 4;
constexpr int kMaxDevices = 64;
constexpr unsigned kFull = 0xffffffffu;

// Where candidate j of query row r lies: shard j / per_shard, place j % per_shard; its id gains
// shard * id_step.
struct Rows {
  long long row_stride, shard_stride, id_step;
  int per_shard;
  __device__ __forceinline__ long long at(int r, int j) const {
    const int p = j / per_shard;
    return p * shard_stride + r * row_stride + (j - p * per_shard);
  }
};

__device__ __forceinline__ unsigned long long order_key(float score, int pos) {
  const uint32_t u = __float_as_uint(score + 0.f);  // -0 + 0 = +0: the two zeros compare equal
  const uint32_t ordered = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return (static_cast<unsigned long long>(ordered) << 32) | (0xFFFFFFFFu - static_cast<uint32_t>(pos));
}

__device__ __forceinline__ int key_pos(unsigned long long key) {
  return static_cast<int>(0xFFFFFFFFu - static_cast<uint32_t>(key));
}

__device__ __forceinline__ void copy_out(const float* scores, const long long* ids, Rows rows,
                                         int row, int rank, int pos, int k, float* out_s,
                                         long long* out_i) {
  const long long at = rows.at(row, pos);
  out_s[static_cast<long long>(row) * k + rank] = scores[at];
  out_i[static_cast<long long>(row) * k + rank] = ids[at] + (pos / rows.per_shard) * rows.id_step;
}

// One warp per query, 32 * kE candidates at most (kE = 1, 2, 4 or 8).
template <int kE>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
topk_merge_warp_kernel(const float* __restrict__ scores, const long long* __restrict__ ids, int q,
                       int m, int k, Rows rows, float* __restrict__ out_s,
                       long long* __restrict__ out_i) {
  const int row = blockIdx.x * kWarpsPerBlock + threadIdx.x / 32;
  if (row >= q) return;  // the whole warp
  const int lane = threadIdx.x % 32;
  unsigned long long key[kE];
#pragma unroll
  for (int r = 0; r < kE; ++r) {
    const int e = r * 32 + lane;
    key[r] = e < m ? order_key(scores[rows.at(row, e)], e) : 0ull;  // padding sorts last
  }
  // bitonic sort, descending, of element e = r * 32 + lane: blocks of 2^ls, partners 2^lt apart
  constexpr int kLog = kE == 1 ? 5 : kE == 2 ? 6 : kE == 4 ? 7 : 8;
#pragma unroll
  for (int ls = 1; ls <= kLog; ++ls) {
#pragma unroll
    for (int lt = ls - 1; lt >= 0; --lt) {
      const int size = 1 << ls, stride = 1 << lt;
      if (stride < 32) {  // the partner is in lane ^ stride, same register
#pragma unroll
        for (int r = 0; r < kE; ++r) {
          const int e = r * 32 + lane;
          const unsigned long long other = __shfl_xor_sync(kFull, key[r], stride);
          const bool keep_larger = ((e & size) == 0) == ((e & stride) == 0);
          key[r] = keep_larger ? (key[r] > other ? key[r] : other)
                               : (key[r] < other ? key[r] : other);
        }
      } else {  // the partner is in this lane, register r ^ (stride / 32)
#pragma unroll
        for (int r = 0; r < kE; ++r) {
          const int r2 = r ^ (stride / 32);
          if (r2 > r) {
            const bool descending = ((r * 32 + lane) & size) == 0;
            const unsigned long long a = key[r], b = key[r2];
            if ((a < b) == descending) {
              key[r] = b;
              key[r2] = a;
            }
          }
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < kE; ++r) {
    const int e = r * 32 + lane;
    if (e < k) copy_out(scores, ids, rows, row, e, key_pos(key[r]), k, out_s, out_i);
  }
}

// One block per query, m_pow2 keys in shared memory.
__global__ void topk_merge_block_kernel(const float* __restrict__ scores,
                                        const long long* __restrict__ ids, int m, int m_pow2,
                                        int k, Rows rows, float* __restrict__ out_s,
                                        long long* __restrict__ out_i) {
  extern __shared__ unsigned long long keys[];
  const int row = blockIdx.x;
  for (int j = threadIdx.x; j < m_pow2; j += blockDim.x)
    keys[j] = j < m ? order_key(scores[rows.at(row, j)], j) : 0ull;
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

  for (int r = threadIdx.x; r < k; r += blockDim.x)
    copy_out(scores, ids, rows, row, r, key_pos(keys[r]), k, out_s, out_i);
}

int launch(const void* scores, const void* ids, int q, int m, int k, Rows rows, void* out_s,
           void* out_i, cudaStream_t stream) {
  if (q < 1 || m < 1 || m > kMaxCandidates || k < 1 || k > m)
    return static_cast<int>(cudaErrorInvalidValue);
  const float* s = static_cast<const float*>(scores);
  const long long* i = static_cast<const long long*>(ids);
  float* os = static_cast<float*>(out_s);
  long long* oi = static_cast<long long*>(out_i);
  if (m <= kWarpMax) {
    const int blocks = (q + kWarpsPerBlock - 1) / kWarpsPerBlock, threads = kWarpsPerBlock * 32;
    if (m <= 32)
      topk_merge_warp_kernel<1><<<blocks, threads, 0, stream>>>(s, i, q, m, k, rows, os, oi);
    else if (m <= 64)
      topk_merge_warp_kernel<2><<<blocks, threads, 0, stream>>>(s, i, q, m, k, rows, os, oi);
    else if (m <= 128)
      topk_merge_warp_kernel<4><<<blocks, threads, 0, stream>>>(s, i, q, m, k, rows, os, oi);
    else
      topk_merge_warp_kernel<8><<<blocks, threads, 0, stream>>>(s, i, q, m, k, rows, os, oi);
    return static_cast<int>(cudaGetLastError());
  }
  int m_pow2 = 1;
  while (m_pow2 < m) m_pow2 <<= 1;
  const int threads = m_pow2 / 2 > 1024 ? 1024 : m_pow2 / 2;
  const size_t smem = static_cast<size_t>(m_pow2) * sizeof(unsigned long long);
  if (smem > 48 * 1024) {  // once per device: the limit for 8192 keys
    static bool raised[kMaxDevices] = {};
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= kMaxDevices)
      return static_cast<int>(cudaErrorInvalidDevice);
    if (!raised[dev]) {
      const cudaError_t err = cudaFuncSetAttribute(
          topk_merge_block_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(kMaxCandidates * sizeof(unsigned long long)));
      if (err != cudaSuccess) return static_cast<int>(err);
      raised[dev] = true;
    }
  }
  topk_merge_block_kernel<<<q, threads, smem, stream>>>(s, i, m, m_pow2, k, rows, os, oi);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// scores: f32 [P, q, kk], ids: int64 [P, q, kk] (each shard's local ids), both contiguous, as the
// all-gather of the shards' [q, kk] lists lays them out; 1 <= k <= P * kk <= 8192. The candidates
// of query r are shard-major, and an id of shard p comes out as id + p * rows_per_shard.
extern "C" int topk_merge_shards(const void* scores, const void* ids, int P, int q, int kk, int k,
                                 long long rows_per_shard, void* out_s, void* out_i,
                                 void* stream) {
  if (P < 1 || kk < 1 || static_cast<long long>(P) * kk > kMaxCandidates)
    return static_cast<int>(cudaErrorInvalidValue);
  const Rows rows{kk, static_cast<long long>(q) * kk, rows_per_shard, kk};
  return launch(scores, ids, q, P * kk, k, rows, out_s, out_i, static_cast<cudaStream_t>(stream));
}

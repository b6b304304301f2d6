// The symmetric InfoNCE loss of the training step and its gradient, in one launch.
//
// Replaces: pathway_tpu/models/pipeline.py `make_step`, the loss of `loss_fn` (lines 61-67) and
// its VJP under jax.value_and_grad. XLA fuses the two log-softmaxes and their gradient under
// jax.jit; there is no Pallas kernel. From the f32 logits l [B, B] (the caller's
// (ea @ eb.T) / 0.07) it computes
//
//   r[i]  = log sum_j exp(l[i, j]),  c[j] = log sum_i exp(l[i, j])   each max-shifted, in f32
//   loss  = -mean_i (l[i, i] - r[i]) - mean_j (l[j, j] - c[j])
//   grad  = (exp(l - r[i]) - I) / B + (exp(l - c[j]) - I) / B         d loss / d l
//
// Bound on the H100 at the training shape B=256: neither. The logits and the gradient are 2 * B*B
// * 4 bytes, 0.52 MB, about 0.16 us at 3.35 TB/s; its 15 * B*B operations in f32 about 0.015 us at
// 67 TFLOP/s. A launch costs a few microseconds, so at this shape the launch bounds it, and the
// design spreads the little work there is so that no SM holds the rest up.
//
// Two routes, chosen by B alone (ops/infonce.py `CLUSTER_MAX_B` is kClusterMaxB below):
//
// The cluster route (B <= kClusterMaxB = 640; the training step's B=256) is one thread block
// cluster of kClusterBlocks = 8 blocks of 512 threads, launched with cudaLaunchKernelEx and the
// cluster attribute. Block b reads its ceil(B / 8) rows once, one contiguous range, into shared
// memory (32 KB at B=256; 200 KB at the limit, which is about what a block's 227 KB hold beside
// the column statistics). It takes each of its rows' max and sum of exponentials, a warp a row
// with the row's values in registers, and a partial (max, sum of exponentials) of every column
// over its rows, two threads a column at B=256 (each over half the rows, then combined). After a
// cluster barrier each block reads the eight blocks' partials of every column through
// distributed shared memory and combines them into the column log-sum-exps. It sends its share of
// the loss to block 0's shared memory, and after a second cluster barrier (no block reads a
// peer's shared memory past it) block 0 writes the loss while every block writes the gradient of
// its rows from shared memory, a warp a row with 16-byte stores and 2-D indices. The exponentials
// are ex2.approx (`fast_exp`). Its time is the latency of these dependent phases, each of little
// work, and not bytes or arithmetic (PERF.md, Findings).

// The block route (a larger B; no caller in the repository has one) is the kernel of the earlier
// versions: one block of 1024 threads, each warp taking whole rows and each thread whole columns,
// the row and column log-sum-exps through a scratch of 2B floats.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

constexpr int kClusterBlocks = 8;  // the portable cluster size
constexpr int kClusterThreads = 512;
constexpr int kClusterWarps = kClusterThreads / 32;
constexpr int kClusterMaxB = 640;
constexpr int kRowValues = (kClusterMaxB + 31) / 32;  // a lane's values of a row, at most

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

__global__ void __launch_bounds__(kThreads)
infonce_kernel(const float* __restrict__ logits, int B, float* __restrict__ lse,
               float* __restrict__ grad, float* __restrict__ loss) {
  __shared__ float part[kWarps];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* row_lse = lse;
  float* col_lse = lse + B;

  for (int i = warp; i < B; i += kWarps) {
    const float* row = logits + static_cast<long long>(i) * B;
    float m = -INFINITY;
    for (int j = lane; j < B; j += 32) m = fmaxf(m, row[j]);
    m = warp_max(m);
    float s = 0.f;
    for (int j = lane; j < B; j += 32) s += expf(row[j] - m);
    s = warp_sum(s);
    if (lane == 0) row_lse[i] = m + logf(s);
  }
  for (int j = threadIdx.x; j < B; j += kThreads) {
    float m = -INFINITY;
    for (int i = 0; i < B; ++i) m = fmaxf(m, logits[static_cast<long long>(i) * B + j]);
    float s = 0.f;
    for (int i = 0; i < B; ++i) s += expf(logits[static_cast<long long>(i) * B + j] - m);
    col_lse[j] = m + logf(s);
  }
  __syncthreads();

  const float inv_b = 1.f / static_cast<float>(B);
  float acc = 0.f;
  for (int i = threadIdx.x; i < B; i += kThreads) {
    const float d = logits[static_cast<long long>(i) * B + i];
    acc += (row_lse[i] - d) + (col_lse[i] - d);
  }
  acc = warp_sum(acc);
  if (lane == 0) part[warp] = acc;

  const long long n = static_cast<long long>(B) * B;
  for (long long e = threadIdx.x; e < n; e += kThreads) {
    const int i = static_cast<int>(e / B), j = static_cast<int>(e % B);
    const float x = logits[e];
    const float eye = i == j ? 1.f : 0.f;
    grad[e] = ((expf(x - row_lse[i]) - eye) + (expf(x - col_lse[j]) - eye)) * inv_b;
  }
  __syncthreads();
  if (warp == 0) {
    float v = lane < kWarps ? part[lane] : 0.f;
    v = warp_sum(v);
    if (lane == 0) *loss = v * inv_b;
  }
}

// e^x as ex2.approx of x log2(e): two instructions where expf takes about ten. Its relative error,
// about 2^-22 plus the rounding of x log2(e), stays below 2e-6 for |x| <= 30 (logits of unit
// vectors over 0.07 lie within +-14.3), well inside the loss's and gradient's 1e-5.
__device__ __forceinline__ float fast_exp(float x) { return __expf(x); }

// The cluster route's shared memory, in floats: the block's rows [R][B], the column partials
// (max, sum) [split][B] (the block's combined ones in split 0), the column log-sum-exps [B], the
// rows' log-sum-exps [R], the blocks' loss shares [kClusterBlocks] (block 0's are the ones read).
struct ClusterLayout {
  int rows, part, col, row, loss, total;
};

// threads a column takes for its partial over the block's rows: all of them at B = 256
__host__ __device__ constexpr int cluster_split(int B) {
  return B * 4 <= kClusterThreads ? 4 : B * 2 <= kClusterThreads ? 2 : 1;
}

__host__ __device__ constexpr ClusterLayout cluster_layout(int B) {
  const int R = (B + kClusterBlocks - 1) / kClusterBlocks;
  ClusterLayout L{};
  L.rows = 0;
  L.part = (R * B + 3) & ~3;  // 16-byte aligned
  L.col = L.part + 2 * cluster_split(B) * B;
  L.row = L.col + B;
  L.loss = L.row + R;
  L.total = L.loss + kClusterBlocks;
  return L;
}

static_assert(cluster_layout(kClusterMaxB).total * 4 <= 232448,
              "the largest cluster layout fits in a block's 227 KB of shared memory");

__global__ void __launch_bounds__(kClusterThreads)
infonce_cluster_kernel(const float* __restrict__ logits, int B, float* __restrict__ grad,
                       float* __restrict__ loss) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const ClusterLayout L = cluster_layout(B);
  const int R = (B + kClusterBlocks - 1) / kClusterBlocks;
  const int split = cluster_split(B);
  const int row0 = rank * R;
  const int nrows = max(0, min(B, row0 + R) - row0);
  float* tile = smem + L.rows;  // [nrows][B]
  float2* part = reinterpret_cast<float2*>(smem + L.part);
  float* col_lse = smem + L.col;
  float* row_lse = smem + L.row;
  float* loss_share = smem + L.loss;

  // the block's rows: one contiguous range of nrows * B floats
  const float* src = logits + static_cast<long long>(row0) * B;
  const int n = nrows * B;
  if ((B & 3) == 0) {
    for (int e = threadIdx.x; e < n / 4; e += kClusterThreads)
      reinterpret_cast<float4*>(tile)[e] = reinterpret_cast<const float4*>(src)[e];
  } else {
    for (int e = threadIdx.x; e < n; e += kClusterThreads) tile[e] = src[e];
  }
  __syncthreads();

  // each row's max and sum of exponentials, a warp a row, its values in registers
  for (int i = warp; i < nrows; i += kClusterWarps) {
    const float* row = tile + i * B;
    float v[kRowValues];
    float m = -INFINITY;
#pragma unroll
    for (int c = 0; c < kRowValues; ++c) {
      if (32 * c >= B) break;  // uniform across the warp
      v[c] = lane + 32 * c < B ? row[lane + 32 * c] : -INFINITY;
      m = fmaxf(m, v[c]);
    }
    m = warp_max(m);
    float s = 0.f;
#pragma unroll
    for (int c = 0; c < kRowValues; ++c) {
      if (32 * c >= B) break;
      if (lane + 32 * c < B) s += fast_exp(v[c] - m);
    }
    s = warp_sum(s);
    if (lane == 0) row_lse[i] = m + logf(s);
  }
  // column j's partial (max, sum of exponentials) over rows sp, sp + split, ... of the block, a
  // thread each, 8 rows at a time in registers (one batch at B = 256), the sum rescaled to each
  // batch's max
  for (int e = threadIdx.x; e < split * B; e += kClusterThreads) {
    const int j = e % B, sp = e / B;
    float m = -INFINITY, s = 0.f;
    for (int i0 = sp; i0 < nrows; i0 += 8 * split) {
      float v[8];
      float bm = -INFINITY;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const int i = i0 + c * split;
        v[c] = i < nrows ? tile[i * B + j] : -INFINITY;
        bm = fmaxf(bm, v[c]);
      }
      const float nm = fmaxf(m, bm);
      if (nm == -INFINITY) continue;  // nothing but -inf so far
      s = m == -INFINITY ? 0.f : s * fast_exp(m - nm);
#pragma unroll
      for (int c = 0; c < 8; ++c) s += fast_exp(v[c] - nm);
      m = nm;
    }
    part[sp * B + j] = make_float2(m, s);
  }
  __syncthreads();
  for (int j = threadIdx.x; j < B && split > 1; j += kClusterThreads) {
    float m = -INFINITY;
    for (int sp = 0; sp < split; ++sp) m = fmaxf(m, part[sp * B + j].x);
    float s = 0.f;
    for (int sp = 0; sp < split; ++sp) {
      const float2 p = part[sp * B + j];
      if (p.y > 0.f) s += p.y * fast_exp(p.x - m);
    }
    part[j] = make_float2(m, s);
  }
  cluster.sync();  // every block's partials are written

  for (int j = threadIdx.x; j < B; j += kClusterThreads) {
    float2 p[kClusterBlocks];
    float m = -INFINITY;
#pragma unroll
    for (int r = 0; r < kClusterBlocks; ++r) {
      p[r] = *cluster.map_shared_rank(part + j, r);
      m = fmaxf(m, p[r].x);
    }
    float s = 0.f;
#pragma unroll
    for (int r = 0; r < kClusterBlocks; ++r)
      if (p[r].y > 0.f) s += p[r].y * fast_exp(p[r].x - m);  // a block of no rows adds nothing
    col_lse[j] = m + logf(s);
  }
  __syncthreads();

  // the block's share of the loss, into block 0's shared memory
  const float inv_b = 1.f / static_cast<float>(B);
  float acc = 0.f;
  for (int i = threadIdx.x; i < nrows; i += kClusterThreads) {
    const float d = tile[i * B + row0 + i];
    acc += (row_lse[i] - d) + (col_lse[row0 + i] - d);
  }
  acc = warp_sum(acc);
  __shared__ float warp_part[kClusterWarps];
  if (lane == 0) warp_part[warp] = acc;
  __syncthreads();
  if (warp == 0) {
    float v = lane < kClusterWarps ? warp_part[lane] : 0.f;
    v = warp_sum(v);
    if (lane == 0) *cluster.map_shared_rank(loss_share + rank, 0) = v;
  }
  // the shares have landed, and no block reads a peer's shared memory past this point, so a
  // block may finish while its peers still write their gradients
  cluster.sync();
  if (rank == 0 && threadIdx.x == 0) {
    float v = 0.f;
    for (int r = 0; r < kClusterBlocks; ++r) v += loss_share[r];
    *loss = v * inv_b;
  }

  // the gradient of the block's rows, a warp a row
  float* out = grad + static_cast<long long>(row0) * B;
  for (int i = warp; i < nrows; i += kClusterWarps) {
    const float* row = tile + i * B;
    const float rl = row_lse[i];
    const int diag = row0 + i;
    if ((B & 3) == 0) {
      for (int j = 4 * lane; j < B; j += 128) {
        const float4 x = *reinterpret_cast<const float4*>(row + j);
        const float4 c = *reinterpret_cast<const float4*>(col_lse + j);
        const float xs[4] = {x.x, x.y, x.z, x.w}, cs[4] = {c.x, c.y, c.z, c.w};
        float gs[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const float eye = j + u == diag ? 1.f : 0.f;
          gs[u] = ((fast_exp(xs[u] - rl) - eye) + (fast_exp(xs[u] - cs[u]) - eye)) * inv_b;
        }
        *reinterpret_cast<float4*>(out + static_cast<long long>(i) * B + j) =
            make_float4(gs[0], gs[1], gs[2], gs[3]);
      }
    } else {
      for (int j = lane; j < B; j += 32) {
        const float eye = j == diag ? 1.f : 0.f;
        out[static_cast<long long>(i) * B + j] =
            ((fast_exp(row[j] - rl) - eye) + (fast_exp(row[j] - col_lse[j]) - eye)) * inv_b;
      }
    }
  }
}

__global__ void infonce_empty_kernel() {}

int cluster_smem(int B) { return cluster_layout(B).total * 4; }

constexpr int kMaxDevices = 64;

// Raise a cluster-route kernel's dynamic shared memory limit to the largest layout, once per
// device (`which`: 0 the kernel, 1 the empty one).
template <typename Kernel>
cudaError_t cluster_attribute(Kernel kernel, int which) {
  static bool done[2][kMaxDevices] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= kMaxDevices)
    return cudaErrorInvalidDevice;
  if (done[which][dev]) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, cluster_smem(kClusterMaxB));
  done[which][dev] = err == cudaSuccess;
  return err;
}

cudaLaunchConfig_t cluster_config(int smem, cudaStream_t stream, cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kClusterBlocks);
  cfg.blockDim = dim3(kClusterThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = kClusterBlocks;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

}  // namespace

// logits: f32 [B, B] contiguous, 16-byte aligned; lse: f32 scratch of 2B (the block route's;
// null on the cluster route); grad: f32 [B, B], 16-byte aligned; loss: one f32. The route follows
// from B. Launches on `stream` and returns cudaGetLastError().
extern "C" int infonce(const void* logits, int B, void* lse, void* grad, void* loss,
                       void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B <= kClusterMaxB) {
    cudaError_t err = cluster_attribute(infonce_cluster_kernel, 0);
    if (err != cudaSuccess) return static_cast<int>(err);
    cudaLaunchAttribute attr;
    const cudaLaunchConfig_t cfg = cluster_config(cluster_smem(B), st, &attr);
    err = cudaLaunchKernelEx(&cfg, infonce_cluster_kernel, static_cast<const float*>(logits), B,
                             static_cast<float*>(grad), static_cast<float*>(loss));
    if (err != cudaSuccess) return static_cast<int>(err);
    return static_cast<int>(cudaGetLastError());
  }
  if (lse == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  infonce_kernel<<<1, kThreads, 0, st>>>(static_cast<const float*>(logits), B,
                                         static_cast<float*>(lse), static_cast<float*>(grad),
                                         static_cast<float*>(loss));
  return static_cast<int>(cudaGetLastError());
}

// An empty kernel launched as the route of B is (the same grid, cluster and shared memory): the
// launch's own cost on the device, beside which the kernel's time is read.
extern "C" int infonce_empty(int B, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B <= kClusterMaxB) {
    cudaError_t err = cluster_attribute(infonce_empty_kernel, 1);
    if (err != cudaSuccess) return static_cast<int>(err);
    cudaLaunchAttribute attr;
    const cudaLaunchConfig_t cfg = cluster_config(cluster_smem(B), st, &attr);
    err = cudaLaunchKernelEx(&cfg, infonce_empty_kernel);
    if (err != cudaSuccess) return static_cast<int>(err);
    return static_cast<int>(cudaGetLastError());
  }
  infonce_empty_kernel<<<1, kThreads, 0, st>>>();
  return static_cast<int>(cudaGetLastError());
}

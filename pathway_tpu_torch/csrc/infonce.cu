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
// 67 TFLOP/s. A launch costs a few microseconds, so at this shape the launch bounds it.
//
// Design: one block of 1024 threads. Each warp takes whole rows (two coalesced passes over a row:
// its max, then its sum of exponentials), and each thread takes whole columns (the same two passes
// down a column; neighbouring threads read neighbouring columns, so each step is coalesced). The
// row and column log-sum-exps go to a scratch of 2B floats, a barrier makes them visible, and the
// block then writes the gradient element by element and reduces the loss. At B=256 the logits stay
// in L1 and L2 between the passes. A larger B would want the work spread over blocks; no caller in
// the repository has one.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

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

}  // namespace

// logits: f32 [B, B] contiguous; lse: f32 scratch of 2B; grad: f32 [B, B]; loss: one f32.
// Launches on `stream` and returns cudaGetLastError().
extern "C" int infonce(const void* logits, int B, void* lse, void* grad, void* loss,
                       void* stream) {
  infonce_kernel<<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(logits), B, static_cast<float*>(lse), static_cast<float*>(grad),
      static_cast<float*>(loss));
  return static_cast<int>(cudaGetLastError());
}

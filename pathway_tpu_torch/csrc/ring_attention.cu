// One step of ring attention: fold one block of keys and values into the running online-softmax
// state (o, m, l) of a block of queries, in place; on the ring's last step also write the output.
//
// Replaces: pathway_tpu/models/ring_attention.py, `accumulate` inside `ring_attention` (lines
// 80-91) and the final division (line 111). The JAX package has no Pallas kernel there: XLA fuses
// the expression under shard_map. For each (batch b, head h, query row i) it computes, all in f32,
//
//   s[j]  = (q[i] . k[j]) * scale             the product of the f32-cast inputs, then the scale
//   s[j]  = -1e30 where key j is masked        -1e30, not -inf
//   m'    = max(m, max_j s[j]),   corr = exp(m - m')
//   l'    = l * corr + sum_j exp(s[j] - m')
//   o'    = o * corr + sum_j exp(s[j] - m') v[j]
//   out   = o' / max(l', 1e-30)                only when the caller asks (the ring's last step)
//
// for head widths D of 8, 16, 32 and 64 and bf16 or f32 inputs. m starts at -1e30, so keys that
// are all masked so far weigh 1 each, and the first real key wipes them out through corr = 0: an
// all-pad document attends uniformly, as in the JAX program. No TF32 and no bf16 rounding: the
// products run in f32 on the CUDA cores.
//
// Bound on the H100 at the long-context shape (B=4, one rank's 8192 queries against 8192 keys,
// H=12, D=32): operations. The 4 * B*H*s*s_blk*D = 4.1e11 f32 operations take about 6.2 ms at
// 67 TFLOP/s; the inputs and the state are about 0.2 GB, or 0.06 ms at 3.35 TB/s.
//
// Design: 256 threads per block over the query rows of one (b, h); a thread takes two rows (one
// at D = 64) and keeps their query vectors and output accumulators in registers. The block walks
// the key block in tiles of 16 keys: the tile's keys and values are cast to f32 into shared memory
// and read by every thread as 16-byte broadcasts, each feeding both of its rows; the next tile's
// values are loaded into registers before the current tile is folded, so the global loads overlap
// the arithmetic. Each tile is folded with its own rescaling (the flash-attention update), so no
// [s, s_blk] score matrix exists anywhere: a thread holds the tile's scores in registers, takes
// their max, rescales its state once and accumulates the exponentials and their weighted values.
// Over a block this equals the JAX update in exact arithmetic; in f32 the sums differ in order
// only. The state is read and written once per launch. On the H100 at the long-context shape it
// runs at about 2.5x its bound: the registers a thread needs (247 at D = 32) leave one block per
// SM, and the CUDA cores wait on the dependent FMAs of the dot products; the tensor cores (3xTF32
// or bf16 splits of f32) are the way past that.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // threads per block
constexpr int kKeys = 16;      // keys per shared-memory tile
constexpr float kNeg = -1e30f;

// query rows per thread: two up to D = 32; at D = 64 one row's q and accumulator take 128
// registers already
template <int D>
__host__ __device__ constexpr int rows_per_thread() { return D <= 32 ? 2 : 1; }

struct Strides {  // in elements; the stride of d is 1
  long long b, h, s;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <int D, typename T>
__global__ void __launch_bounds__(kThreads)
ring_block_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                  const uint8_t* __restrict__ mask, float* __restrict__ o, float* __restrict__ m,
                  float* __restrict__ l, float* __restrict__ out, int H, int s, int s_blk,
                  float scale, Strides sq, Strides sk, Strides sv, Strides so, long long mask_b) {
  constexpr int R = rows_per_thread<D>();
  constexpr int D4 = D / 4;
  __shared__ __align__(16) float k_tile[kKeys][D];
  __shared__ __align__(16) float v_tile[kKeys][D];
  __shared__ uint8_t keep[kKeys];

  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  // rows r0, r0 + kThreads, ...: neighbouring threads take neighbouring rows
  const int r0 = blockIdx.x * kThreads * R + threadIdx.x;

  float qr[R][D], acc[R][D], mi[R], li[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int row = r0 + r * kThreads;
    const long long state = static_cast<long long>(bh) * s + row;
    mi[r] = kNeg;
    li[r] = 0.f;
#pragma unroll
    for (int d = 0; d < D; ++d) qr[r][d] = acc[r][d] = 0.f;
    if (row < s) {
      const T* qp = q + b * sq.b + h * sq.h + row * sq.s;
      const float* op = o + state * D;
#pragma unroll
      for (int d = 0; d < D; ++d) {
        qr[r][d] = to_f32(qp[d]);
        acc[r][d] = op[d];
      }
      mi[r] = m[state];
      li[r] = l[state];
    }
  }

  const T* kp = k + b * sk.b + h * sk.h;
  const T* vp = v + b * sv.b + h * sv.h;
  const uint8_t* mp = mask + b * mask_b;
  // each thread copies E values of K and of V per tile; the next tile's are loaded into registers
  // before the current tile is folded, so that the loads overlap the arithmetic
  constexpr int E = (kKeys * D + kThreads - 1) / kThreads;
  float pk[E], pv[E];
  uint8_t pm = 0;
  auto fetch = [&](int t0) {
    const int n = min(kKeys, s_blk - t0);
#pragma unroll
    for (int i = 0; i < E; ++i) {
      const int e = threadIdx.x + i * kThreads;
      const int j = e / D, d = e % D;
      pk[i] = pv[i] = 0.f;
      if (e < kKeys * D && j < n) {
        pk[i] = to_f32(kp[(t0 + j) * sk.s + d]);
        pv[i] = to_f32(vp[(t0 + j) * sv.s + d]);
      }
    }
    if (threadIdx.x < kKeys) pm = threadIdx.x < n ? mp[t0 + threadIdx.x] : 0;
  };
  fetch(0);
  for (int t0 = 0; t0 < s_blk; t0 += kKeys) {
    const int n = min(kKeys, s_blk - t0);
    __syncthreads();  // the previous tile is no longer read
#pragma unroll
    for (int i = 0; i < E; ++i) {
      const int e = threadIdx.x + i * kThreads;
      if (e < kKeys * D) {
        k_tile[e / D][e % D] = pk[i];
        v_tile[e / D][e % D] = pv[i];
      }
    }
    if (threadIdx.x < kKeys) keep[threadIdx.x] = pm;
    __syncthreads();
    if (t0 + kKeys < s_blk) fetch(t0 + kKeys);

    float sc[R][kKeys];
#pragma unroll
    for (int j = 0; j < kKeys; ++j) {
      const float4* kr = reinterpret_cast<const float4*>(k_tile[j]);
      float dot[R];
#pragma unroll
      for (int r = 0; r < R; ++r) dot[r] = 0.f;
#pragma unroll
      for (int d4 = 0; d4 < D4; ++d4) {
        const float4 kk = kr[d4];
#pragma unroll
        for (int r = 0; r < R; ++r) {
          dot[r] = fmaf(qr[r][4 * d4], kk.x, dot[r]);
          dot[r] = fmaf(qr[r][4 * d4 + 1], kk.y, dot[r]);
          dot[r] = fmaf(qr[r][4 * d4 + 2], kk.z, dot[r]);
          dot[r] = fmaf(qr[r][4 * d4 + 3], kk.w, dot[r]);
        }
      }
      const bool kept = keep[j];
#pragma unroll
      for (int r = 0; r < R; ++r) sc[r][j] = kept ? dot[r] * scale : kNeg;
    }
    float p_scale[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      float tmax = -INFINITY;
#pragma unroll
      for (int j = 0; j < kKeys; ++j)
        if (j < n) tmax = fmaxf(tmax, sc[r][j]);
      const float m_new = fmaxf(mi[r], tmax);
      const float corr = expf(mi[r] - m_new);
#pragma unroll
      for (int d = 0; d < D; ++d) acc[r][d] *= corr;
      li[r] *= corr;
      mi[r] = m_new;
      p_scale[r] = m_new;
    }
#pragma unroll
    for (int j = 0; j < kKeys; ++j) {
      const float4* vr = reinterpret_cast<const float4*>(v_tile[j]);
      float p[R];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        p[r] = j < n ? expf(sc[r][j] - p_scale[r]) : 0.f;
        li[r] += p[r];
      }
#pragma unroll
      for (int d4 = 0; d4 < D4; ++d4) {
        const float4 vv = vr[d4];
#pragma unroll
        for (int r = 0; r < R; ++r) {
          acc[r][4 * d4] = fmaf(p[r], vv.x, acc[r][4 * d4]);
          acc[r][4 * d4 + 1] = fmaf(p[r], vv.y, acc[r][4 * d4 + 1]);
          acc[r][4 * d4 + 2] = fmaf(p[r], vv.z, acc[r][4 * d4 + 2]);
          acc[r][4 * d4 + 3] = fmaf(p[r], vv.w, acc[r][4 * d4 + 3]);
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int row = r0 + r * kThreads;
    if (row >= s) continue;
    const long long state = static_cast<long long>(bh) * s + row;
    float* op = o + state * D;
#pragma unroll
    for (int d = 0; d < D; ++d) op[d] = acc[r][d];
    m[state] = mi[r];
    l[state] = li[r];
    if (out != nullptr) {
      const float denom = fmaxf(li[r], 1e-30f);
      float* dst = out + b * so.b + h * so.h + row * so.s;
#pragma unroll
      for (int d = 0; d < D; ++d) dst[d] = acc[r][d] / denom;
    }
  }
}

template <int D, typename T>
int launch(const void* q, const void* k, const void* v, const void* mask, void* o, void* m,
           void* l, void* out, int B, int H, int s, int s_blk, float scale, Strides sq,
           Strides sk, Strides sv, Strides so, long long mask_b, cudaStream_t stream) {
  constexpr int rows = kThreads * rows_per_thread<D>();
  const dim3 grid((s + rows - 1) / rows, B * H);
  ring_block_kernel<D, T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const uint8_t*>(mask), static_cast<float*>(o), static_cast<float*>(m),
      static_cast<float*>(l), static_cast<float*>(out), H, s, s_blk, scale, sq, sk, sv, so,
      mask_b);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(int D, const void* q, const void* k, const void* v, const void* mask, void* o,
             void* m, void* l, void* out, int B, int H, int s, int s_blk, float scale,
             Strides sq, Strides sk, Strides sv, Strides so, long long mask_b,
             cudaStream_t stream) {
  switch (D) {
    case 8: return launch<8, T>(q, k, v, mask, o, m, l, out, B, H, s, s_blk, scale, sq, sk, sv, so, mask_b, stream);
    case 16: return launch<16, T>(q, k, v, mask, o, m, l, out, B, H, s, s_blk, scale, sq, sk, sv, so, mask_b, stream);
    case 32: return launch<32, T>(q, k, v, mask, o, m, l, out, B, H, s, s_blk, scale, sq, sk, sv, so, mask_b, stream);
    case 64: return launch<64, T>(q, k, v, mask, o, m, l, out, B, H, s, s_blk, scale, sq, sk, sv, so, mask_b, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q [B, H, s, D], k and v [B, H, s_blk, D]: bf16 (is_bf16 = 1) or f32, any strides with d
// contiguous; mask: bytes [B, s_blk] (non-zero keeps the key), row stride mask_b; o f32
// [B, H, s, D], m and l f32 [B, H, s], all contiguous, updated in place; out: null, or f32
// [B, H, s, D] with d contiguous, written with o / max(l, 1e-30). Launches on `stream` and
// returns cudaGetLastError().
extern "C" int ring_block_attention(const void* q, const void* k, const void* v,
                                    const void* mask, void* o, void* m, void* l, void* out,
                                    int is_bf16, int B, int H, int s, int s_blk, int D,
                                    float scale, long long qb, long long qh, long long qs,
                                    long long kb, long long kh, long long ks, long long vb,
                                    long long vh, long long vs, long long ob, long long oh,
                                    long long os, long long mask_b, void* stream) {
  const Strides sq{qb, qh, qs}, sk{kb, kh, ks}, sv{vb, vh, vs}, so{ob, oh, os};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return dispatch<__nv_bfloat16>(D, q, k, v, mask, o, m, l, out, B, H, s, s_blk, scale, sq,
                                   sk, sv, so, mask_b, st);
  return dispatch<float>(D, q, k, v, mask, o, m, l, out, B, H, s, s_blk, scale, sq, sk, sv, so,
                         mask_b, st);
}

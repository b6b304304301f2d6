// The gradient of the encoder's masked attention: dq, dk and dv from q, k, v, the output's
// cotangent do, the key mask and the forward's row statistic.
//
// Replaces: the VJP that jax.value_and_grad takes of the attention expression of
// pathway_tpu/models/embedder.py `_block` (lines 90-101) inside pathway_tpu/models/pipeline.py
// `make_step` (line 72). XLA derives and fuses it under jax.jit; there is no Pallas kernel. It
// follows the casts of that expression, not FlashAttention's identities. Per (batch b, head h):
//
//   s[i, j]  = bf16(q[i] . k[j]) / sqrt(D), -1e30 where key j is padding   as the forward
//   y[i, j]  = exp(s[i, j] - m[i]) / l[i]          the forward's f32 softmax, from its statistic
//   dv[j]    = bf16(sum_i bf16(y[i, j]) do[i])     the product with v took y cast to bf16
//   dp[i, j] = bf16(do[i] . v[j])                  the cotangent of `att.astype(bf16)`, in f32
//   delta[i] = sum_j dp[i, j] y[i, j]              over every key, padding too
//   ds[i, j] = bf16(y[i, j] (dp[i, j] - delta[i]) / sqrt(D)), 0 where key j is padding
//   dq[i]    = bf16(sum_j ds[i, j] k[j]),  dk[j] = bf16(sum_i ds[i, j] q[i])
//
// delta is not FlashAttention's rowsum(do * o): o was computed from bf16(y), not from y, so the
// two differ. The forward's statistic (m[i], l[i]) makes y here the same f32 number, bit for bit,
// as the forward's p before its rounding.
//
// Bound on the H100 at the training shape B=256, H=12, S=128, D=32: memory. q, k, v, do, dq, dk
// and dv are 7 * B*H*S*D * 2 bytes, 176 MB, plus the 3.1 MB statistic: about 53 us at 3.35 TB/s.
// The five products (s, dp, dv, dq, dk), 10 * B*H*S*S*D = 1.6e10 operations, would take about
// 16 us at 989 TFLOP/s in bf16. What a launch pays for in practice is the per-score arithmetic
// (the accurate expf, the bf16 roundings, the division), as in the forward.
//
// Two routes, chosen by S alone. Every product runs on the tensor cores (mma.sync m16n8k16, bf16
// in, f32 accumulated); the C fragments of two 8-column tiles of ds are the A fragment of the next
// product, as in the forward; the B operands that run along the summed index come transposed
// through ldmatrix. Nothing of size S x S reaches device memory, and no sum needs atomics: each
// output row is summed by one warp, in one order.
//
// S <= 128 (every launch of the training path): one kernel that computes each score once. One
// block of eight warps a (b, h), two blocks a SM at D <= 32 (one at D = 64: shared memory). The
// head's Q, K, V and dO go into shared memory with cp.async, K and V as 128 rows (zeros past S),
// rows kD + 8 apart so that the operand loads hit distinct banks. Phase 1, warp w owning query
// rows 16 w .. 16 w + 15: the loop over the 16 key tiles of 8, of compile-time length, forms s
// and dp once on the tensor cores, keeps y in registers in f32 (64 a lane), writes bf16(y) and
// bf16(dp) to shared memory and sums delta; then it forms ds once from y and the dp it reads
// back, accumulates dq += ds . K, and writes ds over its dp. bf16(y) and ds are each a 128 x 136
// bf16 matrix (34,816 bytes). After one barrier, phase 2, warp w owning key rows 16 w ..: the A
// fragments of ds^T and bf16(y)^T come from those matrices by ldmatrix.trans, and dk += ds^T . Q
// and dv += bf16(y)^T . dO. One accurate expf, one division and five products a score. The
// division by sqrt(D) is correctly rounded without the IEEE division's range check and branch
// (Markstein's correction of x * (1 / sqrt(D)) by one fma; it equals the division outside f32's
// subnormal range, where a ds of 1e-38 would then round to bf16 anyway), which kept the compiler
// from interleaving the scores' arithmetic; at D = 16 and 64 it is a multiply by a power of two.
// The per-score formulas and every sum's order are those of the two-kernel route, so the two
// give the same bits (the sums past S add zeros; the same SHA-256 of dq, dk and dv at the
// training shape, scripts/torch_attention_pair.py). ptxas (sm_90a): 128 registers at D = 16 and
// 32, 186 at D = 64, no spill; 110,720 bytes of dynamic shared memory a block at D = 32.
//
// 128 < S <= 512 (tests and long bert inputs; ds does not fit in shared memory there): two
// kernels, one block per (b, h) each, four warps. The first puts the head's K and V in shared
// memory and gives each warp 16 query rows at a time: it walks the keys once to get delta
// (recomputing s and dp), and once more to form ds and accumulate dq; it writes dq and delta to
// a scratch in device memory. The second puts the head's Q and do in shared memory with the
// per-row m, l and delta, and gives each warp 16 key rows at a time: it walks the queries,
// recomputes s, y, dp and ds transposed, and accumulates dk and dv.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr unsigned kFull = 0xffffffffu;
enum KeyKind : uint8_t { kReal = 0, kMasked = 1, kAbsent = 2 };  // kAbsent: the pad up to 16

struct Strides {  // in elements; the stride of d is 1
  long long b, h, s;
};

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// d += a * b on the tensor cores: a 16x16 (row), b 16x8 (col), bf16 in, f32 accumulated.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(kFull, v, 1);
  return v + __shfl_xor_sync(kFull, v, 2);
}

// Copy 16 bytes from device to shared memory without staging in registers; zeros when !full.
__device__ __forceinline__ void cp_async16(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                           bool full) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(full ? 16 : 0));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const __nv_bfloat16* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

// The head's S rows of width kD into shared memory rows kD + 8 apart, zeros past S up to S16.
template <int kD, int kN = kThreads>
__device__ __forceinline__ void rows_to_smem(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                             long long stride, int S, int S16) {
  for (int e = threadIdx.x; e < S16 * (kD / 8); e += kN) {
    const int j = e / (kD / 8), c = (e % (kD / 8)) * 8;
    cp_async16(dst + j * (kD + 8) + c, src + (j < S ? j : 0) * stride + c, j < S);
  }
}

// Rows r and r + 8 of a [S, kD] head as A fragments of the 16-wide steps over d (zeros past S).
template <int kD>
__device__ __forceinline__ void rows_to_frags(uint32_t (&a)[kD / 16][4], const __nv_bfloat16* p,
                                              long long stride, int r, int S, int t) {
  const bool lo_in = r < S, hi_in = r + 8 < S;
#pragma unroll
  for (int st = 0; st < kD / 16; ++st) {
    const int c = st * 16 + t * 2;
    a[st][0] = lo_in ? ld32(p + r * stride + c) : 0u;
    a[st][1] = hi_in ? ld32(p + (r + 8) * stride + c) : 0u;
    a[st][2] = lo_in ? ld32(p + r * stride + c + 8) : 0u;
    a[st][3] = hi_in ? ld32(p + (r + 8) * stride + c + 8) : 0u;
  }
}

// c += a . b over d for an 8-column tile: b's 8 rows (from row n0 of a shared memory head) are the
// columns.
template <int kD>
__device__ __forceinline__ void tile_dot(float (&c)[4], const uint32_t (&a)[kD / 16][4],
                                         const __nv_bfloat16* rows, int n0, int g, int t) {
#pragma unroll
  for (int st = 0; st < kD / 16; ++st) {
    const __nv_bfloat16* bp = rows + (n0 + g) * (kD + 8) + st * 16 + t * 2;
    const uint32_t b[2] = {ld32(bp), ld32(bp + 8)};
    mma_bf16(c, a[st], b);
  }
}

// acc[d tile] += a . rows[k0 .. k0 + 15, :], the 16 rows of a shared memory head read transposed.
template <int kD>
__device__ __forceinline__ void accumulate_rows(float (&acc)[kD / 8][4], const uint32_t (&a)[4],
                                                const __nv_bfloat16* rows, int k0, int lane) {
  const int mi = lane >> 3;
#pragma unroll
  for (int pair = 0; pair < kD / 16; ++pair) {
    const __nv_bfloat16* p =
        rows + (k0 + (mi & 1) * 8 + (lane & 7)) * (kD + 8) + (pair * 2 + (mi >> 1)) * 8;
    uint32_t b4[4];
    ldmatrix_x4_trans(b4, p);
    const uint32_t b0[2] = {b4[0], b4[1]}, b1[2] = {b4[2], b4[3]};
    mma_bf16(acc[pair * 2], a, b0);
    mma_bf16(acc[pair * 2 + 1], a, b1);
  }
}

// The forward's probability: its score of q . k (`c`, f32 from the tensor cores), scaled and masked
// exactly as masked_attention.cu does, then exp(s - m) times the reciprocal of l. __fmul_rn and
// __fsub_rn keep the compiler from fusing the scaling and the shift into one rounding, which the
// forward does not do.
__device__ __forceinline__ float prob(float c, uint8_t kind, float m, float inv_l,
                                      float inv_scale) {
  const float s = kind == kReal ? __fmul_rn(bf16_round(c), inv_scale)
                                : (kind == kMasked ? -1e30f : -INFINITY);
  return __fmul_rn(expf(__fsub_rn(s, m)), inv_l);
}

// Row r and r + 8 of the accumulators, rounded to bf16, into a [S, kD] head with row stride `st`.
template <int kD>
__device__ __forceinline__ void store_rows(__nv_bfloat16* out, long long st,
                                           const float (&acc)[kD / 8][4], int r, int S, int t) {
#pragma unroll
  for (int nt = 0; nt < kD / 8; ++nt) {
    const int c = nt * 8 + t * 2;
    if (r < S)
      *reinterpret_cast<__nv_bfloat162*>(out + r * st + c) =
          __floats2bfloat162_rn(acc[nt][0], acc[nt][1]);
    if (r + 8 < S)
      *reinterpret_cast<__nv_bfloat162*>(out + (r + 8) * st + c) =
          __floats2bfloat162_rn(acc[nt][2], acc[nt][3]);
  }
}

// Kernel 1: delta and dq. Warps own query rows; K and V of the head are in shared memory.
template <int kD>
__global__ void __launch_bounds__(kThreads)
attention_bwd_dq_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                        const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
                        const uint8_t* __restrict__ mask, const float* __restrict__ stat,
                        __nv_bfloat16* __restrict__ dq, float* __restrict__ delta, int H, int S,
                        Strides sq, Strides sk, Strides sv, Strides sdo, Strides sdq,
                        long long mask_b) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int S16 = (S + 15) & ~15;
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem);   // [S16][kD + 8]
  __nv_bfloat16* vs = ks + S16 * (kD + 8);                       // [S16][kD + 8]
  uint8_t* kind = reinterpret_cast<uint8_t*>(vs + S16 * (kD + 8));  // [S16]

  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  rows_to_smem<kD>(ks, k + b * sk.b + h * sk.h, sk.s, S, S16);
  rows_to_smem<kD>(vs, v + b * sv.b + h * sv.h, sv.s, S, S16);
  asm volatile("cp.async.commit_group;\n" ::);
  for (int j = threadIdx.x; j < S16; j += kThreads)
    kind[j] = j >= S ? kAbsent : (mask[b * mask_b + j] ? kReal : kMasked);
  asm volatile("cp.async.wait_all;\n" ::);
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;  // mma fragment coordinates
  const float inv_scale = 1.f / sqrtf(static_cast<float>(kD));  // as the forward scales
  const float sqrt_d = sqrtf(static_cast<float>(kD));            // the VJP divides by it
  const __nv_bfloat16* qb = q + b * sq.b + h * sq.h;
  const __nv_bfloat16* db = dout + b * sdo.b + h * sdo.h;
  const float2* stb = reinterpret_cast<const float2*>(stat) + static_cast<long long>(bh) * S;

  for (int r0 = warp * 16; r0 < S; r0 += kWarps * 16) {
    const int r_lo = r0 + g, r_hi = r0 + g + 8;
    uint32_t qa[kD / 16][4], da[kD / 16][4];
    rows_to_frags<kD>(qa, qb, sq.s, r_lo, S, t);
    rows_to_frags<kD>(da, db, sdo.s, r_lo, S, t);
    // rows past S get m = 0 and 1/l = 0: their q is zero, so y = exp(0) * 0 = 0
    const float2 st_lo = r_lo < S ? stb[r_lo] : make_float2(0.f, INFINITY);
    const float2 st_hi = r_hi < S ? stb[r_hi] : make_float2(0.f, INFINITY);
    const float m[2] = {st_lo.x, st_hi.x};
    const float inv_l[2] = {1.f / st_lo.y, 1.f / st_hi.y};

    // pass 1: delta = sum_j dp y over every key
    float dsum[2] = {0.f, 0.f};
    for (int n0 = 0; n0 < S16; n0 += 8) {
      float c[4] = {0.f, 0.f, 0.f, 0.f}, p[4] = {0.f, 0.f, 0.f, 0.f};
      tile_dot<kD>(c, qa, ks, n0, g, t);
      tile_dot<kD>(p, da, vs, n0, g, t);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float y = prob(c[i], kind[n0 + t * 2 + (i & 1)], m[i >> 1], inv_l[i >> 1],
                             inv_scale);
        dsum[i >> 1] += bf16_round(p[i]) * y;
      }
    }
    const float dl[2] = {quad_sum(dsum[0]), quad_sum(dsum[1])};

    // pass 2: ds, rounded to bf16, and dq += ds . k over 16 keys at a time
    float acc[kD / 8][4] = {};
    for (int k0 = 0; k0 < S16; k0 += 16) {
      uint32_t a[4];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int n0 = k0 + half * 8;
        float c[4] = {0.f, 0.f, 0.f, 0.f}, p[4] = {0.f, 0.f, 0.f, 0.f};
        tile_dot<kD>(c, qa, ks, n0, g, t);
        tile_dot<kD>(p, da, vs, n0, g, t);
        float ds[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const uint8_t kk = kind[n0 + t * 2 + (i & 1)];
          const float y = prob(c[i], kk, m[i >> 1], inv_l[i >> 1], inv_scale);
          ds[i] = kk == kReal ? y * (bf16_round(p[i]) - dl[i >> 1]) / sqrt_d : 0.f;
        }
        a[half * 2] = pack_bf16(ds[0], ds[1]);
        a[half * 2 + 1] = pack_bf16(ds[2], ds[3]);
      }
      accumulate_rows<kD>(acc, a, ks, k0, lane);
    }
    store_rows<kD>(dq + b * sdq.b + h * sdq.h, sdq.s, acc, r_lo, S, t);
    if (t == 0) {
      if (r_lo < S) delta[static_cast<long long>(bh) * S + r_lo] = dl[0];
      if (r_hi < S) delta[static_cast<long long>(bh) * S + r_hi] = dl[1];
    }
  }
}

// Kernel 2: dk and dv. Warps own key rows; Q, do and the per-row m, 1/l and delta of the head are
// in shared memory.
template <int kD>
__global__ void __launch_bounds__(kThreads)
attention_bwd_dkv_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                         const __nv_bfloat16* __restrict__ v,
                         const __nv_bfloat16* __restrict__ dout, const uint8_t* __restrict__ mask,
                         const float* __restrict__ stat, const float* __restrict__ delta,
                         __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int H,
                         int S, Strides sq, Strides sk, Strides sv, Strides sdo, Strides sdk,
                         Strides sdv, long long mask_b) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int S16 = (S + 15) & ~15;
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem);  // [S16][kD + 8]
  __nv_bfloat16* dos = qs + S16 * (kD + 8);                     // [S16][kD + 8]
  float* row_m = reinterpret_cast<float*>(dos + S16 * (kD + 8));  // [S16]
  float* row_inv = row_m + S16;                                    // [S16]
  float* row_delta = row_inv + S16;                                // [S16]

  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  rows_to_smem<kD>(qs, q + b * sq.b + h * sq.h, sq.s, S, S16);
  rows_to_smem<kD>(dos, dout + b * sdo.b + h * sdo.h, sdo.s, S, S16);
  asm volatile("cp.async.commit_group;\n" ::);
  const float2* stb = reinterpret_cast<const float2*>(stat) + static_cast<long long>(bh) * S;
  for (int i = threadIdx.x; i < S16; i += kThreads) {  // query columns past S: y = 0, ds = 0
    const float2 st = i < S ? stb[i] : make_float2(0.f, INFINITY);
    row_m[i] = st.x;
    row_inv[i] = 1.f / st.y;
    row_delta[i] = i < S ? delta[static_cast<long long>(bh) * S + i] : 0.f;
  }
  asm volatile("cp.async.wait_all;\n" ::);
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const float inv_scale = 1.f / sqrtf(static_cast<float>(kD));
  const float sqrt_d = sqrtf(static_cast<float>(kD));
  const __nv_bfloat16* kb = k + b * sk.b + h * sk.h;
  const __nv_bfloat16* vb = v + b * sv.b + h * sv.h;

  for (int r0 = warp * 16; r0 < S; r0 += kWarps * 16) {
    const int r_lo = r0 + g, r_hi = r0 + g + 8;
    uint32_t ka[kD / 16][4], va[kD / 16][4];
    rows_to_frags<kD>(ka, kb, sk.s, r_lo, S, t);
    rows_to_frags<kD>(va, vb, sv.s, r_lo, S, t);
    const uint8_t kind[2] = {
        r_lo >= S ? kAbsent : (mask[b * mask_b + r_lo] ? kReal : kMasked),
        r_hi >= S ? kAbsent : (mask[b * mask_b + r_hi] ? kReal : kMasked),
    };

    float acc_k[kD / 8][4] = {}, acc_v[kD / 8][4] = {};
    for (int i0 = 0; i0 < S16; i0 += 16) {
      uint32_t a_ds[4], a_y[4];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int n0 = i0 + half * 8;
        // transposed tiles: c[0], c[1] for key r_lo and queries n0 + 2t, + 1; c[2], c[3] for r_hi
        float c[4] = {0.f, 0.f, 0.f, 0.f}, p[4] = {0.f, 0.f, 0.f, 0.f};
        tile_dot<kD>(c, ka, qs, n0, g, t);
        tile_dot<kD>(p, va, dos, n0, g, t);
        float y[4], ds[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int qi = n0 + t * 2 + (i & 1);
          const uint8_t kk = kind[i >> 1];
          y[i] = prob(c[i], kk, row_m[qi], row_inv[qi], inv_scale);
          ds[i] = kk == kReal ? y[i] * (bf16_round(p[i]) - row_delta[qi]) / sqrt_d : 0.f;
        }
        a_ds[half * 2] = pack_bf16(ds[0], ds[1]);
        a_ds[half * 2 + 1] = pack_bf16(ds[2], ds[3]);
        a_y[half * 2] = pack_bf16(y[0], y[1]);
        a_y[half * 2 + 1] = pack_bf16(y[2], y[3]);
      }
      accumulate_rows<kD>(acc_k, a_ds, qs, i0, lane);
      accumulate_rows<kD>(acc_v, a_y, dos, i0, lane);
    }
    store_rows<kD>(dk + b * sdk.b + h * sdk.h, sdk.s, acc_k, r_lo, S, t);
    store_rows<kD>(dv + b * sdv.b + h * sdv.h, sdv.s, acc_v, r_lo, S, t);
  }
}

// ---- the fused route, S <= 128 -------------------------------------------------------------

constexpr int kFusedMaxSeq = 128;             // the keys a warp's y holds in registers
constexpr int kFusedWarps = kFusedMaxSeq / 16;  // a 16-row tile each
constexpr int kFusedThreads = kFusedWarps * 32;
constexpr int kFusedTiles = kFusedMaxSeq / 8;  // key tiles of 8
constexpr int kSqLd = kFusedMaxSeq + 8;        // row stride of bf16(y) and ds in shared memory

// x / d rounded to nearest without the division's range check and its branch: rd = RN(1 / d),
// q = RN(x rd), the remainder x - q d exact by an fma, then RN(q + r rd) (Markstein's correction;
// the IEEE quotient wherever x, q and the remainder are normal floats).
__device__ __forceinline__ float div_rn(float x, float d, float rd) {
  const float q = x * rd;
  return fmaf(fmaf(-q, d, x), rd, q);
}

__device__ __forceinline__ float bf16_lo(uint32_t pair) { return __uint_as_float(pair << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t pair) {
  return __uint_as_float(pair & 0xffff0000u);
}

// Byte offsets of one block's shared memory: Q, K, V and dO of 128 rows kD + 8 apart, bf16(y) and
// ds of 128 rows kSqLd apart, the key kinds.
template <int kD>
struct FusedLayout {
  static constexpr int kHead = kFusedMaxSeq * (kD + 8) * 2;
  static constexpr int kSq = kFusedMaxSeq * kSqLd * 2;
  static constexpr int kY = 4 * kHead, kDs = kY + kSq, kKind = kDs + kSq;
  static constexpr int kTotal = kKind + kFusedMaxSeq;
};

template <int kD>
__global__ void __launch_bounds__(kFusedThreads, kD == 64 ? 1 : 2)
attention_bwd_fused_kernel(const __nv_bfloat16* __restrict__ q,
                           const __nv_bfloat16* __restrict__ k,
                           const __nv_bfloat16* __restrict__ v,
                           const __nv_bfloat16* __restrict__ dout,
                           const uint8_t* __restrict__ mask, const float* __restrict__ stat,
                           __nv_bfloat16* __restrict__ dq, __nv_bfloat16* __restrict__ dk,
                           __nv_bfloat16* __restrict__ dv, int H, int S, Strides sq, Strides sk,
                           Strides sv, Strides sdo, Strides sdq, Strides sdk, Strides sdv,
                           long long mask_b) {
  using L = FusedLayout<kD>;
  constexpr int kLd = kD + 8;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* ks = qs + kFusedMaxSeq * kLd;
  __nv_bfloat16* vs = ks + kFusedMaxSeq * kLd;
  __nv_bfloat16* dos = vs + kFusedMaxSeq * kLd;
  __nv_bfloat16* ys = reinterpret_cast<__nv_bfloat16*>(smem + L::kY);    // [query][key]
  __nv_bfloat16* dss = reinterpret_cast<__nv_bfloat16*>(smem + L::kDs);  // [query][key]
  uint8_t* kind = smem + L::kKind;                                       // [128]

  const int S16 = (S + 15) & ~15;
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  // K and V as all 128 rows, zeros past S: the loops below run over every key tile; Q and dO as
  // the S16 rows that phase 2 reads
  rows_to_smem<kD, kFusedThreads>(ks, k + b * sk.b + h * sk.h, sk.s, S, kFusedMaxSeq);
  rows_to_smem<kD, kFusedThreads>(vs, v + b * sv.b + h * sv.h, sv.s, S, kFusedMaxSeq);
  rows_to_smem<kD, kFusedThreads>(qs, q + b * sq.b + h * sq.h, sq.s, S, S16);
  rows_to_smem<kD, kFusedThreads>(dos, dout + b * sdo.b + h * sdo.h, sdo.s, S, S16);
  asm volatile("cp.async.commit_group;\n" ::);
  for (int j = threadIdx.x; j < kFusedMaxSeq; j += kFusedThreads)
    kind[j] = j >= S ? kAbsent : (mask[b * mask_b + j] ? kReal : kMasked);
  asm volatile("cp.async.wait_all;\n" ::);
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;  // mma fragment coordinates
  const float inv_scale = 1.f / sqrtf(static_cast<float>(kD));  // as the forward scales
  const float sqrt_d = sqrtf(static_cast<float>(kD));            // the VJP divides by it
  const float inv_sqrt_d = 1.f / sqrt_d;
  const float2* stb = reinterpret_cast<const float2*>(stat) + static_cast<long long>(bh) * S;

  // phase 1: warp w owns query rows 16 w .. 16 w + 15
  const int r0 = warp * 16;
  if (r0 < S) {
    const int r_lo = r0 + g, r_hi = r0 + g + 8;
    uint32_t qa[kD / 16][4], da[kD / 16][4];
    rows_to_frags<kD>(qa, qs, kLd, r_lo, S, t);
    rows_to_frags<kD>(da, dos, kLd, r_lo, S, t);
    // rows past S get m = 0 and 1/l = 0: their q is zero, so y = exp(0) * 0 = 0
    const float2 st_lo = r_lo < S ? stb[r_lo] : make_float2(0.f, INFINITY);
    const float2 st_hi = r_hi < S ? stb[r_hi] : make_float2(0.f, INFINITY);
    const float m[2] = {st_lo.x, st_hi.x};
    const float inv_l[2] = {1.f / st_lo.y, 1.f / st_hi.y};

    // s and dp once: y kept in registers in f32; dp, rounded to bf16, and bf16(y) to shared
    // memory (dp where ds goes: the lane that writes it reads it back and overwrites it); delta
    // summed in key order
    float y[kFusedTiles][4];
    float dsum[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < kFusedTiles; ++j) {
      float c[4] = {0.f, 0.f, 0.f, 0.f}, p[4] = {0.f, 0.f, 0.f, 0.f};
      tile_dot<kD>(c, qa, ks, j * 8, g, t);
      tile_dot<kD>(p, da, vs, j * 8, g, t);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        y[j][i] = prob(c[i], kind[j * 8 + t * 2 + (i & 1)], m[i >> 1], inv_l[i >> 1], inv_scale);
        dsum[i >> 1] += bf16_round(p[i]) * y[j][i];
      }
      *reinterpret_cast<uint32_t*>(dss + r_lo * kSqLd + j * 8 + t * 2) = pack_bf16(p[0], p[1]);
      *reinterpret_cast<uint32_t*>(dss + r_hi * kSqLd + j * 8 + t * 2) = pack_bf16(p[2], p[3]);
      *reinterpret_cast<uint32_t*>(ys + r_lo * kSqLd + j * 8 + t * 2) = pack_bf16(y[j][0], y[j][1]);
      *reinterpret_cast<uint32_t*>(ys + r_hi * kSqLd + j * 8 + t * 2) = pack_bf16(y[j][2], y[j][3]);
    }
    const float dl[2] = {quad_sum(dsum[0]), quad_sum(dsum[1])};

    // ds once, rounded to bf16: the A fragment of dq += ds . k over 16 keys at a time, and into
    // shared memory for phase 2
    float acc[kD / 8][4] = {};
#pragma unroll
    for (int kk = 0; kk < kFusedTiles / 2; ++kk) {
      const int c = kk * 16 + t * 2;
      uint32_t* const slot[4] = {
          reinterpret_cast<uint32_t*>(dss + r_lo * kSqLd + c),
          reinterpret_cast<uint32_t*>(dss + r_hi * kSqLd + c),
          reinterpret_cast<uint32_t*>(dss + r_lo * kSqLd + c + 8),
          reinterpret_cast<uint32_t*>(dss + r_hi * kSqLd + c + 8),
      };
      const uint32_t dp[2][2] = {{*slot[0], *slot[1]}, {*slot[2], *slot[3]}};
      uint32_t a[4];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int j = kk * 2 + half;
        float ds[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const uint8_t kk_kind = kind[j * 8 + t * 2 + (i & 1)];
          const uint32_t pair = dp[half][i >> 1];
          const float dpv = (i & 1) ? bf16_hi(pair) : bf16_lo(pair);
          ds[i] = kk_kind == kReal ? div_rn(y[j][i] * (dpv - dl[i >> 1]), sqrt_d, inv_sqrt_d)
                                   : 0.f;
        }
        a[half * 2] = pack_bf16(ds[0], ds[1]);
        a[half * 2 + 1] = pack_bf16(ds[2], ds[3]);
      }
      accumulate_rows<kD>(acc, a, ks, kk * 16, lane);
#pragma unroll
      for (int i = 0; i < 4; ++i) *slot[i] = a[i];
    }
    store_rows<kD>(dq + b * sdq.b + h * sdq.h, sdq.s, acc, r_lo, S, t);
  }
  __syncthreads();

  // phase 2: warp w owns key rows 16 w .. 16 w + 15; the A fragments of ds^T and bf16(y)^T for
  // keys c0 .. c0 + 15 and queries i0 .. i0 + 15 are the four 8 x 8 blocks of rows
  // i0 + 8 (mi >> 1) .. and columns c0 + 8 (mi & 1) .., read transposed
  const int mi = lane >> 3, c0 = warp * 16;
  if (c0 < S) {
    float acc_k[kD / 8][4] = {}, acc_v[kD / 8][4] = {};
    for (int i0 = 0; i0 < S16; i0 += 16) {
      const int off = (i0 + (mi >> 1) * 8 + (lane & 7)) * kSqLd + c0 + (mi & 1) * 8;
      uint32_t a_ds[4], a_y[4];
      ldmatrix_x4_trans(a_ds, dss + off);
      ldmatrix_x4_trans(a_y, ys + off);
      accumulate_rows<kD>(acc_k, a_ds, qs, i0, lane);
      accumulate_rows<kD>(acc_v, a_y, dos, i0, lane);
    }
    store_rows<kD>(dk + b * sdk.b + h * sdk.h, sdk.s, acc_k, c0 + g, S, t);
    store_rows<kD>(dv + b * sdv.b + h * sdv.h, sdv.s, acc_v, c0 + g, S, t);
  }
}

constexpr int kMaxDevices = 64;

int current_device() {
  int dev = 0;
  return cudaGetDevice(&dev) == cudaSuccess && dev >= 0 && dev < kMaxDevices ? dev : -1;
}

// Blocks of the fused route that fit on one SM (0 if none) at head width kD, computed once per
// device; that first call also raises the kernel's dynamic shared memory limit to what it needs.
template <int kD>
int fused_blocks_per_sm(int dev) {
  static int per_sm[kMaxDevices] = {};
  int& n = per_sm[dev];
  if (n == 0 &&
      (cudaFuncSetAttribute(attention_bwd_fused_kernel<kD>,
                            cudaFuncAttributeMaxDynamicSharedMemorySize,
                            FusedLayout<kD>::kTotal) != cudaSuccess ||
       cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, attention_bwd_fused_kernel<kD>,
                                                     kFusedThreads,
                                                     FusedLayout<kD>::kTotal) != cudaSuccess))
    n = 0;
  return n;
}

template <int kD>
int launch_fused(const void* q, const void* k, const void* v, const void* dout, const void* mask,
                 const void* stat, void* dq, void* dk, void* dv, int B, int H, int S, Strides sq,
                 Strides sk, Strides sv, Strides sdo, Strides sdq, Strides sdk, Strides sdv,
                 long long mask_b, cudaStream_t stream) {
  using bf = __nv_bfloat16;
  const int dev = current_device();
  if (dev < 0) return static_cast<int>(cudaErrorInvalidDevice);
  if (fused_blocks_per_sm<kD>(dev) < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  attention_bwd_fused_kernel<kD><<<B * H, kFusedThreads, FusedLayout<kD>::kTotal, stream>>>(
      static_cast<const bf*>(q), static_cast<const bf*>(k), static_cast<const bf*>(v),
      static_cast<const bf*>(dout), static_cast<const uint8_t*>(mask),
      static_cast<const float*>(stat), static_cast<bf*>(dq), static_cast<bf*>(dk),
      static_cast<bf*>(dv), H, S, sq, sk, sv, sdo, sdq, sdk, sdv, mask_b);
  return static_cast<int>(cudaGetLastError());
}

template <int kD>
int launch(const void* q, const void* k, const void* v, const void* dout, const void* mask,
           const void* stat, void* delta, void* dq, void* dk, void* dv, int B, int H, int S,
           Strides sq, Strides sk, Strides sv, Strides sdo, Strides sdq, Strides sdk, Strides sdv,
           long long mask_b, cudaStream_t stream) {
  using bf = __nv_bfloat16;
  if (S <= kFusedMaxSeq)
    return launch_fused<kD>(q, k, v, dout, mask, stat, dq, dk, dv, B, H, S, sq, sk, sv, sdo, sdq,
                            sdk, sdv, mask_b, stream);
  if (delta == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const size_t S16 = (static_cast<size_t>(S) + 15) & ~static_cast<size_t>(15);
  const size_t heads = sizeof(bf) * 2 * S16 * (kD + 8);
  const size_t smem1 = heads + S16, smem2 = heads + sizeof(float) * 3 * S16;
  cudaError_t err = cudaFuncSetAttribute(
      attention_bwd_dq_kernel<kD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem1));
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(attention_bwd_dkv_kernel<kD>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem2));
  if (err != cudaSuccess) return static_cast<int>(err);
  attention_bwd_dq_kernel<kD><<<B * H, kThreads, smem1, stream>>>(
      static_cast<const bf*>(q), static_cast<const bf*>(k), static_cast<const bf*>(v),
      static_cast<const bf*>(dout), static_cast<const uint8_t*>(mask),
      static_cast<const float*>(stat), static_cast<bf*>(dq), static_cast<float*>(delta), H, S, sq,
      sk, sv, sdo, sdq, mask_b);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  attention_bwd_dkv_kernel<kD><<<B * H, kThreads, smem2, stream>>>(
      static_cast<const bf*>(q), static_cast<const bf*>(k), static_cast<const bf*>(v),
      static_cast<const bf*>(dout), static_cast<const uint8_t*>(mask),
      static_cast<const float*>(stat), static_cast<const float*>(delta), static_cast<bf*>(dk),
      static_cast<bf*>(dv), H, S, sq, sk, sv, sdo, sdk, sdv, mask_b);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, k, v, dout, dq, dk, dv: bf16 [B, H, S, D], D in {16, 32, 64}, S <= 512, each with its own
// element strides (the b, h and s strides in that order; d contiguous, strides divisible by 8,
// 16-byte aligned bases); mask: bool [B, S] with row stride mask_b; stat: the forward's f32
// [B, H, S, 2] (row max, row sum), contiguous; delta: f32 scratch of B*H*S for S > 128, unused
// (may be null) for S <= 128. S <= 128 launches the fused kernel, a longer S the two kernels, on
// `stream`; returns cudaGetLastError() (or the error that kept it from launching).
extern "C" int masked_attention_bwd(const void* q, const void* k, const void* v, const void* dout,
                                    const void* mask, const void* stat, void* delta, void* dq,
                                    void* dk, void* dv, int B, int H, int S, int D,
                                    const long long* strides, long long mask_b, void* stream) {
  const long long* x = strides;  // 7 tensors x (b, h, s): q, k, v, dout, dq, dk, dv
  const Strides sq{x[0], x[1], x[2]}, sk{x[3], x[4], x[5]}, sv{x[6], x[7], x[8]},
      sdo{x[9], x[10], x[11]}, sdq{x[12], x[13], x[14]}, sdk{x[15], x[16], x[17]},
      sdv{x[18], x[19], x[20]};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16:
      return launch<16>(q, k, v, dout, mask, stat, delta, dq, dk, dv, B, H, S, sq, sk, sv, sdo,
                        sdq, sdk, sdv, mask_b, s);
    case 32:
      return launch<32>(q, k, v, dout, mask, stat, delta, dq, dk, dv, B, H, S, sq, sk, sv, sdo,
                        sdq, sdk, sdv, mask_b, s);
    case 64:
      return launch<64>(q, k, v, dout, mask, stat, delta, dq, dk, dv, B, H, S, sq, sk, sv, sdo,
                        sdq, sdk, sdv, mask_b, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The dynamic shared memory a block asks for at head width D and length S on the route S takes
// (0 for another D).
extern "C" int masked_attention_bwd_smem_bytes(int D, int S) {
  const int S16 = (S + 15) & ~15;
  // the larger of the two kernels' blocks: two heads and the per-row m, 1/l and delta
  const auto two_kernels = [S16](int d) { return 2 * 2 * S16 * (d + 8) + 3 * 4 * S16; };
  switch (D) {
    case 16: return S <= kFusedMaxSeq ? FusedLayout<16>::kTotal : two_kernels(16);
    case 32: return S <= kFusedMaxSeq ? FusedLayout<32>::kTotal : two_kernels(32);
    case 64: return S <= kFusedMaxSeq ? FusedLayout<64>::kTotal : two_kernels(64);
    default: return 0;
  }
}

// Blocks a SM of the fused route at head width D and S <= 128 on the current card (0 where it
// does not fit or S is longer).
extern "C" int masked_attention_bwd_blocks_per_sm(int D, int S) {
  const int dev = current_device();
  if (dev < 0 || S < 1 || S > kFusedMaxSeq) return 0;
  switch (D) {
    case 16: return fused_blocks_per_sm<16>(dev);
    case 32: return fused_blocks_per_sm<32>(dev);
    case 64: return fused_blocks_per_sm<64>(dev);
    default: return 0;
  }
}

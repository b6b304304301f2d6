// Masked multi-head attention of the encoder, one launch per layer.
//
// Replaces: pathway_tpu/models/embedder.py, the attention inside `_block` (lines 90-101) and
// `_bert_block` (lines 120-127). The JAX package has no Pallas kernel there: XLA fuses the
// expression under jax.jit. For each (batch b, head h) it computes
//
//   s[i, j] = bf16(q[i] . k[j]) / sqrt(D)     the program's bf16 @ bf16 product, cast to f32
//   s[i, j] = -1e30 where key j is padding    -1e30, not -inf: an all-pad row gets uniform weights
//   p[i, j] = bf16(softmax_j s[i, :])         softmax in f32, then `.astype(bfloat16)`
//   o[i]    = bf16(sum_j p[i, j] v[j])        accumulated in f32
//
// for head widths D of 16, 32 and 64. On request it also writes each query row's softmax
// statistic, the row max m and the sum l of exp(s - m), as f32 pairs [B, H, S, 2]: the backward
// (masked_attention_bwd.cu) recomputes p from them bit for bit as this kernel computed it.
//
// Bound on the H100 at the ingest shape B=1024, H=12, S=128, D=32: memory. q, k, v and o are
// 4 * B*H*S*D * 2 bytes, about 400 MB, or about 120 us at 3.35 TB/s; the 4*B*H*S*S*D = 2.6e10
// operations would take about 26 us at 989 TFLOP/s in bf16.
//
// Design: one block per (b, h), four warps (three or two at D=64 with S above 416, where four
// warps' score buffers and the head's K and V do not fit in shared memory together). The head's K
// and V go into shared memory once, with asynchronous 16-byte copies all in flight together, in
// rows padded so that the tensor cores' operand loads hit distinct banks. A warp takes 16 query
// rows at a time and runs both products on the tensor cores (mma.sync m16n8k16, bf16 in, f32
// accumulated; V's operand comes transposed through ldmatrix). The probabilities are rounded to
// bf16 before the product with V, as the JAX expression casts them, so the softmax needs its max
// and its sum before any probability is known: pass 1 computes the scores once and keeps them in a
// per-thread slice of shared memory with the row max, pass 2 turns them into exponentials and sums
// them, pass 3 divides, rounds and multiplies by V. Each thread reads back only what it wrote, so
// the passes need no barrier. The output is written straight into the caller's layout (strides), so
// the head merge costs nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxWarps = 4;
constexpr int kMaxSmem = 232448;  // the most dynamic shared memory a block may ask for on sm_90
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

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(kFull, v, 1));
  return fmaxf(v, __shfl_xor_sync(kFull, v, 2));
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

// kD: the head width; K and V rows lie kD + 8 apart in shared memory (20, 12 or 36 words), so
// that the eight rows of an operand load start in distinct banks.
template <int kD>
__global__ void __launch_bounds__(kMaxWarps * 32)
masked_attention_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                        const __nv_bfloat16* __restrict__ v, const uint8_t* __restrict__ mask,
                        __nv_bfloat16* __restrict__ o, float* __restrict__ stat, int H, int S,
                        Strides sq, Strides sk, Strides sv, Strides so, long long mask_b) {
  constexpr int kKS = kD + 8;
  extern __shared__ __align__(16) unsigned char smem[];
  const int warps = blockDim.x / 32;
  const int S16 = (S + 15) & ~15;
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem);  // [S16][kKS]
  __nv_bfloat16* vs = ks + S16 * kKS;                           // [S16][kKS]
  // per warp, per 8-key tile, per lane: that lane's 4 scores of the tile
  float4* sb = reinterpret_cast<float4*>(vs + S16 * kKS);       // [warps][S16 / 8][32]
  uint8_t* kind = reinterpret_cast<uint8_t*>(sb + warps * (S16 / 8) * 32);  // [S16]

  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const __nv_bfloat16* qb = q + b * sq.b + h * sq.h;
  const __nv_bfloat16* kb = k + b * sk.b + h * sk.h;
  const __nv_bfloat16* vb = v + b * sv.b + h * sv.h;
  __nv_bfloat16* ob = o + b * so.b + h * so.h;

  for (int e = threadIdx.x; e < S16 * (kD / 8); e += blockDim.x) {  // 16 bytes at a time, async
    const int j = e / (kD / 8), c = (e % (kD / 8)) * 8;
    const int jj = j < S ? j : 0;  // rows past S read nothing and fill with zeros
    cp_async16(ks + j * kKS + c, kb + jj * sk.s + c, j < S);
    cp_async16(vs + j * kKS + c, vb + jj * sv.s + c, j < S);
  }
  asm volatile("cp.async.commit_group;\n" ::);
  for (int j = threadIdx.x; j < S16; j += blockDim.x)
    kind[j] = j >= S ? kAbsent : (mask[b * mask_b + j] ? kReal : kMasked);
  asm volatile("cp.async.wait_all;\n" ::);
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;  // mma fragment coordinates
  // JAX divides by np.sqrt(head_dim) and by the sum; the kernel multiplies by the reciprocals,
  // which moves a score or a probability by at most an f32 ulp before its bf16 rounding
  const float inv_scale = 1.f / sqrtf(static_cast<float>(kD));
  float4* mine = sb + warp * (S16 / 8) * 32 + lane;   // tile j at mine[j * 32]

  for (int r0 = warp * 16; r0 < S; r0 += warps * 16) {
    // q rows r0 + g and r0 + g + 8 as A fragments for the 16-wide steps over d
    uint32_t qa[kD / 16][4];
    const bool lo_in = r0 + g < S, hi_in = r0 + g + 8 < S;
#pragma unroll
    for (int st = 0; st < kD / 16; ++st) {
      const int c = st * 16 + t * 2;
      qa[st][0] = lo_in ? ld32(qb + (r0 + g) * sq.s + c) : 0u;
      qa[st][1] = hi_in ? ld32(qb + (r0 + g + 8) * sq.s + c) : 0u;
      qa[st][2] = lo_in ? ld32(qb + (r0 + g) * sq.s + c + 8) : 0u;
      qa[st][3] = hi_in ? ld32(qb + (r0 + g + 8) * sq.s + c + 8) : 0u;
    }

    // pass 1: scores of keys n0 .. n0+7, c.x, c.y for row g and keys n0 + 2t, + 1; c.z, c.w for
    // row g + 8
    float m_lo = -INFINITY, m_hi = -INFINITY;
    for (int n0 = 0; n0 < S16; n0 += 8) {
      float c[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int st = 0; st < kD / 16; ++st) {
        const __nv_bfloat16* kp = ks + (n0 + g) * kKS + st * 16 + t * 2;
        const uint32_t kb2[2] = {ld32(kp), ld32(kp + 8)};
        mma_bf16(c, qa[st], kb2);
      }
      const uint8_t k0 = kind[n0 + t * 2], k1 = kind[n0 + t * 2 + 1];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const uint8_t kk = (i & 1) ? k1 : k0;
        // __fmul_rn: never fused with the subtraction of the max that follows, so the backward
        // recomputes the same number
        c[i] = kk == kReal ? __fmul_rn(bf16_round(c[i]), inv_scale)
                           : (kk == kMasked ? -1e30f : -INFINITY);
      }
      m_lo = fmaxf(m_lo, fmaxf(c[0], c[1]));
      m_hi = fmaxf(m_hi, fmaxf(c[2], c[3]));
      mine[(n0 / 8) * 32] = make_float4(c[0], c[1], c[2], c[3]);
    }
    m_lo = quad_max(m_lo);
    m_hi = quad_max(m_hi);

    // pass 2: exponentials and their sums
    float l_lo = 0.f, l_hi = 0.f;
    for (int j = 0; j < S16 / 8; ++j) {
      float4 c = mine[j * 32];
      c.x = expf(c.x - m_lo);
      c.y = expf(c.y - m_lo);
      c.z = expf(c.z - m_hi);
      c.w = expf(c.w - m_hi);
      l_lo += c.x + c.y;
      l_hi += c.z + c.w;
      mine[j * 32] = c;
    }
    l_lo = quad_sum(l_lo);
    l_hi = quad_sum(l_hi);
    const float inv_lo = 1.f / l_lo, inv_hi = 1.f / l_hi;
    if (stat != nullptr && t == 0) {
      float* st = stat + (static_cast<long long>(blockIdx.x) * S + r0 + g) * 2;
      if (lo_in) *reinterpret_cast<float2*>(st) = make_float2(m_lo, l_lo);
      if (hi_in) *reinterpret_cast<float2*>(st + 16) = make_float2(m_hi, l_hi);
    }

    // pass 3: p = bf16(e / l); the C fragments of two 8-key tiles are the A fragment of one
    // 16-key step against V
    float acc[kD / 8][4] = {};
    for (int k0 = 0; k0 < S16; k0 += 16) {
      const float4 e0 = mine[(k0 / 8) * 32], e1 = mine[(k0 / 8 + 1) * 32];
      const uint32_t pa[4] = {
          pack_bf16(e0.x * inv_lo, e0.y * inv_lo), pack_bf16(e0.z * inv_hi, e0.w * inv_hi),
          pack_bf16(e1.x * inv_lo, e1.y * inv_lo), pack_bf16(e1.z * inv_hi, e1.w * inv_hi),
      };
#pragma unroll
      for (int pair = 0; pair < kD / 16; ++pair) {
        // matrices: keys k0..7 and k0+8..15, for the d tiles 2 pair and 2 pair + 1
        const int mi = lane >> 3;
        const __nv_bfloat16* vp =
            vs + (k0 + (mi & 1) * 8 + (lane & 7)) * kKS + (pair * 2 + (mi >> 1)) * 8;
        uint32_t vb4[4];
        ldmatrix_x4_trans(vb4, vp);
        const uint32_t b0[2] = {vb4[0], vb4[1]}, b1[2] = {vb4[2], vb4[3]};
        mma_bf16(acc[pair * 2], pa, b0);
        mma_bf16(acc[pair * 2 + 1], pa, b1);
      }
    }
#pragma unroll
    for (int nt = 0; nt < kD / 8; ++nt) {
      const int c = nt * 8 + t * 2;
      if (lo_in)
        *reinterpret_cast<__nv_bfloat162*>(ob + (r0 + g) * so.s + c) =
            __floats2bfloat162_rn(acc[nt][0], acc[nt][1]);
      if (hi_in)
        *reinterpret_cast<__nv_bfloat162*>(ob + (r0 + g + 8) * so.s + c) =
            __floats2bfloat162_rn(acc[nt][2], acc[nt][3]);
    }
  }
}

template <int kD>
int launch(const void* q, const void* k, const void* v, const void* mask, void* o, float* stat,
           int B, int H, int S, Strides sq, Strides sk, Strides sv, Strides so, long long mask_b,
           cudaStream_t stream) {
  const size_t S16 = (static_cast<size_t>(S) + 15) & ~static_cast<size_t>(15);
  const size_t fixed = sizeof(__nv_bfloat16) * 2 * S16 * (kD + 8) + S16;
  const size_t per_warp = sizeof(float4) * (S16 / 8) * 32;
  int warps = kMaxWarps;
  while (warps > 1 && fixed + warps * per_warp > kMaxSmem) --warps;
  const size_t smem = fixed + warps * per_warp;
  cudaError_t err = cudaFuncSetAttribute(masked_attention_kernel<kD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  masked_attention_kernel<kD><<<B * H, warps * 32, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const uint8_t*>(mask),
      static_cast<__nv_bfloat16*>(o), stat, H, S, sq, sk, sv, so, mask_b);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, k, v, o: bf16 [B, H, S, D], D in {16, 32, 64}, with the given element strides (d contiguous;
// q, k and v with strides divisible by 8 and 16-byte aligned bases); mask: bool [B, S] with row
// stride mask_b; stat: f32 [B, H, S, 2] contiguous, or null for no statistic. Launches on
// `stream` and returns cudaGetLastError().
extern "C" int masked_attention(const void* q, const void* k, const void* v, const void* mask,
                                void* o, void* stat, int B, int H, int S, int D, long long qb,
                                long long qh, long long qs, long long kb, long long kh,
                                long long ks, long long vb, long long vh, long long vs,
                                long long ob, long long oh, long long os, long long mask_b,
                                void* stream) {
  const Strides sq{qb, qh, qs}, sk{kb, kh, ks}, sv{vb, vh, vs}, so{ob, oh, os};
  float* st = static_cast<float*>(stat);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: return launch<16>(q, k, v, mask, o, st, B, H, S, sq, sk, sv, so, mask_b, s);
    case 32: return launch<32>(q, k, v, mask, o, st, B, H, S, sq, sk, sv, so, mask_b, s);
    case 64: return launch<64>(q, k, v, mask, o, st, B, H, S, sq, sk, sv, so, mask_b, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

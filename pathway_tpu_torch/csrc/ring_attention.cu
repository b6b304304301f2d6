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
// all-pad document attends uniformly, as in the JAX program. No TF32 and no rounding of a product
// or a weight: every product is exact, and the sums differ from the plain version in order only.
//
// Two routes, chosen by the inputs' dtype alone.
//
// bf16 inputs (the long-context path): the tensor-core route. A product of two bf16 values is
// exact in f32, so q . k runs as bf16 mma.sync m16n8k16 with f32 accumulation (D = 8 pads the
// summed dimension to 16 with zeros). The weights p = exp(s - m') are f32 in [0, 1]: each splits
// exactly into three bf16 parts, p1 = bf16(p), p2 = bf16(p - p1), p3 = bf16(p - p1 - p2) (3 x 8
// bits of significand cover f32's 24), and p . v runs as three bf16 mma.sync against the bf16 v,
// the smallest part first. Three parts and not two: two leave a relative error of up to about
// 2^-17 a weight, which a row that attends to one key would carry whole into its output (38% of
// the relative tolerance the ring is held to); the third makes every product exact. Each tile's
// p . v is summed from zero in the tensor cores and added to the rescaled o with one f32 fma, so
// the tensor cores' own rounding of their f32 sums spans 12 products of a tile, not the whole
// block. The exponentials are 2^(x log2 e) on the SFU (ex2.approx), within a few f32 ulp of the
// accurate expf and exact at 0 and -inf; a key's score is one fma, dot * mul + add, with (mul,
// add) = (scale, 0) where kept, (0, -1e30) where masked and (0, -inf) past s_blk. A block of eight
// warps takes 128 query rows of one (b, h), 16 a warp; keys and values come through shared memory
// in tiles of 64 keys, two stages filled by cp.async while the other is read; each warp rescales
// its state once a tile (the flash-attention update), keeping its scores, weights and output
// accumulators in registers; the state is read and written once a launch. Its time is the CUDA
// cores' per-score work (the split, the exponential's operands, the max and the sums) and the
// tensor cores' four products, which overlap little (PERF.md). ptxas (sm_90a): 128 registers at
// D = 32 (8 bytes of spill), 125 at D = 16, 96 at D = 8, 211 at D = 64 (one block a SM).
//
// f32 inputs (the JAX package's dry-run config and the f32 tests): the CUDA-core route. 256
// threads per block over the query rows of one (b, h); a thread takes two rows (one at D = 64) and
// keeps their query vectors and output accumulators in registers. The block walks the key block
// in tiles of 16 keys, cast into shared memory and read by every thread as 16-byte broadcasts;
// the next tile's values are loaded into registers before the current tile is folded. Each tile
// is folded with its own rescaling, by f32 fmas.
//
// Bound on the H100 at the long-context shape (B=4, one rank's 8192 queries against 8192 keys,
// H=12, D=32, bf16): operations. The tensor-core route does 1 + 3 bf16 products, 8 *
// B*H*s*s_blk*D = 8.2e11 operations, about 0.83 ms at 989 TFLOP/s; its B*H*s*s_blk = 3.2e9
// exponentials take about 0.77 ms at the SFU's 16 a clock an SM (132 SMs, 1,980 MHz); the inputs
// and the state are about 0.2 GB, or 0.06 ms at 3.35 TB/s. The f32 route's products, 4 *
// B*H*s*s_blk*D = 4.1e11 f32 operations, would take about 6.2 ms at 67 TFLOP/s on the CUDA
// cores; that route took about 2.5x that on these bf16 inputs (PERF.md).

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

// ---- the CUDA-core route, f32 inputs ---------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(kThreads)
ring_block_kernel(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v,
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
      const float* qp = q + b * sq.b + h * sq.h + row * sq.s;
      const float* op = o + state * D;
#pragma unroll
      for (int d = 0; d < D; ++d) {
        qr[r][d] = qp[d];
        acc[r][d] = op[d];
      }
      mi[r] = m[state];
      li[r] = l[state];
    }
  }

  const float* kp = k + b * sk.b + h * sk.h;
  const float* vp = v + b * sv.b + h * sv.h;
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
        pk[i] = kp[(t0 + j) * sk.s + d];
        pv[i] = vp[(t0 + j) * sv.s + d];
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

// ---- the tensor-core route, bf16 inputs ------------------------------------------------------

constexpr int kTcWarps = 8;
constexpr int kTcThreads = kTcWarps * 32;
constexpr int kTcRows = kTcWarps * 16;  // query rows a block
constexpr int kTcKeys = 64;             // keys a shared-memory tile
constexpr int kTcTiles = kTcKeys / 8;   // its 8-key tiles
constexpr unsigned kFull = 0xffffffffu;

template <int D>
struct Tc {
  // the row stride of a K or V tile in shared memory, in elements: 8 rows of an operand load
  // then start in distinct 16-byte bank groups (24 at D = 8, whose rows are 16 bytes)
  static constexpr int kLd = D == 8 ? 24 : D + 8;
  static constexpr int kSteps = D < 16 ? 1 : D / 16;  // 16-wide steps of q . k over d
  static constexpr int kOut = D / 8;                  // 8-wide tiles of o over d
  static constexpr int kMinBlocks = D == 64 ? 1 : 2;  // registers: o and a tile's sum at D = 64
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float bf16_lo(uint32_t pair) { return __uint_as_float(pair << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t pair) {
  return __uint_as_float(pair & 0xffff0000u);
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

__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t (&r)[2], const __nv_bfloat16* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(a));
}

// exp(x) as 2^(x log2 e) on the SFU (ex2.approx): within a few f32 ulp of expf, exactly 1 at
// x = 0 and 0 at -inf.
__device__ __forceinline__ float exp_sfu(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x * 1.4426950408889634f));
  return y;
}

// (x0, x1) = hi + mid + lo exactly, each a bf16 pair: every difference below is exact in f32,
// and what is left after two roundings has at most 8 significant bits.
__device__ __forceinline__ void split3(float x0, float x1, uint32_t& hi, uint32_t& mid,
                                       uint32_t& lo) {
  hi = pack_bf16(x0, x1);
  const float r0 = x0 - bf16_lo(hi), r1 = x1 - bf16_hi(hi);
  mid = pack_bf16(r0, r1);
  lo = pack_bf16(r0 - bf16_lo(mid), r1 - bf16_hi(mid));
}

template <int D>
__global__ void __launch_bounds__(kTcThreads, Tc<D>::kMinBlocks)
ring_block_tc_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v, const uint8_t* __restrict__ mask,
                     float* __restrict__ o, float* __restrict__ m, float* __restrict__ l,
                     float* __restrict__ out, int H, int s, int s_blk, float scale, Strides sq,
                     Strides sk, Strides sv, Strides so, long long mask_b) {
  using C = Tc<D>;
  constexpr int kLd = C::kLd;
  __shared__ __align__(16) __nv_bfloat16 ks[2][kTcKeys * kLd];
  __shared__ __align__(16) __nv_bfloat16 vs[2][kTcKeys * kLd];
  // per key: its score is dot * mul + add: (scale, 0) where kept, (0, -1e30) where masked,
  // (0, -inf) past s_blk (the key rows there are zeros, so dot = 0)
  __shared__ __align__(8) float key_mul[2][kTcKeys];
  __shared__ __align__(8) float key_add[2][kTcKeys];

  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;  // mma fragment coordinates
  const int r_lo = blockIdx.x * kTcRows + warp * 16 + g, r_hi = r_lo + 8;
  const bool lo_in = r_lo < s, hi_in = r_hi < s;

  const __nv_bfloat16* kp = k + b * sk.b + h * sk.h;
  const __nv_bfloat16* vp = v + b * sv.b + h * sv.h;
  const uint8_t* mp = mask + b * mask_b;
  __nv_bfloat16* const k_smem = &ks[0][0];
  __nv_bfloat16* const v_smem = &vs[0][0];
  float* const mul_smem = &key_mul[0][0];
  float* const add_smem = &key_add[0][0];
  // tile `tile` of keys and values into stage `st` (zeros past s_blk), and its keys' terms
  auto fetch = [&](int tile, int st) {
    const int t0 = tile * kTcKeys;
    for (int e = threadIdx.x; e < kTcKeys * (D / 8); e += kTcThreads) {
      const int j = e / (D / 8), c = (e % (D / 8)) * 8;
      const bool in = t0 + j < s_blk;
      const long long row = in ? t0 + j : 0;
      const int at = (st * kTcKeys + j) * kLd + c;
      cp_async16(k_smem + at, kp + row * sk.s + c, in);
      cp_async16(v_smem + at, vp + row * sv.s + c, in);
    }
    asm volatile("cp.async.commit_group;\n" ::);
    if (threadIdx.x < kTcKeys) {
      const int j = t0 + threadIdx.x;
      const bool kept = j < s_blk && mp[j];
      mul_smem[st * kTcKeys + threadIdx.x] = kept ? scale : 0.f;
      add_smem[st * kTcKeys + threadIdx.x] = kept ? 0.f : (j < s_blk ? kNeg : -INFINITY);
    }
  };
  fetch(0, 0);

  // the query rows r_lo and r_hi as A fragments over d (zeros past s, and past D at D = 8)
  uint32_t qa[C::kSteps][4];
  const __nv_bfloat16* qb = q + b * sq.b + h * sq.h;
#pragma unroll
  for (int st = 0; st < C::kSteps; ++st) {
    const int c = st * 16 + t * 2;
    qa[st][0] = lo_in ? ld32(qb + r_lo * sq.s + c) : 0u;
    qa[st][1] = hi_in ? ld32(qb + r_hi * sq.s + c) : 0u;
    qa[st][2] = D >= 16 && lo_in ? ld32(qb + r_lo * sq.s + c + 8) : 0u;
    qa[st][3] = D >= 16 && hi_in ? ld32(qb + r_hi * sq.s + c + 8) : 0u;
  }
  // the state of rows r_lo and r_hi: o's columns 8 nt + 2 t and + 1, the row max, and this
  // lane's share of the row sum (lane t = 0 holds the sum so far)
  const long long st_lo = static_cast<long long>(bh) * s + r_lo, st_hi = st_lo + 8;
  float acc[C::kOut][4];
#pragma unroll
  for (int nt = 0; nt < C::kOut; ++nt) {
    const int c = nt * 8 + t * 2;
    const float2 x = lo_in ? *reinterpret_cast<const float2*>(o + st_lo * D + c)
                           : make_float2(0.f, 0.f);
    const float2 y = hi_in ? *reinterpret_cast<const float2*>(o + st_hi * D + c)
                           : make_float2(0.f, 0.f);
    acc[nt][0] = x.x;
    acc[nt][1] = x.y;
    acc[nt][2] = y.x;
    acc[nt][3] = y.y;
  }
  float mi[2] = {lo_in ? m[st_lo] : kNeg, hi_in ? m[st_hi] : kNeg};
  float li[2] = {lo_in && t == 0 ? l[st_lo] : 0.f, hi_in && t == 0 ? l[st_hi] : 0.f};

  const int n_tiles = (s_blk + kTcKeys - 1) / kTcKeys;
  const int mi8 = lane >> 3;  // the ldmatrix matrix this lane addresses
  for (int it = 0; it < n_tiles; ++it) {
    const int st = it & 1;
    __syncthreads();  // every warp is done with tile it - 1, whose stage the next fetch fills
    if (it + 1 < n_tiles) {
      fetch(it + 1, st ^ 1);
      asm volatile("cp.async.wait_group 1;\n" ::);
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::);
    }
    __syncthreads();  // tile it is in shared memory
    const __nv_bfloat16* kt = ks[st];
    const __nv_bfloat16* vt = vs[st];

    // scores: sc[n][0], sc[n][1] for row r_lo and keys 8 n + 2 t, + 1; sc[n][2], sc[n][3] for
    // r_hi; scaled, -1e30 where masked, -inf past s_blk (weight exactly 0)
    float sc[kTcTiles][4];
    float tmax[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < kTcTiles; ++n) {
#pragma unroll
      for (int i = 0; i < 4; ++i) sc[n][i] = 0.f;
#pragma unroll
      for (int st2 = 0; st2 < C::kSteps; ++st2) {
        const __nv_bfloat16* bp = kt + (n * 8 + g) * kLd + st2 * 16 + t * 2;
        const uint32_t kb[2] = {ld32(bp), D >= 16 ? ld32(bp + 8) : 0u};
        mma_bf16(sc[n], qa[st2], kb);
      }
      // fma(dot, scale, 0) is the rounded product; fma(dot, 0, add) is add
      const float2 mul = *reinterpret_cast<const float2*>(&key_mul[st][n * 8 + t * 2]);
      const float2 add = *reinterpret_cast<const float2*>(&key_add[st][n * 8 + t * 2]);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        sc[n][i] = fmaf(sc[n][i], (i & 1) ? mul.y : mul.x, (i & 1) ? add.y : add.x);
        tmax[i >> 1] = fmaxf(tmax[i >> 1], sc[n][i]);
      }
    }
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m_new = fmaxf(mi[r], quad_max(tmax[r]));
      corr[r] = exp_sfu(mi[r] - m_new);
      li[r] *= corr[r];
      mi[r] = m_new;
    }
#pragma unroll
    for (int n = 0; n < kTcTiles; ++n) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        sc[n][i] = exp_sfu(sc[n][i] - mi[i >> 1]);
        li[i >> 1] += sc[n][i];
      }
    }

    // p . v over the tile's 16-key steps, the weights in three exact bf16 parts, summed from zero
    float tacc[C::kOut][4];
#pragma unroll
    for (int nt = 0; nt < C::kOut; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) tacc[nt][i] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kTcTiles / 2; ++kk) {
      uint32_t p1[4], p2[4], p3[4];  // the A fragments of keys 16 kk .. 16 kk + 15
      split3(sc[2 * kk][0], sc[2 * kk][1], p1[0], p2[0], p3[0]);
      split3(sc[2 * kk][2], sc[2 * kk][3], p1[1], p2[1], p3[1]);
      split3(sc[2 * kk + 1][0], sc[2 * kk + 1][1], p1[2], p2[2], p3[2]);
      split3(sc[2 * kk + 1][2], sc[2 * kk + 1][3], p1[3], p2[3], p3[3]);
      if constexpr (D == 8) {
        uint32_t vb[2];
        ldmatrix_x2_trans(vb, vt + (kk * 16 + (lane & 15)) * kLd);
        mma_bf16(tacc[0], p3, vb);
        mma_bf16(tacc[0], p2, vb);
        mma_bf16(tacc[0], p1, vb);
      } else {
#pragma unroll
        for (int pair = 0; pair < C::kOut / 2; ++pair) {
          // matrices: keys 16 kk .. + 7 and + 8 .. + 15, for the d tiles 2 pair and 2 pair + 1
          uint32_t vb4[4];
          const int row = kk * 16 + (mi8 & 1) * 8 + (lane & 7);
          ldmatrix_x4_trans(vb4, vt + row * kLd + (pair * 2 + (mi8 >> 1)) * 8);
          const uint32_t b0[2] = {vb4[0], vb4[1]}, b1[2] = {vb4[2], vb4[3]};
          mma_bf16(tacc[pair * 2], p3, b0);
          mma_bf16(tacc[pair * 2], p2, b0);
          mma_bf16(tacc[pair * 2], p1, b0);
          mma_bf16(tacc[pair * 2 + 1], p3, b1);
          mma_bf16(tacc[pair * 2 + 1], p2, b1);
          mma_bf16(tacc[pair * 2 + 1], p1, b1);
        }
      }
    }
#pragma unroll
    for (int nt = 0; nt < C::kOut; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[nt][i] = fmaf(acc[nt][i], corr[i >> 1], tacc[nt][i]);
  }

  const float l_tot[2] = {quad_sum(li[0]), quad_sum(li[1])};
  float* ob = out == nullptr ? nullptr : out + b * so.b + h * so.h;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r == 0 ? r_lo : r_hi;
    if (row >= s) continue;
    const long long state = r == 0 ? st_lo : st_hi;
#pragma unroll
    for (int nt = 0; nt < C::kOut; ++nt)
      *reinterpret_cast<float2*>(o + state * D + nt * 8 + t * 2) =
          make_float2(acc[nt][r * 2], acc[nt][r * 2 + 1]);
    if (t == 0) {
      m[state] = mi[r];
      l[state] = l_tot[r];
    }
    if (ob != nullptr) {
      const float denom = fmaxf(l_tot[r], 1e-30f);
      float* dst = ob + row * so.s;
#pragma unroll
      for (int nt = 0; nt < C::kOut; ++nt) {
        dst[nt * 8 + t * 2] = acc[nt][r * 2] / denom;
        dst[nt * 8 + t * 2 + 1] = acc[nt][r * 2 + 1] / denom;
      }
    }
  }
}

template <int D>
int launch_f32(const void* q, const void* k, const void* v, const void* mask, void* o, void* m,
               void* l, void* out, int B, int H, int s, int s_blk, float scale, Strides sq,
               Strides sk, Strides sv, Strides so, long long mask_b, cudaStream_t stream) {
  constexpr int rows = kThreads * rows_per_thread<D>();
  const dim3 grid((s + rows - 1) / rows, B * H);
  ring_block_kernel<D><<<grid, kThreads, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const uint8_t*>(mask), static_cast<float*>(o), static_cast<float*>(m),
      static_cast<float*>(l), static_cast<float*>(out), H, s, s_blk, scale, sq, sk, sv, so,
      mask_b);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_tc(const void* q, const void* k, const void* v, const void* mask, void* o, void* m,
              void* l, void* out, int B, int H, int s, int s_blk, float scale, Strides sq,
              Strides sk, Strides sv, Strides so, long long mask_b, cudaStream_t stream) {
  using bf = __nv_bfloat16;
  const dim3 grid((s + kTcRows - 1) / kTcRows, B * H);
  ring_block_tc_kernel<D><<<grid, kTcThreads, 0, stream>>>(
      static_cast<const bf*>(q), static_cast<const bf*>(k), static_cast<const bf*>(v),
      static_cast<const uint8_t*>(mask), static_cast<float*>(o), static_cast<float*>(m),
      static_cast<float*>(l), static_cast<float*>(out), H, s, s_blk, scale, sq, sk, sv, so,
      mask_b);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch(int is_bf16, const void* q, const void* k, const void* v, const void* mask, void* o,
           void* m, void* l, void* out, int B, int H, int s, int s_blk, float scale, Strides sq,
           Strides sk, Strides sv, Strides so, long long mask_b, cudaStream_t stream) {
  if (is_bf16)
    return launch_tc<D>(q, k, v, mask, o, m, l, out, B, H, s, s_blk, scale, sq, sk, sv, so,
                        mask_b, stream);
  return launch_f32<D>(q, k, v, mask, o, m, l, out, B, H, s, s_blk, scale, sq, sk, sv, so, mask_b,
                       stream);
}

}  // namespace

// q [B, H, s, D], k and v [B, H, s_blk, D]: bf16 (is_bf16 = 1) or f32, with d contiguous (bf16:
// the other strides divisible by 8 and 16-byte aligned bases; f32: any strides); mask: bytes
// [B, s_blk] (non-zero keeps the key), row stride mask_b; o f32 [B, H, s, D], m and l f32
// [B, H, s], all contiguous, updated in place; out: null, or f32 [B, H, s, D] with d contiguous,
// written with o / max(l, 1e-30). bf16 takes the tensor-core route, f32 the CUDA-core route.
// Launches on `stream` and returns cudaGetLastError().
extern "C" int ring_block_attention(const void* q, const void* k, const void* v,
                                    const void* mask, void* o, void* m, void* l, void* out,
                                    int is_bf16, int B, int H, int s, int s_blk, int D,
                                    float scale, long long qb, long long qh, long long qs,
                                    long long kb, long long kh, long long ks, long long vb,
                                    long long vh, long long vs, long long ob, long long oh,
                                    long long os, long long mask_b, void* stream) {
  const Strides sq{qb, qh, qs}, sk{kb, kh, ks}, sv{vb, vh, vs}, so{ob, oh, os};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 8: return launch<8>(is_bf16, q, k, v, mask, o, m, l, out, B, H, s, s_blk, scale, sq, sk, sv, so, mask_b, st);
    case 16: return launch<16>(is_bf16, q, k, v, mask, o, m, l, out, B, H, s, s_blk, scale, sq, sk, sv, so, mask_b, st);
    case 32: return launch<32>(is_bf16, q, k, v, mask, o, m, l, out, B, H, s, s_blk, scale, sq, sk, sv, so, mask_b, st);
    case 64: return launch<64>(is_bf16, q, k, v, mask, o, m, l, out, B, H, s, s_blk, scale, sq, sk, sv, so, mask_b, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

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
// (masked_attention_bwd.cu) recomputes p from them bit for bit as this kernel computed it, so both
// products stay on mma.sync m16n8k16 (bf16 in, f32 accumulated), the backward's own instruction,
// and every per-element formula stays as the backward writes it.
//
// Bound on the H100 at the ingest shape B=1024, H=12, S=128, D=32: memory. q, k, v and o are
// 4 * B*H*S*D * 2 bytes, about 400 MB, or about 120 us at 3.35 TB/s; the 4*B*H*S*S*D = 2.6e10
// operations would take about 26 us at 989 TFLOP/s in bf16.
//
// Two routes, chosen by S alone:
//
// S <= 128 (every launch of the encoder's main paths): a persistent kernel of eight warps, two CTAs
// a SM at D <= 32 (one at D = 64), as many as the occupancy calculator fits; the grid walks the
// (b, h) tiles, heads of one sequence next to each other, so neighbouring CTAs read neighbouring
// bytes of the fused qkv rows. Lane 0 of warp 0 keeps a ring of three shared-memory stages full:
// each holds one head's Q, K and V tiles of 128 rows, of which TMA fills the first S16 (S rounded
// up to 16) through 4-D tensor maps over (d, h, s, b) with the callers' strides, so views of the
// fused qkv product load as they are; rows from S to S16 come back as zeros, and rows past S16,
// zeroed once, stay zero. Each stage has a `full` mbarrier (the TMA bytes) and an `empty` one (the
// eight warps' arrivals); a stage is refilled two tiles after its use, so that lane never waits in
// practice. The key mask is too narrow for a TMA box: each lane loads four bytes one tile ahead,
// chosen so that one ballot gives each lane the 32 bits of its own keys. A warp takes 16 query rows
// against all 128 keys, every loop of compile-time length: its products stay in registers as bf16
// pairs, a key that is not real masked to -inf by one prmt and one lop3 a pair, the row max taken
// on the pairs (the scaling rounds monotonically) and scaled once; the exponentials, in floats,
// replace them (64 a thread); the row sums come from quad shuffles; p is rounded to bf16 in
// registers and is the A operand of the product with V (ldmatrix.trans). A key that is not real
// weighs expf(-inf) = +0, its old weight exactly, except in a row whose max is -1e30 (no real key
// above it), where a masked key weighs 1: a warp with such a row fixes those weights up. The tiles
// are laid out by TMA's swizzle for rows of 2 D bytes, so the operand loads hit distinct banks.
// Each warp stages its 16 output rows in shared memory and stores them with TMA into the
// [B, S, H, D] layout; rows past S are clipped by the tensor map. The statistic uses plain stores.
// What bounds it is the per-score arithmetic the backward must repeat bit for bit (the accurate
// expf, two bf16 roundings, about 14 instructions a score), not the bytes: PERF.md has the
// measurements.
//
// S > 128 (tests and long bert inputs, up to 512): the per-head kernel. One block per (b, h), four
// warps (three or two at D=64 with S above 416, where four warps' score buffers and the head's K
// and V do not fit in shared memory together). The head's K and V go into shared memory once, with
// asynchronous 16-byte copies, in rows padded so that the tensor cores' operand loads hit distinct
// banks. A warp takes 16 query rows at a time: pass 1 computes the scores once and keeps them in a
// per-thread slice of shared memory with the row max, pass 2 turns them into exponentials and sums
// them, pass 3 divides, rounds and multiplies by V. Each thread reads back only what it wrote, so
// the passes need no barrier. The output is written straight into the caller's layout.

#include <cuda.h>  // CUtensorMap and its enums; the encoder comes through the runtime, no -lcuda
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

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t a) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

__device__ __forceinline__ void ldmatrix_x2(uint32_t& r0, uint32_t& r1, uint32_t a) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r0), "=r"(r1)
               : "r"(a));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t a) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const __nv_bfloat16* p) {
  ldmatrix_x4_trans(r, smem_addr(p));
}

// ---- the per-head route, S > 128 -------------------------------------------------------------
//
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

// ---- the persistent route, S <= 128 -------------------------------------------------------

constexpr int kTmaMaxSeq = 128;  // the keys a warp's scores hold in registers
constexpr int kTmaWarps = 8;     // 16 query rows each: 128 rows
constexpr int kTmaThreads = kTmaWarps * 32;

template <int kD>
struct Tma {
  // stages in the ring; the stage of tile i is refilled (with tile i + 3) as tile i + 2 begins,
  // when every warp is long done with it. Three measured faster than four (PERF.md)
  static constexpr int kStages = 3;
  // two CTAs a SM at D <= 32 (16 warps, 128 registers a thread), one at D = 64 (shared memory)
  static constexpr int kMinBlocks = kD == 64 ? 1 : 2;
  static constexpr int kRowBytes = kD * 2;  // 32, 64 or 128 bytes: the TMA swizzle of that span
};

__host__ __device__ constexpr int round_1k(int x) { return (x + 1023) & ~1023; }

// Shared memory of one CTA, from a 1024-byte aligned base: the stages (Q, K and V tiles of 128
// rows, of which TMA fills the first S16), one output tile of 16 rows per warp, the barriers.
template <int kD>
struct TmaLayout {
  int tile, stage, o_slot, o_off, bar_off, total;
  __host__ __device__ TmaLayout()
      : tile(round_1k(kTmaMaxSeq * kD * 2)),
        stage(3 * tile),
        o_slot(round_1k(16 * kD * 2)),
        o_off(Tma<kD>::kStages * stage),
        bar_off(o_off + kTmaWarps * o_slot),
        total(bar_off + 2 * Tma<kD>::kStages * 8 + 1024) {}  // + 1024: aligning the base
};

// The byte offset of 16-byte chunk `chunk` of row `row` in a tile of 2 kD-byte rows, as TMA's
// swizzle for that span lays it out (32, 64 or 128 bytes: bits 4 and up of the offset XORed with
// bits 7 and up). The eight rows of an ldmatrix or of a fragment's loads then hit distinct banks.
// Moving down 8 rows adds 8 row widths and leaves the XOR as it was, so a lane's offsets for
// rows 8 i + r are 8 i row widths past those for row r.
template <int kD>
__device__ __forceinline__ uint32_t swz(int row, int chunk) {
  const uint32_t off = row * Tma<kD>::kRowBytes + chunk * 16;
  return off ^ (((off >> 7) & (Tma<kD>::kRowBytes / 16 - 1)) << 4);
}

constexpr uint32_t kNegInfPair = 0xff80ff80u;  // two bf16 -inf

// The key a lane's mask byte i comes from: lane L's byte i is key 8 (L % 16) + 2 i + L / 16, so
// that the ballot of bytes i is the word a lane (g, i) needs, bit j for key 8 j + 2 i and bit
// 16 + j for key 8 j + 2 i + 1 (j the key tile of 8).
__device__ __forceinline__ int mask_key(int lane, int i) {
  return 8 * (lane & 15) + 2 * i + (lane >> 4);
}

// The halves of a bf16 pair to keep, from key tile j's two bits of that word: all ones where
// the key is real. Bit j goes to bit 7, bit 16 + j to bit 23, and prmt replicates those signs
// over bytes 0-1 and 2-3.
__device__ __forceinline__ uint32_t keep_mask(uint32_t word, int j) {
  const uint32_t y = j <= 7 ? word << (7 - j) : word >> (j - 7);
  uint32_t keep;
  asm("prmt.b32 %0, %1, 0, 0xaa88;\n" : "=r"(keep) : "r"(y));
  return keep;
}

__device__ __forceinline__ float bf16_lo(uint32_t pair) { return __uint_as_float(pair << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t pair) {
  return __uint_as_float(pair & 0xffff0000u);
}

__device__ __forceinline__ __nv_bfloat162 as_bf162(uint32_t bits) {
  return *reinterpret_cast<const __nv_bfloat162*>(&bits);
}

__device__ __forceinline__ uint32_t as_u32(__nv_bfloat162 pair) {
  return *reinterpret_cast<const uint32_t*>(&pair);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_arrive_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int h, int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(0), "r"(h), "r"(0), "r"(b)
      : "memory");
}

__device__ __forceinline__ void tma_store(const CUtensorMap* map, uint32_t src, int h, int s,
                                          int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, %4, %5}], [%1];\n"
      ::"l"(reinterpret_cast<uint64_t>(map)), "r"(src), "r"(0), "r"(h), "r"(s), "r"(b)
      : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// acc += q . k for keys row0 .. row0 + 7 of the K tile at `ks_rows` (its row row0), the C
// fragment of one 8-key tile; k_off: this lane's ldmatrix offsets for rows 0 .. 7.
template <int kD>
__device__ __forceinline__ void qk_tile(float (&acc)[4], const uint32_t (&qa)[kD / 16][4],
                                        uint32_t ks_rows,
                                        const uint32_t (&k_off)[kD == 16 ? 1 : kD / 32]) {
  uint32_t kb[kD / 8];
  if constexpr (kD == 16) {
    ldmatrix_x2(kb[0], kb[1], ks_rows + k_off[0]);
  } else {
#pragma unroll
    for (int c4 = 0; c4 < kD / 32; ++c4) {
      uint32_t r4[4];
      ldmatrix_x4(r4, ks_rows + k_off[c4]);
#pragma unroll
      for (int i = 0; i < 4; ++i) kb[c4 * 4 + i] = r4[i];
    }
  }
#pragma unroll
  for (int st = 0; st < kD / 16; ++st) {
    const uint32_t b2[2] = {kb[2 * st], kb[2 * st + 1]};
    mma_bf16(acc, qa[st], b2);
  }
}

// Lane `lane`'s mask bytes of sequence b, byte i from mask_key(lane, i) (0 past S, or where
// there is no tile), in one word; loaded one tile ahead of their use.
__device__ __forceinline__ uint32_t load_mask(const uint8_t* __restrict__ mask, bool any, int b,
                                              int S, long long mask_b, int lane) {
  const uint8_t* row = mask + b * mask_b;
  uint32_t bytes = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = mask_key(lane, i);
    if (any && key < S) bytes |= static_cast<uint32_t>(row[key] != 0) << (8 * i);
  }
  return bytes;
}

template <int kD>
__global__ void __launch_bounds__(kTmaThreads, Tma<kD>::kMinBlocks)
masked_attention_tma_kernel(const __grid_constant__ CUtensorMap tq,
                            const __grid_constant__ CUtensorMap tk,
                            const __grid_constant__ CUtensorMap tv,
                            const __grid_constant__ CUtensorMap to,
                            const uint8_t* __restrict__ mask, float* __restrict__ stat, int B,
                            int H, int S, long long mask_b) {
  constexpr int kStages = Tma<kD>::kStages;
  constexpr int kRB = Tma<kD>::kRowBytes;
  extern __shared__ unsigned char smem_raw[];
  const int S16 = (S + 15) & ~15;
  const TmaLayout<kD> lay;
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;  // shared-window address of the aligned base
  const uint32_t full0 = base + lay.bar_off, empty0 = full0 + 8 * kStages;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int tiles = B * H;
  const uint32_t bytes = 3u * S16 * kD * 2;  // a stage's TMA bytes, zeros past S included

  // lane 0 of warp 0 keeps the ring full: tile blockIdx.x + i gridDim.x goes to stage i % kStages
  const bool producer = warp == 0 && lane == 0;
  auto fill = [&](int i) {
    const int tile = blockIdx.x + i * gridDim.x;
    if (tile >= tiles) return;
    const int s = i % kStages;
    const uint32_t full = full0 + 8 * s, dst = base + s * lay.stage;
    mbar_arrive_tx(full, bytes);
    tma_load(dst, &tq, full, tile % H, tile / H);
    tma_load(dst + lay.tile, &tk, full, tile % H, tile / H);
    tma_load(dst + 2 * lay.tile, &tv, full, tile % H, tile / H);
  };
  if (S16 < kTmaMaxSeq) {  // rows past S16, which TMA never writes, are zeros: keys of nothing
    const int from = S16 * kD * 2, per_tile = lay.tile - from;
    for (int e = threadIdx.x * 16; e < 3 * kStages * per_tile; e += kTmaThreads * 16) {
      const uint32_t at = base + (e / per_tile) * lay.tile + from + e % per_tile;
      asm volatile("st.shared.v4.b32 [%0], {%1, %1, %1, %1};\n" ::"r"(at), "r"(0u) : "memory");
    }
  }
  if (producer) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full0 + 8 * s, 1);  // the producer's arrival, with the TMA bytes
      mbar_init(empty0 + 8 * s, kTmaWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (producer)
    for (int i = 0; i < kStages; ++i) fill(i);

  const int g = lane >> 2, t = lane & 3;  // mma fragment coordinates
  const int mi = lane >> 3, l7 = lane & 7;  // the ldmatrix matrix this lane addresses, and its row
  const int r0 = warp * 16;                 // this warp's query rows r0 .. r0 + 15
  const bool rows_here = r0 < S;
  const bool lo_in = r0 + g < S, hi_in = r0 + g + 8 < S;
  // JAX divides by np.sqrt(head_dim) and by the sum; the kernel multiplies by the reciprocals,
  // which moves a score or a probability by at most an f32 ulp before its bf16 rounding
  const float inv_scale = 1.f / sqrtf(static_cast<float>(kD));
  // this lane's ldmatrix offsets in a tile: Q's for its warp's rows; K's and V's for rows 0 ..
  // 15, to which key tile j adds j * 8 rows (the swizzle repeats every 8 rows)
  uint32_t q_off[kD / 16];
#pragma unroll
  for (int st = 0; st < kD / 16; ++st)
    q_off[st] = r0 * kRB + swz<kD>((mi & 1) * 8 + l7, st * 2 + (mi >> 1));
  uint32_t k_off[kD == 16 ? 1 : kD / 32];
#pragma unroll
  for (int c4 = 0; c4 < (kD == 16 ? 1 : kD / 32); ++c4)
    k_off[c4] = swz<kD>(l7, kD == 16 ? (mi & 1) : c4 * 4 + mi);
  uint32_t v_off[kD / 16];
#pragma unroll
  for (int pair = 0; pair < kD / 16; ++pair)
    v_off[pair] = swz<kD>((mi & 1) * 8 + l7, pair * 2 + (mi >> 1));
  const uint32_t oslot = base + lay.o_off + warp * lay.o_slot;

  // (b, h) of this CTA's tiles, stepped on without a division
  const int step_b = gridDim.x / H, step_h = gridDim.x % H;
  int b = blockIdx.x / H, h = blockIdx.x % H;
  uint32_t mk = load_mask(mask, true, b, S, mask_b, lane);
  int it = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x, ++it) {
    if (producer && it >= 2) {  // refill tile it - 2's stage, which every warp has left
      const int done = it - 2;
      mbar_wait(empty0 + 8 * (done % kStages), (done / kStages) & 1);
      fill(done + kStages);
    }
    __syncwarp();
    // which keys are real: this lane's word (mask_key), and whether a key below S is masked;
    // then the next tile's bytes
    uint32_t words[4];
    bool masked_here = false;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const bool is_real = (mk >> (8 * i)) & 1u;
      words[i] = __ballot_sync(kFull, is_real);
      masked_here |= !is_real && mask_key(lane, i) < S;
    }
    const uint32_t real = t == 0 ? words[0] : t == 1 ? words[1] : t == 2 ? words[2] : words[3];
    const bool any_masked = __any_sync(kFull, masked_here);
    const int b_next = b + step_b + (h + step_h >= H ? 1 : 0);
    mk = load_mask(mask, tile + gridDim.x < tiles, b_next, S, mask_b, lane);
    // -1e30 where the sequence has a masked key below S: the max of s over all keys is the max
    // over the real ones and this
    const float floor_s = any_masked ? -1e30f : -INFINITY;

    const int s = it % kStages;
    mbar_wait(full0 + 8 * s, (it / kStages) & 1);
    if (rows_here) {
      const uint32_t qs = base + s * lay.stage, ks = qs + lay.tile, vs = qs + 2 * lay.tile;
      // q rows r0 + g and r0 + g + 8 as A fragments for the 16-wide steps over d
      uint32_t qa[kD / 16][4];
#pragma unroll
      for (int st = 0; st < kD / 16; ++st) ldmatrix_x4(qa[st], qs + q_off[st]);

      // pass 1, the products, over all 128 keys (those past S16 are zero rows): d[j][0] holds
      // bf16(q . k) of row g against keys 8 j + 2 t and 8 j + 2 t + 1 as a bf16 pair, d[j][1]
      // those of row g + 8; a key that is not real holds -inf. s = bf16(q . k) * (1 / sqrt(D))
      // rounds monotonically, so the row max of s over the real keys is the max of the pairs,
      // scaled once. A masked key scores -1e30 and the pad past S -inf.
      uint32_t d[kTmaMaxSeq / 8][2];
      __nv_bfloat162 dmax_lo = as_bf162(kNegInfPair), dmax_hi = dmax_lo;
#pragma unroll
      for (int j = 0; j < kTmaMaxSeq / 8; ++j) {
        float p4[4] = {0.f, 0.f, 0.f, 0.f};
        qk_tile<kD>(p4, qa, ks + j * 8 * kRB, k_off);
        const uint32_t keep = keep_mask(real, j);
        d[j][0] = (pack_bf16(p4[0], p4[1]) & keep) | (kNegInfPair & ~keep);
        d[j][1] = (pack_bf16(p4[2], p4[3]) & keep) | (kNegInfPair & ~keep);
        dmax_lo = __hmax2(dmax_lo, as_bf162(d[j][0]));
        dmax_hi = __hmax2(dmax_hi, as_bf162(d[j][1]));
      }
      const uint32_t mx_lo = as_u32(dmax_lo), mx_hi = as_u32(dmax_hi);
      const float m_lo =
          fmaxf(__fmul_rn(quad_max(fmaxf(bf16_lo(mx_lo), bf16_hi(mx_lo))), inv_scale), floor_s);
      const float m_hi =
          fmaxf(__fmul_rn(quad_max(fmaxf(bf16_lo(mx_hi), bf16_hi(mx_hi))), inv_scale), floor_s);

      // pass 2, e = expf(s - m): a key that is not real gives expf(-inf) = +0, which is its old
      // weight, expf(-1e30 - m) or expf(-inf - m), exactly, wherever m is above -1e30. A row
      // whose max is -1e30 (no real key above it) gives its masked keys the weight 1 instead.
      float c[kTmaMaxSeq / 8][4];
#pragma unroll
      for (int j = 0; j < kTmaMaxSeq / 8; ++j) {
        c[j][0] = expf(__fsub_rn(__fmul_rn(bf16_lo(d[j][0]), inv_scale), m_lo));
        c[j][1] = expf(__fsub_rn(__fmul_rn(bf16_hi(d[j][0]), inv_scale), m_lo));
        c[j][2] = expf(__fsub_rn(__fmul_rn(bf16_lo(d[j][1]), inv_scale), m_hi));
        c[j][3] = expf(__fsub_rn(__fmul_rn(bf16_hi(d[j][1]), inv_scale), m_hi));
      }
      if (__any_sync(kFull, m_lo == -1e30f || m_hi == -1e30f)) {
        const float w_lo = m_lo == -1e30f ? 1.f : 0.f, w_hi = m_hi == -1e30f ? 1.f : 0.f;
#pragma unroll
        for (int j = 0; j < kTmaMaxSeq / 8; ++j) {
          const int k0 = j * 8 + 2 * t;  // real: bit j of this lane's word; k0 + 1: bit 16 + j
          if (!((real >> j) & 1u) && k0 < S) {
            c[j][0] = w_lo;
            c[j][2] = w_hi;
          }
          if (!((real >> (16 + j)) & 1u) && k0 + 1 < S) {
            c[j][1] = w_lo;
            c[j][3] = w_hi;
          }
        }
      }
      // the sum in key order, as every route of this kernel takes it (zeros add nothing)
      float l_lo = 0.f, l_hi = 0.f;
#pragma unroll
      for (int j = 0; j < kTmaMaxSeq / 8; ++j) {
        l_lo += c[j][0] + c[j][1];
        l_hi += c[j][2] + c[j][3];
      }
      l_lo = quad_sum(l_lo);
      l_hi = quad_sum(l_hi);
      const float inv_lo = 1.f / l_lo, inv_hi = 1.f / l_hi;
      if (stat != nullptr && t == 0) {
        float* st = stat + (static_cast<long long>(tile) * S + r0 + g) * 2;
        if (lo_in) *reinterpret_cast<float2*>(st) = make_float2(m_lo, l_lo);
        if (hi_in) *reinterpret_cast<float2*>(st + 16) = make_float2(m_hi, l_hi);
      }

      // p = bf16(e / l); the C fragments of key tiles 2 kk and 2 kk + 1 are the A fragment of one
      // 16-key step against V
      float acc[kD / 8][4] = {};
#pragma unroll
      for (int kk = 0; kk < kTmaMaxSeq / 16; ++kk) {
        {
          const float(&e0)[4] = c[2 * kk];
          const float(&e1)[4] = c[2 * kk + 1];
          const uint32_t pa[4] = {
              pack_bf16(__fmul_rn(e0[0], inv_lo), __fmul_rn(e0[1], inv_lo)),
              pack_bf16(__fmul_rn(e0[2], inv_hi), __fmul_rn(e0[3], inv_hi)),
              pack_bf16(__fmul_rn(e1[0], inv_lo), __fmul_rn(e1[1], inv_lo)),
              pack_bf16(__fmul_rn(e1[2], inv_hi), __fmul_rn(e1[3], inv_hi)),
          };
#pragma unroll
          for (int pair = 0; pair < kD / 16; ++pair) {
            // matrices: keys 16 kk .. + 7 and + 8 .. + 15, for the d tiles 2 pair and 2 pair + 1
            uint32_t vb4[4];
            ldmatrix_x4_trans(vb4, vs + v_off[pair] + kk * 16 * kRB);
            const uint32_t b0[2] = {vb4[0], vb4[1]}, b1[2] = {vb4[2], vb4[3]};
            mma_bf16(acc[pair * 2], pa, b0);
            mma_bf16(acc[pair * 2 + 1], pa, b1);
          }
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty0 + 8 * s);  // this warp is done with the stage

      // the output tile: this warp's previous store has read its slot before it is written again
      if (lane == 0) asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
      __syncwarp();
#pragma unroll
      for (int nt = 0; nt < kD / 8; ++nt) {
        const __nv_bfloat162 lo = __floats2bfloat162_rn(acc[nt][0], acc[nt][1]);
        const __nv_bfloat162 hi = __floats2bfloat162_rn(acc[nt][2], acc[nt][3]);
        asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(oslot + swz<kD>(g, nt) + t * 4),
                     "r"(*reinterpret_cast<const uint32_t*>(&lo)));
        asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(oslot + swz<kD>(g + 8, nt) + t * 4),
                     "r"(*reinterpret_cast<const uint32_t*>(&hi)));
      }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // visible to the TMA unit
      __syncwarp();
      if (lane == 0) tma_store(&to, oslot, h, r0, b);
    } else {
      __syncwarp();
      if (lane == 0) mbar_arrive(empty0 + 8 * s);  // no rows here: the stage is free at once
    }
    b += step_b + (h + step_h >= H ? 1 : 0);
    h = h + step_h >= H ? h + step_h - H : h + step_h;
  }
  if (lane == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, looked up once through the runtime.
EncodeTiled encoder() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// A 4-D map over (d, h, s, b) of a bf16 [B, H, S, kD] tensor with element strides `st`, whose box
// is `rows` rows of one head. A dimension of one element steps nowhere, so its stride is free.
template <int kD>
bool encode(EncodeTiled enc, CUtensorMap* map, const void* ptr, int B, int H, int S, Strides st,
            int rows) {
  const auto bytes = [](long long stride, int n) -> cuuint64_t {
    return n == 1 || stride <= 0 ? 16 : static_cast<cuuint64_t>(stride) * 2;
  };
  const cuuint64_t dims[4] = {kD, static_cast<cuuint64_t>(H), static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {bytes(st.h, H), bytes(st.s, S), bytes(st.b, B)};
  const cuuint32_t box[4] = {kD, 1, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUtensorMapSwizzle swizzle = kD == 16   ? CU_TENSOR_MAP_SWIZZLE_32B
                                     : kD == 32 ? CU_TENSOR_MAP_SWIZZLE_64B
                                                : CU_TENSOR_MAP_SWIZZLE_128B;
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides, box,
             unit, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

constexpr int kMaxDevices = 64;

int current_device() {
  int dev = 0;
  return cudaGetDevice(&dev) == cudaSuccess && dev >= 0 && dev < kMaxDevices ? dev : -1;
}

int sm_count(int dev) {
  static int count[kMaxDevices] = {};
  if (count[dev] == 0) cudaDeviceGetAttribute(&count[dev], cudaDevAttrMultiProcessorCount, dev);
  return count[dev];
}

// CTAs of the persistent kernel that fit on one SM (0 if none), computed once per device; that
// first call also raises the kernel's dynamic shared memory limit to what it needs.
template <int kD>
int tma_ctas_per_sm(int dev) {
  static int per_sm[kMaxDevices] = {};
  int& n = per_sm[dev];
  if (n == 0 &&
      (cudaFuncSetAttribute(masked_attention_tma_kernel<kD>,
                            cudaFuncAttributeMaxDynamicSharedMemorySize,
                            TmaLayout<kD>().total) != cudaSuccess ||
       cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, masked_attention_tma_kernel<kD>,
                                                     kTmaThreads, TmaLayout<kD>().total) !=
           cudaSuccess))
    n = 0;
  return n;
}

template <int kD>
int launch_tma(const void* q, const void* k, const void* v, const void* mask, void* o,
               float* stat, int B, int H, int S, Strides sq, Strides sk, Strides sv, Strides so,
               long long mask_b, cudaStream_t stream) {
  const EncodeTiled enc = encoder();
  if (enc == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const int S16 = (S + 15) & ~15;
  CUtensorMap mq, mk, mv, mo;
  if (!encode<kD>(enc, &mq, q, B, H, S, sq, S16) || !encode<kD>(enc, &mk, k, B, H, S, sk, S16) ||
      !encode<kD>(enc, &mv, v, B, H, S, sv, S16) || !encode<kD>(enc, &mo, o, B, H, S, so, 16))
    return static_cast<int>(cudaErrorInvalidValue);
  const int dev = current_device();
  if (dev < 0) return static_cast<int>(cudaErrorInvalidDevice);
  const int per_sm = tma_ctas_per_sm<kD>(dev), sms = sm_count(dev);
  if (per_sm < 1 || sms < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const long long tiles = static_cast<long long>(B) * H;
  const int grid = static_cast<int>(tiles < per_sm * sms ? tiles : per_sm * sms);
  masked_attention_tma_kernel<kD><<<grid, kTmaThreads, TmaLayout<kD>().total, stream>>>(
      mq, mk, mv, mo, static_cast<const uint8_t*>(mask), stat, B, H, S, mask_b);
  return static_cast<int>(cudaGetLastError());
}

// The per-head route's block at S: as many warps as fit (at most four), and its shared memory.
template <int kD>
size_t per_head_smem(int S, int* warps) {
  const size_t S16 = (static_cast<size_t>(S) + 15) & ~static_cast<size_t>(15);
  const size_t fixed = sizeof(__nv_bfloat16) * 2 * S16 * (kD + 8) + S16;
  const size_t per_warp = sizeof(float4) * (S16 / 8) * 32;
  *warps = kMaxWarps;
  while (*warps > 1 && fixed + *warps * per_warp > kMaxSmem) --*warps;
  return fixed + *warps * per_warp;
}

template <int kD>
int launch_per_head(const void* q, const void* k, const void* v, const void* mask, void* o,
                    float* stat, int B, int H, int S, Strides sq, Strides sk, Strides sv,
                    Strides so, long long mask_b, cudaStream_t stream) {
  static bool raised[kMaxDevices] = {};  // the limit, once per device
  const int dev = current_device();
  if (dev < 0) return static_cast<int>(cudaErrorInvalidDevice);
  if (!raised[dev]) {
    const cudaError_t err = cudaFuncSetAttribute(
        masked_attention_kernel<kD>, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    raised[dev] = true;
  }
  int warps;
  const size_t smem = per_head_smem<kD>(S, &warps);
  masked_attention_kernel<kD><<<B * H, warps * 32, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const uint8_t*>(mask),
      static_cast<__nv_bfloat16*>(o), stat, H, S, sq, sk, sv, so, mask_b);
  return static_cast<int>(cudaGetLastError());
}

template <int kD>
int launch(const void* q, const void* k, const void* v, const void* mask, void* o, float* stat,
           int B, int H, int S, Strides sq, Strides sk, Strides sv, Strides so, long long mask_b,
           cudaStream_t stream) {
  if (S <= kTmaMaxSeq)
    return launch_tma<kD>(q, k, v, mask, o, stat, B, H, S, sq, sk, sv, so, mask_b, stream);
  return launch_per_head<kD>(q, k, v, mask, o, stat, B, H, S, sq, sk, sv, so, mask_b, stream);
}

}  // namespace

// q, k, v, o: bf16 [B, H, S, D], D in {16, 32, 64}, with the given element strides (d contiguous;
// q, k, v and o with strides divisible by 8 and 16-byte aligned bases); mask: bool [B, S] with row
// stride mask_b; stat: f32 [B, H, S, 2] contiguous, or null for no statistic. S <= 128 takes the
// persistent route, a longer S the per-head one. Launches on `stream` and returns
// cudaGetLastError() (or the error that kept it from launching).
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

// The dynamic shared memory a launch at head width D and length S asks for a block, on the route
// S takes (0 for another D).
extern "C" int masked_attention_smem_bytes(int D, int S) {
  int warps;
  switch (D) {
    case 16: return S <= kTmaMaxSeq ? TmaLayout<16>().total : int(per_head_smem<16>(S, &warps));
    case 32: return S <= kTmaMaxSeq ? TmaLayout<32>().total : int(per_head_smem<32>(S, &warps));
    case 64: return S <= kTmaMaxSeq ? TmaLayout<64>().total : int(per_head_smem<64>(S, &warps));
    default: return 0;
  }
}

// CTAs per SM of the persistent route at head width D and S <= 128 (0 where it does not fit or
// S is longer): the grid is this times the SM count, or B * H where that is smaller.
extern "C" int masked_attention_ctas_per_sm(int D, int S) {
  const int dev = current_device();
  if (dev < 0 || S < 1 || S > kTmaMaxSeq) return 0;
  switch (D) {
    case 16: return tma_ctas_per_sm<16>(dev);
    case 32: return tma_ctas_per_sm<32>(dev);
    case 64: return tma_ctas_per_sm<64>(dev);
    default: return 0;
  }
}

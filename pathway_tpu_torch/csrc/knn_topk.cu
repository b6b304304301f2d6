// Brute-force KNN scoring fused with top-k, never building the [queries, rows] score matrix.
//
// Replaces: pathway_tpu/ops/knn.py `topk_scores` (line 46). The JAX package has no Pallas kernel
// there: XLA runs one bf16 matmul into a [q, n] score matrix, masks it and calls lax.top_k.
// This kernel computes the same function:
//
//   dot[q, r]   = bf16(bf16(query[q]) . bf16(index[r]))   accumulated in f32, rounded like JAX's
//                                                         bf16 @ bf16 -> bf16 product
//   score[q, r] = dot                                      metric "cos" or "ip"
//               = -((|query|^2 - 2 dot) + |index[r]|^2)    metric "l2", both norms in f32
//   score[q, r] = -inf where valid[r] is false
//   out         = the k best (score, r) per query: higher score first, and on equal scores the
//                 lower row first, exactly the order of lax.top_k
//
// Bound on the H100 at the retrieval shape q=64, n=2^20, d=384: memory. The f32 index is 1.61 GB,
// about 0.48 ms at 3.35 TB/s; the 2*q*n*d = 5.2e10 operations would take about 52 us at
// 989 TFLOP/s in bf16.
//
// Design: pass 1 runs blocks over (row range, chunk of QC queries). A block keeps its queries in
// shared memory as bf16 and walks its row range in tiles of 64 rows. Each tile is read from device
// memory once, 128 columns at a time (f32, rounded to bf16 on the way into shared memory, with
// |index|^2 taken from the same f32 values); the loads of the next step are issued before the
// products of the current one, so the index read overlaps the arithmetic. The products run on the
// tensor cores (mma.sync m16n8k16, bf16 in, f32 accumulated). The block then keeps a sorted top-k
// list per query in shared memory: a warp compares a tile's 64 scores with the list's last entry
// by ballot and inserts the few that beat it. Pass 2 merges the blocks' lists, one warp per query.
// Only the lists, q * blocks * k entries, ever reach device memory.
//
// Any width d >= 1. Rows of a width divisible by 4 are read 16 bytes at a time; other widths leave
// rows unaligned and are read one float at a time. The block keeps at most kQW = 1024 columns of
// its queries in shared memory: a wider index is walked in chunks of kQW columns, each chunk's
// queries loaded anew for every tile, and the f32 sum runs on across the chunks, so the dot is
// rounded to bf16 once, at the end, as the program types it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kR = 64;         // index rows per tile
constexpr int kDK = 128;       // feature columns per load step
constexpr int kXS = kDK + 8;   // padded tile row, in bf16: 68 words, no bank conflict
constexpr int kQW = 1024;      // query columns held in shared memory at once (a multiple of kDK)
constexpr int kMergeWarps = 4;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kNoRow = 0x7fffffff;

enum Metric { kDot = 0, kL2 = 1 };

__device__ __forceinline__ float bf16_round_f(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ float warp_sum_f(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
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

__device__ __forceinline__ bool better(float s, int i, float ts, int ti) {
  return s > ts || (s == ts && i < ti);
}

// Insert (s, id) into the sorted list (best first) of length k. The caller has checked that it
// beats the last entry. All 32 lanes of the warp take part.
__device__ void warp_insert(float* ls, int* li, int k, float s, int id, int lane) {
  int pos = 0;
  for (int base = 0; base < k; base += 32) {
    const int e = base + lane;
    pos += __popc(__ballot_sync(kFull, e < k && better(ls[e], li[e], s, id)));
  }
  for (int top = k - 1; top > pos; top -= 32) {  // shift [pos, k-1) up by one, top chunk first
    const int e = top - lane;
    const bool act = e > pos;
    float ms = 0.f;
    int mi = 0;
    if (act) {
      ms = ls[e - 1];
      mi = li[e - 1];
    }
    __syncwarp();
    if (act) {
      ls[e] = ms;
      li[e] = mi;
    }
    __syncwarp();
  }
  if (lane == 0) {
    ls[pos] = s;
    li[pos] = id;
  }
  __syncwarp();
}

// Offer one candidate per lane (`cand` false for none), lowest lane (lowest row) first.
__device__ void warp_offer(float* ls, int* li, int k, bool cand, float s, int id, int lane) {
  unsigned m = __ballot_sync(kFull, cand && better(s, id, ls[k - 1], li[k - 1]));
  while (m) {
    const int src = __ffs(m) - 1;
    const float cs = __shfl_sync(kFull, s, src);
    const int ci = __shfl_sync(kFull, id, src);
    warp_insert(ls, li, k, cs, ci, lane);
    m &= m - 1;
    m &= __ballot_sync(kFull, cand && better(s, id, ls[k - 1], li[k - 1]));
  }
}

__host__ __device__ constexpr size_t align16(size_t x) { return (x + 15) & ~size_t(15); }

struct Layout {
  size_t qs, xs, qn, xn, sc, ls, li, total;
};

__host__ __device__ Layout layout(int qc, int dpad, int k) {
  Layout L{};
  size_t at = 0;
  L.qs = at; at = align16(at + sizeof(__nv_bfloat16) * qc * (dpad + 8));
  L.xs = at; at = align16(at + sizeof(__nv_bfloat16) * kR * kXS);
  L.qn = at; at = align16(at + sizeof(float) * qc);
  L.xn = at; at = align16(at + sizeof(float) * kR);
  L.sc = at; at = align16(at + sizeof(float) * qc * kR);
  L.ls = at; at = align16(at + sizeof(float) * qc * k);
  L.li = at; at = align16(at + sizeof(int) * qc * k);
  L.total = at;
  return L;
}

template <int QC>
__global__ void __launch_bounds__(kThreads)
knn_score_topk_kernel(const float* __restrict__ q, const float* __restrict__ x,
                      const uint8_t* __restrict__ valid, int Q, int N, int d, int k, int metric,
                      int tiles_per_range, float* __restrict__ cand_s, int* __restrict__ cand_i) {
  constexpr int MT = QC / 16;          // 16-query tiles of the block
  constexpr int NT = kR / 8;           // 8-row tiles of an index tile
  constexpr int TPW = MT * NT / kWarps;  // (query tile, row tile) pairs per warp
  constexpr int LPT = kR * kDK / 4 / kThreads;  // float4 loads per thread per step

  extern __shared__ __align__(16) unsigned char smem[];
  const int dpad = (d + kDK - 1) / kDK * kDK;
  const int qw = dpad < kQW ? dpad : kQW;  // query columns in shared memory
  const Layout L = layout(QC, qw, k);
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem + L.qs);  // [QC][qw + 8]
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem + L.xs);  // [kR][kXS]
  float* qn = reinterpret_cast<float*>(smem + L.qn);                  // [QC]
  float* xn = reinterpret_cast<float*>(smem + L.xn);                  // [kR]
  float* sc = reinterpret_cast<float*>(smem + L.sc);                  // [QC][kR]
  float* ls = reinterpret_cast<float*>(smem + L.ls);                  // [QC][k]
  int* li = reinterpret_cast<int*>(smem + L.li);                      // [QC][k]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;  // mma fragment coordinates
  const int q0 = blockIdx.y * QC;
  const int G = gridDim.x;
  const int qstride = qw + 8;
  // queries' columns c0 .. c0 + qw - 1 into shared memory as bf16, zeros past d
  auto load_queries = [&](int c0) {
    for (int e = tid; e < QC * qw; e += kThreads) {
      const int qi = e / qw, c = c0 + e % qw;
      const float val = (q0 + qi < Q && c < d) ? q[static_cast<size_t>(q0 + qi) * d + c] : 0.f;
      qs[qi * qstride + c - c0] = __float2bfloat16_rn(val);
    }
  };
  load_queries(0);
  for (int qi = warp; qi < QC; qi += kWarps) {
    float acc = 0.f;
    if (q0 + qi < Q)
      for (int c = lane; c < d; c += 32) {
        const float val = q[static_cast<size_t>(q0 + qi) * d + c];
        acc += val * val;
      }
    acc = warp_sum_f(acc);
    if (lane == 0) qn[qi] = acc;
  }
  for (int e = tid; e < QC * k; e += kThreads) {
    ls[e] = -INFINITY;
    li[e] = kNoRow;
  }

  const long long rbeg = static_cast<long long>(blockIdx.x) * tiles_per_range * kR;
  const long long rend =
      min(static_cast<long long>(N), rbeg + static_cast<long long>(tiles_per_range) * kR);

  // thread tid loads float4 number tid + u * kThreads of a 64-row step: row (tid / 32) + 8 u,
  // columns 4 (tid % 32) .. +3
  float4 pre[LPT];
  const bool vec = d % 4 == 0;  // rows 16-byte aligned (the wrapper aligns the base)
  auto load = [&](long long row0, int c0) {
#pragma unroll
    for (int u = 0; u < LPT; ++u) {
      const int r = (tid + u * kThreads) / (kDK / 4), c = c0 + (tid % (kDK / 4)) * 4;
      float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
      if (row0 + r < rend && c < d) {
        const float* src = x + (row0 + r) * d + c;
        if (vec) {
          val = *reinterpret_cast<const float4*>(src);
        } else {  // the scalar tail: each of the four columns that lies inside the row
          val.x = src[0];
          if (c + 1 < d) val.y = src[1];
          if (c + 2 < d) val.z = src[2];
          if (c + 3 < d) val.w = src[3];
        }
      }
      pre[u] = val;
    }
  };
  if (rbeg < rend) load(rbeg, 0);
  __syncthreads();

  for (long long row0 = rbeg; row0 < rend; row0 += kR) {
    float acc[TPW][4] = {};
    float nrm[LPT] = {};  // partial |row|^2 of the rows this thread loads

    for (int c0 = 0; c0 < dpad; c0 += kDK) {
      __syncthreads();  // the previous step's readers are done with xs (and qs)
      if (dpad > kQW && c0 % kQW == 0) load_queries(c0);  // the next chunk of a wide index
#pragma unroll
      for (int u = 0; u < LPT; ++u) {
        const float4 val = pre[u];
        const int r = (tid + u * kThreads) / (kDK / 4), c = (tid % (kDK / 4)) * 4;
        nrm[u] += val.x * val.x + val.y * val.y + val.z * val.z + val.w * val.w;
        __nv_bfloat162* dst = reinterpret_cast<__nv_bfloat162*>(xs + r * kXS + c);
        dst[0] = __floats2bfloat162_rn(val.x, val.y);
        dst[1] = __floats2bfloat162_rn(val.z, val.w);
      }
      __syncthreads();
      if (c0 + kDK < dpad)
        load(row0, c0 + kDK);
      else if (row0 + kR < rend)
        load(row0 + kR, 0);
#pragma unroll
      for (int st = 0; st < kDK / 16; ++st) {
        const int mt = warp * TPW / NT;  // every pair of this warp shares its query tile
        const __nv_bfloat16* qp = qs + (mt * 16 + g) * qstride + c0 % kQW + st * 16 + t * 2;
        const uint32_t a[4] = {ld32(qp), ld32(qp + 8 * qstride), ld32(qp + 8),
                               ld32(qp + 8 * qstride + 8)};
#pragma unroll
        for (int p = 0; p < TPW; ++p) {
          const int nt = (warp * TPW + p) % NT;
          const __nv_bfloat16* xp = xs + (nt * 8 + g) * kXS + st * 16 + t * 2;
          const uint32_t b[2] = {ld32(xp), ld32(xp + 8)};
          mma_bf16(acc[p], a, b);
        }
      }
    }

    if (metric == kL2) {
      // the kDK / 4 lanes that loaded one row reduce its |row|^2 together
#pragma unroll
      for (int u = 0; u < LPT; ++u) {
        float v = nrm[u];
        for (int o = kDK / 8; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
        if (tid % (kDK / 4) == 0) xn[(tid + u * kThreads) / (kDK / 4)] = v;
      }
      __syncthreads();
    }

    // acc[p][0], [1]: query mt*16 + g, rows nt*8 + 2t, +1; acc[p][2], [3]: query + 8
#pragma unroll
    for (int p = 0; p < TPW; ++p) {
      const int mt = warp * TPW / NT, nt = (warp * TPW + p) % NT;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int qi = mt * 16 + g + (i >> 1) * 8, r = nt * 8 + t * 2 + (i & 1);
        float s = bf16_round_f(acc[p][i]);
        if (metric == kL2) s = -((qn[qi] - 2.f * s) + xn[r]);
        if (valid != nullptr && row0 + r < rend && !valid[row0 + r]) s = -INFINITY;
        sc[qi * kR + r] = s;
      }
    }
    __syncthreads();

    for (int qi = warp; qi < QC; qi += kWarps) {
      if (q0 + qi >= Q) continue;  // uniform across the warp
#pragma unroll
      for (int half = 0; half < kR / 32; ++half) {
        const int r = half * 32 + lane;
        const bool in = row0 + r < rend;
        warp_offer(ls + qi * k, li + qi * k, k, in, sc[qi * kR + r],
                   static_cast<int>(row0 + r), lane);
      }
    }
  }
  __syncthreads();

  for (int e = tid; e < QC * k; e += kThreads) {
    const int qi = e / k, j = e % k;
    if (q0 + qi >= Q) continue;
    const size_t at = (static_cast<size_t>(q0 + qi) * G + blockIdx.x) * k + j;
    cand_s[at] = ls[e];
    cand_i[at] = li[e];
  }
}

// Pass 2: one warp per query merges the G lists of pass 1. They lie side by side in device memory,
// so the warp reads them 4 x 32 candidates at a time, each read coalesced and all four in flight
// together, and offers each candidate to one list; the order of the offers does not change the
// result, since (score, row) pairs are totally ordered.
__global__ void __launch_bounds__(kMergeWarps * 32)
knn_merge_kernel(const float* __restrict__ cand_s, const int* __restrict__ cand_i, int Q, int G,
                 int k, float* __restrict__ out_s, long long* __restrict__ out_i) {
  constexpr int kBatch = 4;
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int qg = blockIdx.x * kMergeWarps + warp;
  if (qg >= Q) return;  // uniform across the warp; no block-wide barrier follows
  float* ls = reinterpret_cast<float*>(smem) + warp * k;
  int* li = reinterpret_cast<int*>(reinterpret_cast<float*>(smem) + kMergeWarps * k) + warp * k;
  const int total = G * k;
  const float* cs = cand_s + static_cast<size_t>(qg) * total;
  const int* ci = cand_i + static_cast<size_t>(qg) * total;

  for (int j = lane; j < k; j += 32) {
    ls[j] = -INFINITY;
    li[j] = kNoRow;
  }
  __syncwarp();
  for (int base = 0; base < total; base += kBatch * 32) {
    float s[kBatch];
    int id[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int j = base + u * 32 + lane;
      s[u] = j < total ? cs[j] : -INFINITY;
      id[u] = j < total ? ci[j] : kNoRow;
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u)
      warp_offer(ls, li, k, base + u * 32 + lane < total, s[u], id[u], lane);
  }
  for (int j = lane; j < k; j += 32) {
    out_s[static_cast<size_t>(qg) * k + j] = ls[j];
    out_i[static_cast<size_t>(qg) * k + j] = li[j];
  }
}

template <int QC>
int launch_score(const float* q, const float* x, const uint8_t* valid, int Q, int N, int d, int k,
                 int metric, int G, int tiles_per_range, float* cand_s, int* cand_i,
                 cudaStream_t stream) {
  const int dpad = (d + kDK - 1) / kDK * kDK;
  const size_t smem = layout(QC, dpad < kQW ? dpad : kQW, k).total;
  cudaError_t err = cudaFuncSetAttribute(knn_score_topk_kernel<QC>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(G, (Q + QC - 1) / QC);
  knn_score_topk_kernel<QC><<<grid, kThreads, smem, stream>>>(
      q, x, valid, Q, N, d, k, metric, tiles_per_range, cand_s, cand_i);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q: f32 [Q, d]; x: f32 [N, d], 16-byte aligned; valid: bool [N] or null; both row-major and
// contiguous, any d >= 1.
// cand_s / cand_i: scratch of Q * G * k entries. out_s: f32 [Q, k]; out_i: int64 [Q, k].
// `qc` is the query chunk of pass 1 (16 or 64); rows split into G ranges of tiles_per_range * 64.
extern "C" int knn_topk(const void* q, const void* x, const void* valid, void* cand_s,
                        void* cand_i, void* out_s, void* out_i, int Q, int N, int d, int k,
                        int metric, int qc, int G, int tiles_per_range, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* qf = static_cast<const float*>(q);
  const float* xf = static_cast<const float*>(x);
  const uint8_t* vf = static_cast<const uint8_t*>(valid);
  float* cs = static_cast<float*>(cand_s);
  int* ci = static_cast<int*>(cand_i);
  int err;
  if (qc == 64)
    err = launch_score<64>(qf, xf, vf, Q, N, d, k, metric, G, tiles_per_range, cs, ci, st);
  else if (qc == 16)
    err = launch_score<16>(qf, xf, vf, Q, N, d, k, metric, G, tiles_per_range, cs, ci, st);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  if (err != 0) return err;
  const size_t smem = sizeof(float) * kMergeWarps * k + sizeof(int) * kMergeWarps * k;
  cudaError_t e = cudaFuncSetAttribute(knn_merge_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  knn_merge_kernel<<<(Q + kMergeWarps - 1) / kMergeWarps, kMergeWarps * 32, smem, st>>>(
      cs, ci, Q, G, k, static_cast<float*>(out_s), static_cast<long long*>(out_i));
  return static_cast<int>(cudaGetLastError());
}

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
// 989 TFLOP/s in bf16. So the design keeps the HBM busy and spends little else.
//
// Two routes, chosen by shape alone (ops/knn.py `plan` names the route and sizes the grid; the
// wrapper's limits are kStreamMaxK and kStreamMaxDim below):
//
// The stream route (k <= kStreamMaxK = 16, d <= kStreamMaxDim = 384 and a multiple of 4: every
// main-path launch) is persistent: one block an SM (its layout takes about 206 KB of shared memory
// at d=384) walks row tiles of kStreamRows = 128 rows with a stride of the grid, so the whole
// index goes in one wave.
// - The ring: a producer warp keeps kStreamStages = 4 stages of 128 rows x 64 f32 columns (32 KB
//   a stage) full with 2-D TMA copies that complete on an mbarrier; rows past N and columns past
//   d come in as zeros. Three stages are in flight while the consumers work on the fourth, so at
//   least 96 KB of index a SM is in flight at every moment (128 KB while the consumers wait).
// - The products: four consumer warps own 32 rows each of a stage against all 64 queries of the
//   block's chunk. The queries stay in shared memory as bf16, their columns permuted within each
//   16-column step so that ldmatrix gives the mma's A fragment in the k order in which a lane
//   reads its f32 values. A lane reads each f32 value of the tile from shared memory once (two
//   16-byte loads per row and 32 columns, their halves swapped on odd rows so that the 8 lanes of
//   a load phase hit 32 distinct banks), packs it to bf16x2 in registers for mma.sync m16n8k16
//   and, for l2, adds its square to the row's |x|^2. There is no bf16 copy of the tile, and the
//   stage goes back to the producer as soon as its products are done.
// - The selection: each warp keeps its own sorted list of each query, and a row is offered only
//   if it beats its query's threshold, which the warps of all blocks share (knn_stream_kernel's
//   note): after the first tile it is about the k-th best of the rows the blocks have scored, so
//   a tile's epilogue is a comparison of each lane's 64 scores with 8 thresholds, and few rows
//   ever reach the lists (a ballot and a shuffle each, or a bitonic sort for a batch). There is
//   no block-wide barrier per tile: the ring's mbarriers are the only ones.
// - Pass 2 (knn_stream_merge_kernel) sorts the few candidates that still beat the final
//   threshold.
//
// The tile route (the rest: larger k, d past kStreamMaxDim or not a multiple of 4) is the kernel
// of the earlier versions. Blocks run over (row range, chunk of QC queries); a block keeps its
// queries in shared memory as bf16 and walks its row range in tiles of 64 rows, each read from
// device memory once, 128 columns at a time (f32, rounded to bf16 on the way into shared memory,
// with |index|^2 taken from the same f32 values); the loads of the next step are issued before
// the products of the current one. The block keeps a sorted top-k list per query in shared
// memory: a warp compares a tile's 64 scores with the list's last entry by ballot and inserts the
// few that beat it. Rows of a width divisible by 4 are read 16 bytes at a time, others one float
// at a time. It keeps at most kQW = 1024 columns of its queries in shared memory: a wider index
// is walked in chunks of kQW columns, each chunk's queries loaded anew for every tile, and the
// f32 sum runs on across the chunks, so the dot is rounded to bf16 once, at the end. Its pass 2
// (knn_merge_kernel) merges the blocks' lists, one warp per query. Only lists, never scores,
// reach device memory on either route.

#include <cuda.h>  // CUtensorMap and its enums; the encoder comes through the runtime, no -lcuda
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kR = 64;         // index rows per tile
constexpr int kDK = 128;       // feature columns per load step
constexpr int kXS = 136;       // padded tile row, in bf16 (kDK + 8): 68 words, no bank conflict
constexpr int kQW = 1024;      // query columns held in shared memory at once (a multiple of kDK)
constexpr int kTileMinBlocks = 2;  // registers for two blocks an SM: the plan counts on it
constexpr int kMergeWarps = 4;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kNoRow = 0x7fffffff;

// the stream route
constexpr int kStreamConsumers = 4;                         // consumer warps; one producer warp
constexpr int kStreamThreads = (kStreamConsumers + 1) * 32;
constexpr int kStreamQC = 64;                               // queries a block
constexpr int kStreamRows = 128;                            // index rows a stage, 32 a warp
constexpr int kStreamCols = 64;                             // f32 columns a stage
constexpr int kStreamStages = 4;
constexpr int kStreamMaxK = 16;                             // every warp's lists fit
constexpr int kStreamMaxDim = 384;                          // the queries fit beside the ring
constexpr int kStageBytes = kStreamRows * kStreamCols * 4;  // 32 KB
constexpr int kQPad = 8;  // bf16 past each query row: rows 16 bytes off a 128-byte period
constexpr int kStaging = 256;    // a warp's candidates of a slot: 8 a lane
constexpr int kGroups = 32;      // group maxima a query, one a lane when read back
constexpr int kSeedTiles = 3;    // tiles in which each warp adds to them

enum Metric { kDot = 0, kL2 = 1 };
constexpr int kStreamRoute = 1;  // the route argument of the queries below; 0 the tile route

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

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
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

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t a) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
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

// rows row0 .. row0 + kStreamRows - 1, columns col0 .. col0 + kStreamCols - 1 of the index into
// the stage at `dst`, dense rows of kStreamCols floats; zeros past the index's edges
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int col0, int row0) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(col0), "r"(row0)
      : "memory");
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

// The stream route's shared memory, from a base aligned to 128 bytes: the ring, the queries
// (bf16, permuted, zeros past d), their |q|^2, each consumer warp's lists of the 64 queries,
// the block's threshold of each query (an order_key), each consumer warp's staging buffer
// (scores, then rows) and the ring's mbarriers.
struct StreamLayout {
  size_t ring, qs, qn, ls, li, cut, stage, bars, total;
};

__host__ __device__ constexpr int stream_dpad(int d) {
  return (d + kStreamCols - 1) / kStreamCols * kStreamCols;
}

__host__ __device__ constexpr StreamLayout stream_layout(int d, int k) {
  StreamLayout L{};
  size_t at = 0;
  L.ring = at; at += static_cast<size_t>(kStreamStages) * kStageBytes;
  L.qs = at; at = align16(at + sizeof(__nv_bfloat16) * kStreamQC * (stream_dpad(d) + kQPad));
  L.qn = at; at = align16(at + sizeof(float) * kStreamQC);
  L.ls = at; at = align16(at + sizeof(float) * kStreamConsumers * kStreamQC * k);
  L.li = at; at = align16(at + sizeof(int) * kStreamConsumers * kStreamQC * k);
  L.cut = at; at = align16(at + sizeof(unsigned long long) * kStreamQC);
  L.stage = at; at = align16(at + (sizeof(float) + sizeof(int)) * kStaging * kStreamConsumers);
  L.bars = at; at = align16(at + 8 * 2 * kStreamStages);
  L.total = at + 128;  // + 128: aligning the base for TMA
  return L;
}

static_assert(kStreamMaxDim % kStreamCols == 0 && kStreamCols % 32 == 0, "stage columns");
static_assert(kXS == kDK + 8 && kStreamRows == 32 * kStreamConsumers && kStaging == 8 * 32,
              "the layouts' constants");
static_assert(kStreamRows <= 256 && kStreamCols <= 256, "a TMA box is at most 256 a side");
static_assert(stream_layout(kStreamMaxDim, kStreamMaxK).total <= 232448,
              "the largest stream layout fits in a block's 227 KB of shared memory");

template <int QC>
__global__ void __launch_bounds__(kThreads, kTileMinBlocks)
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

// The query column that position p of a 16-column step holds in shared memory: position 2t + e
// holds column 4t + e, position 8 + 2t + e column 4t + 2 + e (t < 4, e < 2). A lane (g, t) of
// the mma reads its B values as one float4, columns 4t .. 4t + 3 of its row; ldmatrix then gives
// it the A values of the same columns in the fragment's k order.
__device__ __forceinline__ int stream_position(int col) {
  const int c = col & 15, t = c >> 2, r = c & 3;
  return (col & ~15) + (r < 2 ? 2 * t + r : 8 + 2 * t + r - 2);
}

// (score, row) as one 64-bit key, larger for the better of two in better()'s order: the score's
// bits made monotone (-0 taken as +0, which compares equal to it), then the row, lower larger.
__device__ __forceinline__ unsigned long long order_key(float s, int row) {
  const uint32_t b = __float_as_uint(s == 0.f ? 0.f : s);
  const uint32_t o = (b & 0x80000000u) ? ~b : (b | 0x80000000u);
  return (static_cast<unsigned long long>(o) << 32) | static_cast<uint32_t>(kNoRow - row);
}

// The (score, row) of a key; key 0 (nothing known yet) is below every candidate, and the
// largest key (the threshold of no query) above every one.
__device__ __forceinline__ void from_key(unsigned long long key, float& s, int& row) {
  if (key == 0 || key == ~0ull) {
    s = key == 0 ? -INFINITY : INFINITY;
    row = key == 0 ? kNoRow : -1;
    return;
  }
  const uint32_t o = static_cast<uint32_t>(key >> 32);
  s = __uint_as_float((o & 0x80000000u) ? (o & 0x7fffffffu) : ~o);
  row = kNoRow - static_cast<int>(static_cast<uint32_t>(key));
}

constexpr int kSortFrom = 8;  // a batch of more candidates than this is sorted and merged

// One compare-exchange step of a bitonic network across the warp: this lane and lane ^ stride
// swap (s, i) unless the better of the two already sits where `lower_keeps_better` says.
__device__ __forceinline__ void bitonic_step(float& s, int& i, int stride, bool lower_keeps_better,
                                             int lane) {
  const float os = __shfl_xor_sync(kFull, s, stride);
  const int oi = __shfl_xor_sync(kFull, i, stride);
  const bool keep_better = ((lane & stride) == 0) == lower_keeps_better;
  if (better(os, oi, s, i) == keep_better) {
    s = os;
    i = oi;
  }
}

// Sort one (s, i) a lane across the warp, best first.
__device__ __forceinline__ void bitonic_sort(float& s, int& i, int lane) {
#pragma unroll
  for (int size = 2; size <= 32; size <<= 1)
#pragma unroll
    for (int stride = size / 2; stride > 0; stride >>= 1)
      bitonic_step(s, i, stride, (lane & size) == 0, lane);  // the last pass: best first
}

// A warp's list of one query (sorted best first, k <= 32) gets the candidates bs/bi[beg, end).
// Lane j holds entry j while the warp works on it (lanes past k hold (-inf, kNoRow), worse than
// any candidate). A few candidates go in one at a time, by a ballot and a shuffle each; a larger
// batch (the first tile, where no threshold is known yet) goes 32 at a time through a bitonic
// sort, one candidate a lane, and a merge: the better of entry j and candidate 31 - j holds the
// best 32 of both as a bitonic sequence, which five more steps sort. Returns the list's new k-th
// entry.
struct Entry {
  float s;
  int i;
};

__device__ __forceinline__ Entry stream_insert(float* ls, int* li, int k, const float* bs,
                                               const int* bi, int beg, int end) {
  const int lane = threadIdx.x % 32;
  float ms = lane < k ? ls[lane] : -INFINITY;
  int mi = lane < k ? li[lane] : static_cast<int>(kNoRow);
  if (end - beg > kSortFrom) {
    for (int at = beg; at < end; at += 32) {
      float cs = at + lane < end ? bs[at + lane] : -INFINITY;
      int ci = at + lane < end ? bi[at + lane] : static_cast<int>(kNoRow);
      bitonic_sort(cs, ci, lane);
      cs = __shfl_sync(kFull, cs, 31 - lane);
      ci = __shfl_sync(kFull, ci, 31 - lane);
      if (better(cs, ci, ms, mi)) {
        ms = cs;
        mi = ci;
      }
#pragma unroll
      for (int stride = 16; stride > 0; stride >>= 1) bitonic_step(ms, mi, stride, true, lane);
    }
  } else {
    for (int e = beg; e < end; ++e) {
      const float cs = bs[e];
      const int ci = bi[e];
      // the entries better than the candidate are a prefix of the sorted list
      const int pos = __popc(__ballot_sync(kFull, lane < k && better(ms, mi, cs, ci)));
      if (pos < k) {  // uniform across the warp
        const float us = __shfl_up_sync(kFull, ms, 1);
        const int ui = __shfl_up_sync(kFull, mi, 1);
        if (lane > pos) {
          ms = us;
          mi = ui;
        } else if (lane == pos) {
          ms = cs;
          mi = ci;
        }
      }
    }
  }
  if (lane < k) {
    ls[lane] = ms;
    li[lane] = mi;
  }
  const Entry kth = {__shfl_sync(kFull, ms, k - 1), __shfl_sync(kFull, mi, k - 1)};
  __syncwarp();
  return kth;
}

// The words of the stream route's global scratch, zero before a launch: per query its threshold
// (an order_key, 0 while none is known), the count of its candidates in cand_s/cand_i, and
// kGroups group maxima (order_keys).
struct Scratch {
  unsigned long long* thr;
  unsigned long long* count;
  unsigned long long* gmax;  // [Q][kGroups]
};

// The better of (s, i) and (ts, ti), into (ts, ti).
__device__ __forceinline__ void keep_better(float s, int i, float& ts, int& ti) {
  if (better(s, i, ts, ti)) {
    ts = s;
    ti = i;
  }
}

// The k-th best of the kGroups group maxima of each of this warp's 16 queries (a lane a group),
// once at least k groups hold one: k distinct rows beat it, so it goes into the query's
// threshold, in shared memory (the block's) and in device memory (the launch's).
__device__ void seed_thresholds(const Scratch& scratch, unsigned long long* cut, int q0, int Q,
                                int k, int warp, int lane) {
  constexpr int kBatch = 8;  // queries whose groups are in flight together
  for (int b = warp * 16; b < warp * 16 + 16; b += kBatch) {
    unsigned long long key[kBatch];
#pragma unroll
    for (int j = 0; j < kBatch; ++j)
      key[j] = q0 + b + j < Q ? *reinterpret_cast<volatile unsigned long long*>(
                                    scratch.gmax + static_cast<size_t>(q0 + b + j) * kGroups +
                                    lane)
                              : 0ull;
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      if (q0 + b + j >= Q) break;  // uniform across the warp
      float ms;
      int mi;
      from_key(key[j], ms, mi);
      bitonic_sort(ms, mi, lane);
      const float ks = __shfl_sync(kFull, ms, k - 1);
      const int ki = __shfl_sync(kFull, mi, k - 1);
      if (lane == 0 && ki != kNoRow) {
        const unsigned long long kk = order_key(ks, ki);
        atomicMax(cut + b + j, kk);
        atomicMax(scratch.thr + q0 + b + j, kk);
      }
    }
  }
}

// Pass 1 of the stream route. Block (x, y): query chunk y of kStreamQC, row tiles x, x + G, ...
// Consumer warp w takes rows 32 w .. 32 w + 31 of each stage, against all 64 queries, and keeps
// its own list of each query. A row can be dropped once k rows of the launch are known to beat
// it, so the warps share a threshold per query, in shared memory within the block and through
// device memory across the launch (an order_key; a row is compared with it once, in its tile):
// - each warp's k-th entry once its list is full;
// - the k-th best of kGroups group maxima per query: in its first kSeedTiles tiles each warp
//   adds its best row of the tile to group (4 blockIdx.x + w) % kGroups, and at the end the best
//   entry of its list; the warps read the groups back after each of those. k distinct rows beat
//   it; after the first tile it is about the k-th best of the rows that all blocks have scored,
//   and at the end of the launch about the k-th best of the index. In the first tile the warps
//   read it back before they compare any row, so the lists stay nearly untouched from the start.
// At the end each warp appends the entries of its lists that still beat their query's threshold
// to the query's candidates (count[q] of them), which pass 2 reads.
template <bool L2>
__global__ void __launch_bounds__(kStreamThreads, 1)
knn_stream_kernel(const __grid_constant__ CUtensorMap tx, const float* __restrict__ q,
                  const uint8_t* __restrict__ valid, int Q, int N, int d, int k, Scratch scratch,
                  int cap, float* __restrict__ cand_s, int* __restrict__ cand_i) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 127) & ~uintptr_t(127));
  const StreamLayout L = stream_layout(d, k);
  const float* ring = reinterpret_cast<const float*>(smem + L.ring);
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem + L.qs);
  float* qn = reinterpret_cast<float*>(smem + L.qn);
  unsigned long long* cut = reinterpret_cast<unsigned long long*>(smem + L.cut);  // [64]
  const uint32_t full0 = smem_addr(smem + L.bars), empty0 = full0 + 8 * kStreamStages;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int G = gridDim.x, q0 = blockIdx.y * kStreamQC;
  const int dpad = stream_dpad(d), chunks = dpad / kStreamCols;
  const int tiles = (N + kStreamRows - 1) / kStreamRows;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStreamStages; ++s) {
      mbar_init(full0 + 8 * s, 1);                 // the producer's arrival, with the TMA bytes
      mbar_init(empty0 + 8 * s, kStreamConsumers);  // each consumer warp's release
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == kStreamConsumers) {  // the producer: stage u holds (tile, chunk) number u
    if (lane == 0) {
      uint32_t u = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += G)
        for (int c = 0; c < chunks; ++c, ++u) {
          const uint32_t s = u % kStreamStages;
          if (u >= kStreamStages) mbar_wait(empty0 + 8 * s, ((u / kStreamStages) + 1) & 1);
          mbar_arrive_tx(full0 + 8 * s, kStageBytes);
          tma_load_2d(smem_addr(ring) + s * kStageBytes, &tx, full0 + 8 * s, c * kStreamCols,
                      tile * kStreamRows);
        }
    }
    return;  // no block-wide barrier follows
  }

  // the consumers: queries, lists and thresholds, then a barrier of the four warps
  const int ct = threadIdx.x;  // < 128
  constexpr int kCT = kStreamConsumers * 32;
  const int qstride = dpad + kQPad;
  for (int e = ct; e < kStreamQC * dpad; e += kCT) {
    const int qi = e / dpad, c = e % dpad;
    const float val = (q0 + qi < Q && c < d) ? q[static_cast<size_t>(q0 + qi) * d + c] : 0.f;
    qs[qi * qstride + stream_position(c)] = __float2bfloat16_rn(val);
  }
  for (int qi = warp; qi < kStreamQC; qi += kStreamConsumers) {
    float acc = 0.f;
    if (L2 && q0 + qi < Q)
      for (int c = lane; c < d; c += 32) {
        const float val = q[static_cast<size_t>(q0 + qi) * d + c];
        acc += val * val;
      }
    acc = warp_sum_f(acc);
    if (lane == 0) qn[qi] = acc;
  }
  float* ls = reinterpret_cast<float*>(smem + L.ls) + warp * kStreamQC * k;  // this warp's [64][k]
  int* li = reinterpret_cast<int*>(smem + L.li) + warp * kStreamQC * k;
  for (int e = lane; e < kStreamQC * k; e += 32) {
    ls[e] = -INFINITY;
    li[e] = kNoRow;
  }
  // no query past Q: nothing beats (+inf, -1), the largest key
  if (ct < kStreamQC) cut[ct] = q0 + ct < Q ? 0ull : ~0ull;
  asm volatile("bar.sync 1, %0;\n" ::"n"(kCT) : "memory");

  const int g = lane >> 2, t = lane & 3;  // mma fragment coordinates
  const bool odd = g & 1;
  const int group = (blockIdx.x * kStreamConsumers + warp) % kGroups;
  float* bs = reinterpret_cast<float*>(smem + L.stage) + warp * kStaging;
  int* bi = reinterpret_cast<int*>(smem + L.stage + sizeof(float) * kStaging * kStreamConsumers) +
            warp * kStaging;
  // this lane's ldmatrix address of A rows 0 .. 15, column 0 of a step: rows lane % 16, the
  // right 8 columns for lanes 16 and up
  const uint32_t a_lane = smem_addr(qs) + ((lane & 15) * qstride + (lane >> 4) * 8) * 2;
  uint32_t u = 0;

  for (int tile = blockIdx.x, seen = 0; tile < tiles; tile += G, ++seen) {
    const int rbase = tile * kStreamRows + warp * 32;  // this warp's 32 rows
    // acc[mt][nt]: queries mt*16 + g (0, 1) and + 8 (2, 3), rows rbase + nt*8 + 2t (0, 2), +1
    float acc[4][4][4] = {};
    float nrm[4] = {};  // partial |x|^2 of rows rbase + nt*8 + g, this lane's columns
    uint32_t ok = 0;    // bit nt*2 + e: row rbase + nt*8 + 2t + e inside the index and valid
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int r = rbase + nt * 8 + 2 * t + e;
        if (r < N && (valid == nullptr || __ldg(valid + r) != 0)) ok |= 1u << (nt * 2 + e);
      }
    // the launch's thresholds, read now and taken into the block's after the products
    unsigned long long launch_thr[2];
#pragma unroll
    for (int j = 0; j < 2; ++j)
      launch_thr[j] = q0 + lane + 32 * j < Q ? *reinterpret_cast<volatile unsigned long long*>(
                                                   scratch.thr + q0 + lane + 32 * j)
                                             : 0ull;

    for (int c = 0; c < chunks; ++c, ++u) {
      const uint32_t s = u % kStreamStages;
      mbar_wait(full0 + 8 * s, (u / kStreamStages) & 1);
      const float* st = ring + s * (kStreamRows * kStreamCols) + (warp * 32 + g) * kStreamCols;
#pragma unroll
      for (int j = 0; j < kStreamCols / 32; ++j) {
        uint32_t blo[4][2], bhi[4][2];
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const float* row = st + nt * 8 * kStreamCols + 32 * j + 4 * t;
          // odd rows load the right half first: the 8 lanes of a phase cover all 32 banks
          const float4 p = *reinterpret_cast<const float4*>(row + (odd ? 16 : 0));
          const float4 r = *reinterpret_cast<const float4*>(row + (odd ? 0 : 16));
          if (L2)
            nrm[nt] += (p.x * p.x + p.y * p.y + p.z * p.z + p.w * p.w) +
                       (r.x * r.x + r.y * r.y + r.z * r.z + r.w * r.w);
          const uint32_t p0 = pack_bf16(p.x, p.y), p1 = pack_bf16(p.z, p.w);
          const uint32_t r0 = pack_bf16(r.x, r.y), r1 = pack_bf16(r.z, r.w);
          blo[nt][0] = odd ? r0 : p0;
          blo[nt][1] = odd ? r1 : p1;
          bhi[nt][0] = odd ? p0 : r0;
          bhi[nt][1] = odd ? p1 : r1;
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int col = c * kStreamCols + 32 * j + 16 * h;  // the step's first column
#pragma unroll
          for (int mt = 0; mt < 4; ++mt) {
            uint32_t a[4];
            ldmatrix_x4(a, a_lane + (mt * 16 * qstride + col) * 2);
#pragma unroll
            for (int nt = 0; nt < 4; ++nt) mma_bf16(acc[mt][nt], a, h ? bhi[nt] : blo[nt]);
          }
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty0 + 8 * s);  // the stage goes back to the producer
    }

    // scores: bf16(dot), for l2 with both norms; -inf where the row is masked
#pragma unroll
    for (int j = 0; j < 2; ++j)
      if (launch_thr[j] != 0) atomicMax(cut + lane + 32 * j, launch_thr[j]);
    __syncwarp();
    float xn[4][2];
    if (L2) {
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        float v = nrm[nt];
        v += __shfl_xor_sync(kFull, v, 1);
        v += __shfl_xor_sync(kFull, v, 2);  // the quad's lanes hold |x|^2 of row nt*8 + g
        xn[nt][0] = __shfl_sync(kFull, v, (2 * t) * 4);
        xn[nt][1] = __shfl_sync(kFull, v, (2 * t + 1) * 4);
      }
    }
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float qnorm = L2 ? qn[mt * 16 + h * 8 + g] : 0.f;
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float sv = bf16_round_f(acc[mt][nt][2 * h + e]);
            if (L2) sv = -((qnorm - 2.f * sv) + xn[nt][e]);
            acc[mt][nt][2 * h + e] = ok >> (nt * 2 + e) & 1 ? sv : -INFINITY;
          }
      }
    if (seen < kSeedTiles) {  // each slot's best row (a quad's 32 rows) into the warp's group
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int ql = mt * 16 + h * 8 + g;  // this lane's query of the slot
          float best_s = -INFINITY;
          int best_i = kNoRow;
#pragma unroll
          for (int nt = 0; nt < 4; ++nt)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int row = rbase + nt * 8 + 2 * t + e;
              if (row < N) keep_better(acc[mt][nt][2 * h + e], row, best_s, best_i);
            }
          keep_better(__shfl_xor_sync(kFull, best_s, 1), __shfl_xor_sync(kFull, best_i, 1),
                      best_s, best_i);
          keep_better(__shfl_xor_sync(kFull, best_s, 2), __shfl_xor_sync(kFull, best_i, 2),
                      best_s, best_i);
          if (t == 0 && best_i != kNoRow && q0 + ql < Q)
            atomicMax(scratch.gmax + static_cast<size_t>(q0 + ql) * kGroups + group,
                      order_key(best_s, best_i));
        }
    }
    if (seen == 0) {  // the first tile: read the groups back before comparing any row
      __syncwarp();
      seed_thresholds(scratch, cut, q0, Q, k, warp, lane);
      asm volatile("bar.sync 1, %0;\n" ::"n"(kCT) : "memory");
    }

    // the rows that beat their query's threshold go into this warp's lists
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int ql = mt * 16 + h * 8 + g;
        float cs;
        int ci;
        from_key(*reinterpret_cast<volatile unsigned long long*>(cut + ql), cs, ci);
        uint32_t win = 0;  // bit nt*2 + e
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int row = rbase + nt * 8 + 2 * t + e;
            const float sv = acc[mt][nt][2 * h + e];
            // no worse than the threshold: the row that set it may be this one, not yet offered
            if (row < N && sv == sv && !better(cs, ci, sv, row)) win |= 1u << (nt * 2 + e);
          }
        if (__ballot_sync(kFull, win != 0) == 0) continue;  // the common case
        // the winners into the staging buffer in lane order: grouped by query (lanes 4g..4g+3)
        const int cnt = __popc(win);
        int incl = cnt;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
          const int v = __shfl_up_sync(kFull, incl, o);
          if (lane >= o) incl += v;
        }
        int at = incl - cnt;
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            if (win >> (nt * 2 + e) & 1) {
              bs[at] = acc[mt][nt][2 * h + e];
              bi[at] = rbase + nt * 8 + 2 * t + e;
              ++at;
            }
        __syncwarp();
        for (int gq = 0; gq < 8; ++gq) {
          const int beg = __shfl_sync(kFull, incl - cnt, 4 * gq);
          const int end = __shfl_sync(kFull, incl, 4 * gq + 3);
          if (beg == end) continue;  // uniform across the warp
          const int qw = mt * 16 + h * 8 + gq;
          const Entry kth = stream_insert(ls + qw * k, li + qw * k, k, bs, bi, beg, end);
          if (lane == 0 && kth.i != kNoRow) {
            const unsigned long long kk = order_key(kth.s, kth.i);
            atomicMax(cut + qw, kk);
            atomicMax(scratch.thr + q0 + qw, kk);
          }
        }
        __syncwarp();  // the buffer is read before the next slot writes it
      }
    if (seen > 0 && seen < kSeedTiles) {
      __syncwarp();
      seed_thresholds(scratch, cut, q0, Q, k, warp, lane);
    }
  }

  // each list's best entry into the warp's group, the groups read back once more (now over
  // every row this block has scored), then the entries that still beat their query's threshold
  // appended to its candidates
  for (int ql = lane; ql < kStreamQC; ql += 32)
    if (q0 + ql < Q && li[ql * k] != kNoRow)
      atomicMax(scratch.gmax + static_cast<size_t>(q0 + ql) * kGroups + group,
                order_key(ls[ql * k], li[ql * k]));
  asm volatile("bar.sync 1, %0;\n" ::"n"(kCT) : "memory");
  seed_thresholds(scratch, cut, q0, Q, k, warp, lane);
  asm volatile("bar.sync 1, %0;\n" ::"n"(kCT) : "memory");
  for (int ql = 0; ql < kStreamQC; ++ql) {
    if (q0 + ql >= Q) break;  // uniform across the warp
    float ts;
    int ti;
    from_key(*reinterpret_cast<volatile unsigned long long*>(cut + ql), ts, ti);
    const float s = lane < k ? ls[ql * k + lane] : -INFINITY;
    const int id = lane < k ? li[ql * k + lane] : static_cast<int>(kNoRow);
    const bool keep = id != kNoRow && !better(ts, ti, s, id);
    const unsigned m = __ballot_sync(kFull, keep);
    if (m == 0) continue;
    unsigned long long base = 0;
    if (lane == 0)
      base = atomicAdd(scratch.count + q0 + ql, static_cast<unsigned long long>(__popc(m)));
    base = __shfl_sync(kFull, base, 0);
    if (keep) {
      const size_t at =
          static_cast<size_t>(q0 + ql) * cap + base + __popc(m & ((1u << lane) - 1));
      cand_s[at] = s;
      cand_i[at] = id;
    }
  }
}

// Merge `total` candidates cs/ci into the list ls/li of length k (set here to (-inf, kNoRow)),
// the warp reading them 4 x 32 at a time, each read coalesced and all four in flight together,
// and offering each to the list; the order of the offers does not change the result, since
// (score, row) pairs are totally ordered.
__device__ void merge_lists(const float* cs, const int* ci, int total, int k, float* ls, int* li,
                            int lane) {
  constexpr int kBatch = 4;
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
}

// Pass 2 of the tile route: one warp per query merges the G lists of pass 1, which lie side by
// side in device memory.
__global__ void __launch_bounds__(kMergeWarps * 32)
knn_merge_kernel(const float* __restrict__ cand_s, const int* __restrict__ cand_i, int Q, int G,
                 int k, float* __restrict__ out_s, long long* __restrict__ out_i) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int qg = blockIdx.x * kMergeWarps + warp;
  if (qg >= Q) return;  // uniform across the warp; no block-wide barrier follows
  float* ls = reinterpret_cast<float*>(smem) + warp * k;
  int* li = reinterpret_cast<int*>(reinterpret_cast<float*>(smem) + kMergeWarps * k) + warp * k;
  const int total = G * k;
  merge_lists(cand_s + static_cast<size_t>(qg) * total, cand_i + static_cast<size_t>(qg) * total,
              total, k, ls, li, lane);
  for (int j = lane; j < k; j += 32) {
    out_s[static_cast<size_t>(qg) * k + j] = ls[j];
    out_i[static_cast<size_t>(qg) * k + j] = li[j];
  }
}

// Pass 2 of the stream route: one warp per query. Of the query's candidates, only those no worse
// than its final threshold can be in the answer, and there are at least k of them: the warp keeps
// those (nearly always few), sorts them when 32 or fewer, and writes the best k. More than 32
// (many equal scores, or rows masked to -inf) go through the general merge.
__global__ void __launch_bounds__(kMergeWarps * 32)
knn_stream_merge_kernel(const float* __restrict__ cand_s, const int* __restrict__ cand_i,
                        Scratch scratch, int Q, int cap, int k, float* __restrict__ out_s,
                        long long* __restrict__ out_i) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int qg = blockIdx.x * kMergeWarps + warp;
  if (qg >= Q) return;  // uniform across the warp; no block-wide barrier follows
  float* ls = reinterpret_cast<float*>(smem) + warp * 32;
  int* li = reinterpret_cast<int*>(reinterpret_cast<float*>(smem) + kMergeWarps * 32) + warp * 32;
  const int total = static_cast<int>(scratch.count[qg]);
  const float* cs = cand_s + static_cast<size_t>(qg) * cap;
  const int* ci = cand_i + static_cast<size_t>(qg) * cap;
  float ts;
  int ti;
  from_key(scratch.thr[qg], ts, ti);
  int kept = 0;
  for (int base = 0; base < total; base += 32) {
    const int j = base + lane;
    const float s = j < total ? cs[j] : -INFINITY;
    const int id = j < total ? ci[j] : kNoRow;
    const bool keep = j < total && !better(ts, ti, s, id);
    const unsigned m = __ballot_sync(kFull, keep);
    const int at = kept + __popc(m & ((1u << lane) - 1));
    if (keep && at < 32) {
      ls[at] = s;
      li[at] = id;
    }
    kept += __popc(m);
  }
  __syncwarp();
  if (kept <= 32) {
    float s = lane < kept ? ls[lane] : -INFINITY;
    int id = lane < kept ? li[lane] : static_cast<int>(kNoRow);
    bitonic_sort(s, id, lane);
    if (lane < k) {
      out_s[static_cast<size_t>(qg) * k + lane] = s;
      out_i[static_cast<size_t>(qg) * k + lane] = id;
    }
    return;
  }
  __syncwarp();
  merge_lists(cs, ci, total, k, ls, li, lane);
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

constexpr int kMaxDevices = 64;

int current_device() {
  int dev = 0;
  return cudaGetDevice(&dev) == cudaSuccess && dev >= 0 && dev < kMaxDevices ? dev : -1;
}

// Raise the stream kernel's dynamic shared memory limit to the largest layout it takes, once
// per device.
template <bool L2>
cudaError_t stream_attribute(int dev) {
  static bool done[kMaxDevices] = {};
  if (done[dev]) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      knn_stream_kernel<L2>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(stream_layout(kStreamMaxDim, kStreamMaxK).total));
  done[dev] = err == cudaSuccess;
  return err;
}

template <bool L2>
int launch_stream(const CUtensorMap& map, const float* q, const uint8_t* valid, int Q, int N,
                  int d, int k, int G, Scratch scratch, float* cand_s, int* cand_i, float* out_s,
                  long long* out_i, cudaStream_t stream) {
  const int dev = current_device();
  if (dev < 0) return static_cast<int>(cudaErrorInvalidDevice);
  const cudaError_t err = stream_attribute<L2>(dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(G, (Q + kStreamQC - 1) / kStreamQC);
  const int cap = kStreamConsumers * G * k;  // every entry of every list of a query
  knn_stream_kernel<L2><<<grid, kStreamThreads, stream_layout(d, k).total, stream>>>(
      map, q, valid, Q, N, d, k, scratch, cap, cand_s, cand_i);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  knn_stream_merge_kernel<<<(Q + kMergeWarps - 1) / kMergeWarps, kMergeWarps * 32,
                            2 * kMergeWarps * 32 * sizeof(float), stream>>>(
      cand_s, cand_i, scratch, Q, cap, k, out_s, out_i);
  return static_cast<int>(cudaGetLastError());
}

int launch_merge(const float* cand_s, const int* cand_i, int Q, int G, int k, float* out_s,
                 long long* out_i, cudaStream_t stream) {
  const size_t smem = sizeof(float) * kMergeWarps * k + sizeof(int) * kMergeWarps * k;
  const cudaError_t e = cudaFuncSetAttribute(knn_merge_kernel,
                                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                                             static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  knn_merge_kernel<<<(Q + kMergeWarps - 1) / kMergeWarps, kMergeWarps * 32, smem, stream>>>(
      cand_s, cand_i, Q, G, k, out_s, out_i);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The tile route. q: f32 [Q, d]; x: f32 [N, d], 16-byte aligned; valid: bool [N] or null; both
// row-major and contiguous, any d >= 1.
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
  return launch_merge(cs, ci, Q, G, k, static_cast<float*>(out_s),
                      static_cast<long long*>(out_i), st);
}

// The stream route: the same arguments, for k <= kStreamMaxK and d <= kStreamMaxDim with d a
// multiple of 4; G blocks a chunk of kStreamQC queries, each walking the row tiles of kStreamRows
// with a stride of G. cand_s / cand_i: scratch of Q * 4G * k entries (room for every list
// entry); scratch: Q * (2 + kGroups) zero words of 64 bits (the thresholds, the candidate counts
// and the group maxima the blocks share).
extern "C" int knn_topk_stream(const void* q, const void* x, const void* valid, void* scratch,
                               void* cand_s, void* cand_i, void* out_s, void* out_i, int Q, int N,
                               int d, int k, int metric, int G, void* stream) {
  if (k < 1 || k > kStreamMaxK || d < 1 || d > kStreamMaxDim || d % 4 != 0 || Q < 1 || N < 1 ||
      G < 1 || reinterpret_cast<uintptr_t>(x) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const EncodeTiled enc = encoder();
  if (enc == nullptr) return static_cast<int>(cudaErrorNotSupported);
  // the index as a 2-D map over (column, row); a box is one stage
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(d), static_cast<cuuint64_t>(N)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(d) * 4};
  const cuuint32_t box[2] = {kStreamCols, kStreamRows};
  const cuuint32_t unit[2] = {1, 1};
  CUtensorMap map;
  if (enc(&map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<void*>(x), dims, strides, box, unit,
          CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
          CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* qf = static_cast<const float*>(q);
  const uint8_t* vf = static_cast<const uint8_t*>(valid);
  auto* words = static_cast<unsigned long long*>(scratch);
  const Scratch sc = {words, words + Q, words + 2 * static_cast<size_t>(Q)};
  float* cs = static_cast<float*>(cand_s);
  int* ci = static_cast<int*>(cand_i);
  float* os = static_cast<float*>(out_s);
  long long* oi = static_cast<long long*>(out_i);
  return metric == kL2 ? launch_stream<true>(map, qf, vf, Q, N, d, k, G, sc, cs, ci, os, oi, st)
                       : launch_stream<false>(map, qf, vf, Q, N, d, k, G, sc, cs, ci, os, oi, st);
}

// The dynamic shared memory a block of pass 1 asks for: route 1 the stream route at (d, k),
// route 0 the tile route at (qc, d, k).
extern "C" int knn_topk_smem_bytes(int route, int qc, int d, int k) {
  if (route == kStreamRoute) return static_cast<int>(stream_layout(d, k).total);
  const int dpad = (d + kDK - 1) / kDK * kDK;
  return static_cast<int>(layout(qc, dpad < kQW ? dpad : kQW, k).total);
}

// Blocks of pass 1 that fit on one SM of the current card at that shape, by the occupancy API
// (registers included), after raising the kernel's shared memory limit; -1 on an error.
extern "C" int knn_topk_blocks_per_sm(int route, int qc, int d, int k) {
  const int smem = knn_topk_smem_bytes(route, qc, d, k);
  int n = 0;
  cudaError_t err;
  if (route == kStreamRoute) {
    const int dev = current_device();
    if (dev < 0) return -1;
    err = stream_attribute<false>(dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, knn_stream_kernel<false>,
                                                          kStreamThreads, smem);
  } else {
    auto kernel = qc == 64 ? &knn_score_topk_kernel<64> : &knn_score_topk_kernel<16>;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, kThreads, smem);
  }
  return err == cudaSuccess ? n : -1;
}

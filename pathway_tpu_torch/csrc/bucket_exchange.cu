// The bucketing half of the engine's record exchange: rows of 32-bit words, each with a
// destination shard, scattered into per-destination buckets in source row order.
//
// Replaces: pathway_tpu/parallel/exchange.py `bucketed_all_to_all`, the body inside shard_map
// (lines 51-79), jitted per shape class by pathway_tpu/engine/mesh_exchange.py `_cached_kernel`.
// There each source shard computes slot = running count of its rows with the same destination
// (one_hot + cumsum), drops rows with dest < 0 or slot >= cap_bucket, scatter-adds the kept rows
// into zeroed [n_dst, cap_bucket, w] buckets with a validity mask, and `lax.all_to_all` swaps
// bucket b to device b. With every source block on one card, the all-to-all is a layout: the
// kernel writes source s's bucket for destination d straight to out[d, s*cap_bucket + slot], so
// out[d] is what device d holds after the JAX collective. Across ranks, the caller runs this with
// one source block and swaps the buckets with torch.distributed's all_to_all_single.
//
// Slots are taken in source row order (a row's slot counts the EARLIER rows of its block with the
// same destination), never by atomics: the engine re-zips columns that travel on the host with
// the dense arrivals by (source, emission order), so the order is part of the contract. The
// payload is bits (64-bit keys as word pairs, negative diffs, NaN floats): words are copied,
// never converted. Beside the buckets the kernel writes counts[d, s], the rows of source s kept
// in destination d's bucket, which the engine's readback uses to copy only the rows that arrived.
//
// Bound on the H100: bytes. Each input word is read once and each output word written once (the
// zeroed bucket tails included); there is no arithmetic to speak of. At the dense engine path's
// largest launch (n_src = 8, cap_in = 16384, w = 14, n_dst = 8, cap_bucket = 16384) the output is
// 58.7 MB, most of it zeros, so the zeros are most of the bound.
//
// Design: two launches over a grid of (tile of 1024 rows, source) blocks, so that a source's rows
// spread over cap_in / 1024 blocks (128 blocks at the launch above, where one block a source ran
// before).
// 1. bucket_count_kernel: each block counts its tile's rows per destination (__match_any_sync
//    groups a warp's lanes by destination; each group's leader adds its size in shared memory)
//    and writes them to a scratch array [source][tile][destination].
// 2. bucket_scatter_kernel: each block first sums the counts of its source's earlier tiles, which
//    gives its base slot in every bucket, and of all its source's tiles, which gives each
//    bucket's final count. The scan is this redundant per-block sum rather than a decoupled
//    look-back in one launch: a block reads at most cap_in / 1024 x n_dst counts (16 x 8 at the
//    launch above) from L2, a look-back would serialise the blocks of a source on each other, and
//    the second launch costs the same few microseconds as a third. Then, as before, a row's
//    slot is its base + the counts of the earlier warps of its tile + its rank among its warp's
//    earlier lanes with its destination: the running count, with no atomics. The block sorts its
//    rows by destination (positions in shared memory) and copies them cooperatively: consecutive
//    threads take consecutive vectors (16 bytes when w % 4 == 0, word pairs when w is even, single
//    words otherwise) of consecutive sorted rows, so the stores of a destination's run are
//    contiguous. Last, each block takes a 1/tiles share of the slots of each of its source's
//    buckets: it writes `valid` for every slot of its share and zeros over the share's slots past
//    the bucket's count. So every output byte is written once, and nothing is cleared first.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTileRows = 1024;  // rows of one source a block takes: one a thread
constexpr int kThreads = kTileRows;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxDst = 32;
constexpr unsigned kFull = 0xffffffffu;

template <int V> struct VecOf;
template <> struct VecOf<1> { using T = int32_t; };
template <> struct VecOf<2> { using T = int2; };
template <> struct VecOf<4> { using T = int4; };

// The destination of a tile row, or -1 for a row past cap_in or outside [0, n_dst) (dropped, as
// JAX drops an out-of-bounds scatter).
__device__ __forceinline__ int row_dest(const int32_t* __restrict__ dest, int s, int cap_in,
                                        int r, int n_dst) {
  const int d = r < cap_in ? dest[static_cast<long long>(s) * cap_in + r] : -1;
  return (d < 0 || d >= n_dst) ? -1 : d;
}

__global__ void __launch_bounds__(kThreads)
bucket_count_kernel(const int32_t* __restrict__ dest, int cap_in, int n_dst, int tiles,
                    int32_t* __restrict__ tile_count) {
  __shared__ int count[kMaxDst];
  const int t = blockIdx.x, s = blockIdx.y;
  const int lane = threadIdx.x & 31;
  if (threadIdx.x < kMaxDst) count[threadIdx.x] = 0;
  __syncthreads();
  const int d = row_dest(dest, s, cap_in, t * kTileRows + threadIdx.x, n_dst);
  const unsigned same = __match_any_sync(kFull, d);
  if (d >= 0 && __popc(same & ((1u << lane) - 1u)) == 0) atomicAdd(&count[d], __popc(same));
  __syncthreads();
  if (threadIdx.x < n_dst)
    tile_count[(static_cast<long long>(s) * tiles + t) * n_dst + threadIdx.x] = count[threadIdx.x];
}

template <int V>
__global__ void __launch_bounds__(kThreads)
bucket_scatter_kernel(const int32_t* __restrict__ values, const int32_t* __restrict__ dest,
                      int cap_in, int w, int n_dst, int cap_bucket, int tiles,
                      const int32_t* __restrict__ tile_count, int32_t* __restrict__ out,
                      uint8_t* __restrict__ valid, int32_t* __restrict__ counts) {
  using Vec = typename VecOf<V>::T;
  __shared__ int part[kWarps][kMaxDst];  // tile-count partial sums, then per-warp counts
  __shared__ int warp_base[kWarps][kMaxDst];
  __shared__ int base[kMaxDst];           // the tile's first slot in each bucket
  __shared__ int total[kMaxDst];          // the source's rows for each destination
  __shared__ int first[kMaxDst + 1];      // sorted position of each destination's first row
  __shared__ int src_row[kTileRows];      // sorted position -> row of the tile
  __shared__ long long dst_row[kTileRows];  // sorted position -> output row, or -1 (overflow)

  const int t = blockIdx.x, s = blockIdx.y, n_src = gridDim.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long out_rows = static_cast<long long>(n_src) * cap_bucket;  // rows a destination

  // The rows of the source's earlier tiles and of all its tiles, per destination: warp k sums
  // tiles k, k + 32, ..., lane d destination d; then one thread a destination adds the warps.
  {
    int before = 0, all = 0;
    if (lane < n_dst) {
      for (int u = warp; u < tiles; u += kWarps) {
        const int c = tile_count[(static_cast<long long>(s) * tiles + u) * n_dst + lane];
        all += c;
        before += u < t ? c : 0;
      }
    }
    part[warp][lane] = before;
    warp_base[warp][lane] = all;
  }
  __syncthreads();
  if (threadIdx.x < n_dst) {
    int before = 0, all = 0;
    for (int k = 0; k < kWarps; ++k) {
      before += part[k][threadIdx.x];
      all += warp_base[k][threadIdx.x];
    }
    base[threadIdx.x] = before;
    total[threadIdx.x] = all;
  }
  __syncthreads();

  // Each row's rank among the tile's earlier rows with its destination.
  part[warp][lane] = 0;
  __syncthreads();
  const int d = row_dest(dest, s, cap_in, t * kTileRows + threadIdx.x, n_dst);
  const unsigned same = __match_any_sync(kFull, d);
  const int rank = __popc(same & ((1u << lane) - 1u));
  if (d >= 0 && rank == 0) part[warp][d] = __popc(same);
  __syncthreads();
  if (warp == 0) {
    int tile_n = 0;  // the tile's rows for destination `lane`
    if (lane < n_dst) {
      for (int k = 0; k < kWarps; ++k) {
        warp_base[k][lane] = tile_n;
        tile_n += part[k][lane];
      }
    }
    int incl = tile_n;  // inclusive scan over destinations: the tile's rows sorted by destination
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(kFull, incl, o);
      if (lane >= o) incl += y;
    }
    first[lane] = incl - tile_n;
    if (lane == 31) first[kMaxDst] = incl;
  }
  __syncthreads();
  if (d >= 0) {
    const int within = warp_base[warp][d] + rank;
    const int j = first[d] + within;
    const int slot = base[d] + within;
    src_row[j] = threadIdx.x;
    dst_row[j] = slot < cap_bucket
        ? d * out_rows + static_cast<long long>(s) * cap_bucket + slot : -1;
  }
  __syncthreads();

  // The kept rows: consecutive threads copy consecutive vectors of the sorted rows.
  const int u = w / V;  // vectors a row
  const int n_sorted = first[kMaxDst];
  const Vec* __restrict__ in = reinterpret_cast<const Vec*>(values) +
      (static_cast<long long>(s) * cap_in + static_cast<long long>(t) * kTileRows) * u;
  Vec* __restrict__ o = reinterpret_cast<Vec*>(out);
  for (int f = threadIdx.x; f < n_sorted * u; f += kThreads) {
    const int j = f / u, k = f - j * u;
    const long long to = dst_row[j];
    if (to >= 0) o[to * u + k] = in[static_cast<long long>(src_row[j]) * u + k];
  }

  // This block's share of each of its source's buckets: `valid` for every slot, zeros past the
  // bucket's count.
  const int chunk = (cap_bucket + tiles - 1) / tiles;
  const int lo = static_cast<int>(min(static_cast<long long>(t) * chunk,
                                      static_cast<long long>(cap_bucket)));
  const int hi = min(lo + chunk, cap_bucket);
  const Vec zero{};
  for (int dd = 0; dd < n_dst; ++dd) {
    const int kept = min(total[dd], cap_bucket);
    const long long bucket = dd * out_rows + static_cast<long long>(s) * cap_bucket;
    for (int slot = lo + threadIdx.x; slot < hi; slot += kThreads)
      valid[bucket + slot] = slot < kept;
    const int z0 = max(lo, kept);
    if (z0 < hi) {
      Vec* zb = o + (bucket + z0) * u;
      const long long nz = static_cast<long long>(hi - z0) * u;
      for (long long f = threadIdx.x; f < nz; f += kThreads) zb[f] = zero;
    }
  }
  if (t == 0 && threadIdx.x < n_dst)
    counts[threadIdx.x * n_src + s] = min(total[threadIdx.x], cap_bucket);
}

template <int V>
cudaError_t scatter(const int32_t* values, const int32_t* dest, int n_src, int cap_in, int w,
                    int n_dst, int cap_bucket, int tiles, const int32_t* tile_count, int32_t* out,
                    uint8_t* valid, int32_t* counts, cudaStream_t st) {
  bucket_scatter_kernel<V><<<dim3(tiles, n_src), kThreads, 0, st>>>(
      values, dest, cap_in, w, n_dst, cap_bucket, tiles, tile_count, out, valid, counts);
  return cudaGetLastError();
}

}  // namespace

// values: int32 [n_src * cap_in, w] (row-major), dest: int32 [n_src * cap_in];
// out: int32 [n_dst, n_src * cap_bucket, w], valid: uint8 [n_dst, n_src * cap_bucket],
// counts: int32 [n_dst, n_src] (the rows kept in each bucket); scratch: int32
// [n_src * ceil(cap_in / 1024) * n_dst]. 1 <= n_dst <= 32, n_src <= 65535, w < 2^21. Writes every
// byte of out, valid and counts; launches on `stream` and returns cudaGetLastError().
extern "C" int bucket_exchange(const void* values, const void* dest, int n_src, int cap_in, int w,
                               int n_dst, int cap_bucket, void* out, void* valid, void* counts,
                               void* scratch, void* stream) {
  if (n_src < 1 || n_src > 65535 || cap_in < 1 || w < 1 || w >= (1 << 21) || n_dst < 1 ||
      n_dst > kMaxDst || cap_bucket < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int tiles = (cap_in + kTileRows - 1) / kTileRows;
  const int32_t* v = static_cast<const int32_t*>(values);
  const int32_t* d = static_cast<const int32_t*>(dest);
  int32_t* tile_count = static_cast<int32_t*>(scratch);
  bucket_count_kernel<<<dim3(tiles, n_src), kThreads, 0, st>>>(d, cap_in, n_dst, tiles,
                                                                 tile_count);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const uintptr_t aligned = reinterpret_cast<uintptr_t>(values) | reinterpret_cast<uintptr_t>(out);
  int32_t* o = static_cast<int32_t*>(out);
  uint8_t* ok = static_cast<uint8_t*>(valid);
  int32_t* c = static_cast<int32_t*>(counts);
  if (w % 4 == 0 && aligned % 16 == 0)
    err = scatter<4>(v, d, n_src, cap_in, w, n_dst, cap_bucket, tiles, tile_count, o, ok, c, st);
  else if (w % 2 == 0 && aligned % 8 == 0)
    err = scatter<2>(v, d, n_src, cap_in, w, n_dst, cap_bucket, tiles, tile_count, o, ok, c, st);
  else
    err = scatter<1>(v, d, n_src, cap_in, w, n_dst, cap_bucket, tiles, tile_count, o, ok, c, st);
  return static_cast<int>(err);
}

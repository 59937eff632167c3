// Ordered segment sum of 64-lane f32 rows on Hopper (sm_90a):
// out[r] = Σ rows[i] over the i with ids[i] = r, in ascending i.
//
// Stage 2 of every backward of the port (the counterpart of the JAX
// backwards' jax.ops.segment_sum): the fused and top-K peels' per-pair rows
// (peel_bwd.cu, peel_topk_bwd.cu) and the keys path's per-winner rows
// (render/tiled.py:_ShadeWinnersKP.backward) go into the (N+1, 64) feature
// table. The JAX package's _bwd_kernel (rtgs_tpu/ops/peel.py:870) leaves
// this sum to its caller; its keys path does it in XLA.
//
// Design: a counting sort whose runs are put in order before they are
// summed, in one memset and five kernels, with no float atomic.
//  1. hist_kernel: each valid i takes a rank in its id's run by an integer
//     atomicAdd on the id's count (lanes of a warp with one id add once,
//     __match_any_sync). The counts do not depend on the order of the
//     atomics; the ranks do.
//  2. scan_kernel: the exclusive scan of the counts gives each run's start
//     (a single pass, decoupled look-back, a warp reading 32 tiles at a
//     time, over tiles of 512 ids taken in the order the blocks start, so
//     a block only waits on blocks that started before it). The same block
//     writes the zero rows of its tile, 16-byte streaming stores, and lists
//     the named runs: up to 32 i (short) and more (long).
//  3. place_kernel: each i to start + rank of its run.
//  4. short_kernel: a warp a short run at a time: its i a lane, each
//     lane's place in ascending order counted over the run, then its rows
//     in ascending i.
//  5. long_kernel: a warp a long run at a time, taken in turn: up to 2048
//     i sorted in shared memory; more enumerated in ascending i through a
//     bitmap of the run's i, window by window.
// A run's set of i is fixed by the ids, so after the sort the sum is the
// same every time; the atomics only decide where an i waits to be sorted.
//
// Rows: a warp a run, 8 bytes a lane (a 256-byte row is one coalesced
// request), two batches of 4 (short runs) or 8 (long runs) rows in flight;
// indices int32.
//
// Bound. Bytes: every input row read once and every output row written
// once, (M + n_out)·256, beside 4 bytes an id; one f32 add a lane and row.
//
// Numerics. Plain f32 adds from +0.0 in ascending i (built with
// --fmad=false, which adds nothing to fuse here): bitwise what index_add_
// on the CPU gives, which adds row by row (rtgs_tpu_torch.ops.peel.
// segment_rows_torch).

#include <climits>
#include <cuda_runtime.h>

#include "launch_common.cuh"

namespace {

constexpr int kRow = 64;                 // f32 lanes a row
constexpr int kTile = 512;               // ids a scan block
constexpr int kScanThreads = 64;         // 8 ids a thread
constexpr int kShort = 32;               // longest run of short_kernel
constexpr int kShortRows = 4;            // rows a batch, two batches in
constexpr int kLongRows = 8;             // flight (short, long runs)
constexpr int kWarpBuf = 2048;           // ints of shared memory a warp
constexpr int kBitmapWords = 1536;       // of them the bitmap of a window
constexpr int kListInts = kWarpBuf - kBitmapWords;  // and its i, in order
constexpr int kLongThreads = 128;        // 4 warps, 32 KB of shared memory
constexpr int kMaxLongBlocks = 132 * 7;  // as many as fit on the card at once
constexpr int kMaxShortBlocks = 132 * 8;  // 64 warps an SM
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned long long kFlagAgg = 1ull << 62;     // tile total
constexpr unsigned long long kFlagPrefix = 2ull << 62;  // inclusive prefix
constexpr unsigned long long kValue = (1ull << 62) - 1;
constexpr long long kSpinLimit = 1ll << 31;  // look-back polls

// The scratch buffer, in ints (rtgs_tpu_torch/ops/peel.py:
// _segment_scratch_ints computes the same size): the zeroed head (counts,
// padded to whole tiles; the tiles' look-back states; four counters: the
// scan's ticket, the short runs listed, the long runs listed and the long
// runs taken), then starts (padded like the counts), ranks, the placed
// order, the list of long runs and the list of short runs.
struct Scratch {
  int* cnt;
  unsigned long long* state;
  int* counters;
  int* start;
  int* rank;
  int* order;
  int4* longs;   // {run's id, start, length, 0}
  int4* shorts;
  size_t zeroed_ints;

  __host__ __device__ Scratch(int* base, int m, int n_out) {
    const size_t ntile = static_cast<size_t>(n_out) / kTile + 1;
    cnt = base;
    state = reinterpret_cast<unsigned long long*>(base + ntile * kTile);
    counters = base + ntile * kTile + 2 * ntile;
    zeroed_ints = (ntile * kTile + 2 * ntile + 4 + 3) / 4 * 4;
    start = base + zeroed_ints;
    rank = start + ntile * kTile;
    order = rank + (m + 3) / 4 * 4;
    longs = reinterpret_cast<int4*>(order + (m + 3) / 4 * 4);
    shorts = longs + m / (kShort + 1) + 1;
  }
};

__device__ __forceinline__ void spin_guard(long long* spins) {
  if (++*spins > kSpinLimit) __trap();  // never on a correct launch
  __nanosleep(64);
}

__device__ __forceinline__ int warp_inclusive_sum(int v, int lane) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int u = __shfl_up_sync(kFull, v, d);
    if (lane >= d) v += u;
  }
  return v;
}

// ---- 1. histogram and ranks ----

__global__ void __launch_bounds__(256)
    hist_kernel(const int* __restrict__ ids, int m, int n_out, int* cnt,
                int* __restrict__ rank) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int lane = threadIdx.x & 31;
  const int id = i < m ? __ldg(ids + i) : -1;
  const bool valid = static_cast<unsigned>(id) < static_cast<unsigned>(n_out);
  const unsigned grp = __match_any_sync(kFull, valid ? id : -1);
  const int leader = __ffs(grp) - 1;
  int base = 0;
  if (valid && lane == leader) base = atomicAdd(cnt + id, __popc(grp));
  base = __shfl_sync(kFull, base, leader);
  if (valid) rank[i] = base + __popc(grp & ((1u << lane) - 1));
}

// ---- 2. run starts, zero rows, the lists of runs ----

// A warp's n entries a lane appended to the list *counter counts: one
// atomicAdd a warp; returns where this lane's first entry goes.
__device__ __forceinline__ int append(int* counter, int n, int lane) {
  const int incl = warp_inclusive_sum(n, lane);
  int base = 0;
  if (lane == 31 && incl > 0) base = atomicAdd(counter, incl);
  return __shfl_sync(kFull, base, 31) + incl - n;
}

__global__ void __launch_bounds__(kScanThreads)
    scan_kernel(const int* __restrict__ cnt, unsigned long long* state,
                int* counters, int* __restrict__ start,
                int4* __restrict__ shorts, int4* __restrict__ longs,
                float* __restrict__ out, int n_out) {
  __shared__ int s_cnt[kTile];
  __shared__ int s_warp[kScanThreads / 32];
  __shared__ int s_tile, s_prefix;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (tid == 0) s_tile = atomicAdd(counters, 1);
  __syncthreads();
  const int tile = s_tile;
  const size_t base = static_cast<size_t>(tile) * kTile;
  const int4* src = reinterpret_cast<const int4*>(cnt + base) + 2 * tid;
  const int4 a = src[0], b = src[1];
  const int c[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
  int sum = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    s_cnt[tid * 8 + j] = c[j];
    sum += c[j];
  }
  const int incl = warp_inclusive_sum(sum, lane);
  if (lane == 31) s_warp[warp] = incl;
  __syncthreads();
  int before = 0, total = 0;
#pragma unroll
  for (int w = 0; w < kScanThreads / 32; ++w) {
    before += w < warp ? s_warp[w] : 0;
    total += s_warp[w];
  }
  if (warp == 0) {
    // Publish the tile's total, then look back 32 tiles at a time: sum
    // the totals down to the nearest tile that knows its prefix.
    volatile unsigned long long* vs = state;
    if (lane == 0) {
      const unsigned long long flag = tile == 0 ? +kFlagPrefix : +kFlagAgg;
      vs[tile] = flag | static_cast<unsigned long long>(total);
    }
    unsigned long long prefix = 0;
    long long spins = 0;
    for (int p = tile - 1; p >= 0; p -= 32) {
      const int q = p - lane;
      unsigned long long st = +kFlagPrefix;  // before tile 0: a prefix of 0
      if (q >= 0) st = vs[q];
      while ((st & ~kValue) == 0) {
        spin_guard(&spins);
        st = vs[q];
      }
      const unsigned known = __ballot_sync(kFull, (st & ~kValue) == kFlagPrefix);
      const int nearest = known ? __ffs(known) - 1 : 32;
      unsigned long long part = lane <= nearest ? st & kValue : 0;
#pragma unroll
      for (int d = 16; d > 0; d >>= 1) part += __shfl_xor_sync(kFull, part, d);
      prefix += part;
      if (known) break;
    }
    if (lane == 0) {
      if (tile > 0) vs[tile] = kFlagPrefix | (prefix + total);
      s_prefix = static_cast<int>(prefix);
    }
  }
  __syncthreads();
  int run = s_prefix + before + incl - sum;
  int st[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    st[j] = run;
    run += c[j];
  }
  int4* dst = reinterpret_cast<int4*>(start + base) + 2 * tid;
  dst[0] = make_int4(st[0], st[1], st[2], st[3]);
  dst[1] = make_int4(st[4], st[5], st[6], st[7]);
  // The named runs, short and long, each list in id order within a warp.
  int n_short = 0, n_long = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    n_short += c[j] > 0 && c[j] <= kShort;
    n_long += c[j] > kShort;
  }
  int at_short = append(counters + 1, n_short, lane);
  int at_long = append(counters + 2, n_long, lane);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int4 run = make_int4(static_cast<int>(base) + tid * 8 + j, st[j],
                               c[j], 0);
    if (c[j] > 0 && c[j] <= kShort) shorts[at_short++] = run;
    if (c[j] > kShort) longs[at_long++] = run;
  }
  // Zero rows: a half-warp a row, 16 bytes a lane.
  const int half = tid >> 4, l16 = tid & 15;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int j = half; j < kTile; j += kScanThreads / 16) {
    const size_t r = base + j;
    if (r >= static_cast<size_t>(n_out)) break;
    if (s_cnt[j] == 0)
      __stcs(reinterpret_cast<float4*>(out + r * kRow) + l16, zero);
  }
}

// ---- 3. placement ----

__global__ void __launch_bounds__(256)
    place_kernel(const int* __restrict__ ids, const int* __restrict__ start,
                 const int* __restrict__ rank, int* __restrict__ order, int m,
                 int n_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= m) return;
  const int id = __ldg(ids + i);
  if (static_cast<unsigned>(id) < static_cast<unsigned>(n_out))
    order[__ldg(start + id) + __ldg(rank + i)] = i;
}

// ---- 4. the sums ----

// Streams the rows idx(0), ..., idx(n - 1) through add(row) in that
// order, two batches of kU rows in flight (the next batch loads while the
// current one is added); lane l holds lanes 2l and 2l + 1 of a row. n is
// the warp's, so every lane takes the branches that idx and add shuffle in.
template <int kU, class Index, class Add>
__device__ __forceinline__ void stream_rows(const float* __restrict__ rows,
                                            int n, Index idx, int lane,
                                            Add add) {
  const float2* src = reinterpret_cast<const float2*>(rows) + lane;
  float2 a[kU], b[kU];
  auto load = [&](float2(&v)[kU], int q) {
#pragma unroll
    for (int u = 0; u < kU; ++u)
      if (q + u < n)
        v[u] = __ldg(src + static_cast<size_t>(idx(q + u)) * (kRow / 2));
  };
  load(a, 0);
  for (int q = 0; q < n; q += 2 * kU) {
    load(b, q + kU);
#pragma unroll
    for (int u = 0; u < kU; ++u)
      if (q + u < n) add(a[u]);
    load(a, q + 2 * kU);
#pragma unroll
    for (int u = 0; u < kU; ++u)
      if (q + kU + u < n) add(b[u]);
  }
}

__device__ __forceinline__ void store_row(float* out, int r, int lane,
                                          float2 acc) {
  reinterpret_cast<float2*>(out + static_cast<size_t>(r) * kRow)[lane] = acc;
}

// Runs of 1 to 32 i, a warp each, taken in turn from the scan's list:
// one i a lane, each lane's place in ascending order counted over the
// run, then the rows in that order.
__global__ void __launch_bounds__(256)
    short_kernel(const float* __restrict__ rows, const int* __restrict__ order,
                 const int* counters, const int4* __restrict__ shorts,
                 float* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int n_short = __ldg(counters + 1);
  const int warps = gridDim.x * (blockDim.x >> 5);
  for (int w = (blockIdx.x * blockDim.x + threadIdx.x) >> 5; w < n_short;
       w += warps) {
    const int4 run = __ldg(shorts + w);
    const int c = run.z;
    const int v = lane < c ? __ldg(order + run.y + lane) : INT_MAX;
    int place = 0;
    for (int j = 0; j < c; ++j) place += __shfl_sync(kFull, v, j) < v;
    // Lane q takes the i whose place is q.
    int from = 0;
    for (int q = 0; q < c; ++q) {
      const unsigned at = __ballot_sync(kFull, place == q);
      if (lane == q) from = __ffs(at) - 1;
    }
    const int sorted = __shfl_sync(kFull, v, from);
    float2 acc = make_float2(0.f, 0.f);
    stream_rows<kShortRows>(
        rows, c, [&](int q) { return __shfl_sync(kFull, sorted, q); }, lane,
        [&](float2 x) {
          acc.x = acc.x + x.x;
          acc.y = acc.y + x.y;
        });
    store_row(out, run.x, lane, acc);
  }
}

// A run of more than 32 i, summed by one warp with kWarpBuf ints of shared
// memory: up to kWarpBuf i sorted there (bitonic, padded to a power of
// two); more through a bitmap of the i in windows of kBitmapWords words
// over [lo, hi], each window's i listed in order kListInts at a time.
__device__ void long_run(const float* __restrict__ rows, const int* order,
                         float* __restrict__ out, int r, int s, int c,
                         int lane, int* buf) {
  float2 acc = make_float2(0.f, 0.f);
  auto add = [&](float2 v) {
    acc.x = acc.x + v.x;
    acc.y = acc.y + v.y;
  };
  if (c <= kWarpBuf) {
    int n = 64;
    while (n < c) n <<= 1;
    for (int j = lane; j < n; j += 32)
      buf[j] = j < c ? __ldg(order + s + j) : INT_MAX;
    __syncwarp();
    for (int k = 2; k <= n; k <<= 1) {
      for (int j = k >> 1; j > 0; j >>= 1) {
        for (int t = lane; t < n / 2; t += 32) {
          const int i0 = 2 * j * (t / j) + t % j, i1 = i0 + j;
          const int x = buf[i0], y = buf[i1];
          if ((x > y) == ((i0 & k) == 0)) {
            buf[i0] = y;
            buf[i1] = x;
          }
        }
        __syncwarp();
      }
    }
    stream_rows<kLongRows>(rows, c, [&](int q) { return buf[q]; }, lane,
                           add);
  } else {
    int lo = INT_MAX, hi = -1;
    for (int j = lane; j < c; j += 32) {
      const int x = __ldg(order + s + j);
      lo = min(lo, x);
      hi = max(hi, x);
    }
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) {
      lo = min(lo, __shfl_xor_sync(kFull, lo, d));
      hi = max(hi, __shfl_xor_sync(kFull, hi, d));
    }
    unsigned* bits = reinterpret_cast<unsigned*>(buf);
    int* list = buf + kBitmapWords;
    for (long long w0 = lo; w0 <= hi; w0 += kBitmapWords * 32ll) {
      for (int j = lane; j < kBitmapWords; j += 32) bits[j] = 0u;
      __syncwarp();
      for (int j = lane; j < c; j += 32) {
        const long long x = __ldg(order + s + j) - w0;
        if (x >= 0 && x < kBitmapWords * 32ll)
          atomicOr(bits + (x >> 5), 1u << (x & 31));
      }
      __syncwarp();
      // kListInts / 32 words at a time: at most kListInts set bits.
      constexpr int kGroup = kListInts / 32;
      for (int g = 0; g < kBitmapWords; g += kGroup) {
        unsigned word = lane < kGroup ? bits[g + lane] : 0u;
        const int pop = __popc(word);
        const int incl = warp_inclusive_sum(pop, lane);
        const int n = __shfl_sync(kFull, incl, 31);
        int at = incl - pop;
        const int wbase = static_cast<int>(w0) + (g + lane) * 32;
        while (word) {
          list[at++] = wbase + __ffs(word) - 1;
          word &= word - 1;
        }
        __syncwarp();
        stream_rows<kLongRows>(rows, n, [&](int q) { return list[q]; }, lane,
                               add);
        __syncwarp();
      }
    }
  }
  store_row(out, r, lane, acc);
}

// A warp a long run at a time, taken in turn from the scan's list.
__global__ void __launch_bounds__(kLongThreads)
    long_kernel(const float* __restrict__ rows, const int* __restrict__ order,
                int* counters, const int4* __restrict__ longs,
                float* __restrict__ out) {
  __shared__ int s_buf[kLongThreads / 32][kWarpBuf];
  const int lane = threadIdx.x & 31;
  int* buf = s_buf[threadIdx.x >> 5];
  const int n_long = counters[2];
  if (n_long == 0) return;
  for (;;) {
    int k = 0;
    if (lane == 0) k = atomicAdd(counters + 3, 1);
    k = __shfl_sync(kFull, k, 0);
    if (k >= n_long) break;
    const int4 run = __ldg(longs + k);
    long_run(rows, order, out, run.x, run.y, run.z, lane, buf);
    __syncwarp();
  }
}

}  // namespace

// Returns the cudaError_t of the launches (0 on success). Shapes: rows
// (M, 64) f32; ids (M,) i32, those outside [0, n_out) skipped; scratch
// the int32 buffer of _segment_scratch_ints(M, n_out) ints, which the call
// initialises itself; out (n_out, 64) f32, every row of which the call
// writes once.
extern "C" int rtgs_segment_rows(const float* rows, const int* ids,
                                 int* scratch, float* out, int m, int n_out,
                                 int device, void* stream) {
  const cudaError_t err = use_device(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (m < 0 || n_out < 1) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Scratch sc(scratch, m, n_out);
  cudaError_t e = cudaMemsetAsync(scratch, 0, sc.zeroed_ints * sizeof(int),
                                  s);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (m > 0)
    hist_kernel<<<(m + 255) / 256, 256, 0, s>>>(ids, m, n_out, sc.cnt,
                                                 sc.rank);
  const int ntile = n_out / kTile + 1;
  scan_kernel<<<ntile, kScanThreads, 0, s>>>(sc.cnt, sc.state, sc.counters,
                                             sc.start, sc.shorts, sc.longs,
                                             out, n_out);
  if (m > 0) {
    place_kernel<<<(m + 255) / 256, 256, 0, s>>>(ids, sc.start, sc.rank,
                                                 sc.order, m, n_out);
    // Warps enough for the runs there can be, at most a card's worth.
    const int most = m < n_out ? m : n_out;
    int short_blocks = (most + 7) / 8;
    if (short_blocks > kMaxShortBlocks) short_blocks = kMaxShortBlocks;
    short_kernel<<<short_blocks, 256, 0, s>>>(rows, sc.order, sc.counters,
                                              sc.shorts, out);
    int blocks = (m / (kShort + 1) + kLongThreads / 32 - 1) / (kLongThreads / 32);
    if (blocks > kMaxLongBlocks) blocks = kMaxLongBlocks;
    if (blocks > 0)
      long_kernel<<<blocks, kLongThreads, 0, s>>>(rows, sc.order, sc.counters,
                                                  sc.longs, out);
  }
  return static_cast<int>(cudaGetLastError());
}

// Screen-tile candidate binning on Hopper (sm_90a): the (T, C) candidate
// matrix of render/binning.py:tile_candidates, bitwise its plain version
// tile_candidates_torch on the same inputs.
//
// Replaces no TPU kernel: the JAX package bins in XLA
// (rtgs_tpu/render/binning.py:tile_candidates) and sorts with XLA's sort.
// The port's plain chain is ~390 torch operations a call, which the host
// dispatches one by one: it fans every splat out to all of its narrow,
// wide and global slots (~21 million int32 keys at 1M splats, a quarter of
// them live), sorts them all with an int64 order and gathers the rows.
//
// Design: the live pairs only, placed in the plain version's slot order,
// then one stable sort. Two launching host calls, one host read between
// them (and two size queries, which launch nothing).
//  rtgs_binning_count (four kernels):
//   1. splat_kernel: a thread a splat: the 3σ box from quats/scales, its 8
//      corners into camera space, the pixel box, behind/off-screen/live, the
//      tile rectangle and class (dead, narrow, wide, global) and the depth
//      bound lb. A block writes its count of wide splats and its largest
//      live lb.
//   2. wide_kernel (one block): the blocks' exclusive scan of wide splats
//      (each wide splat's rank in id order) and dmax, the largest live lb.
//   3. slot_kernel: wide splats ranked at or past wlimit spill to the
//      global list; then per slot row (the narrow fan-out's slots, the wide
//      fan-out's, the global list) a block's live pairs, by warp ballots.
//   4. scan_kernel (one block): the exclusive scan of those counts, slot
//      row by slot row, each over the blocks in id order: each live pair's
//      place in the plain version's concatenation, less its dead slots. The
//      total, the live pairs, goes to the head, which the host reads.
//  rtgs_binning_rows (the library sort and three kernels):
//   5. emit_kernel: each live pair's key, tile·65536 + dq (the tile alone
//      past 32,767 tiles), and splat id at its place (ballots again).
//   6. CUB's stable radix sort of the pairs over the key's bits only.
//   7. bounds_kernel: each tile's first sorted pair (T + 2 starts; the
//      global list is segment T).
//   8. rows_kernel: a block a tile: [global list | the tile's pairs
//      nearest first | -1], counts, the overflow sums (integer atomics), and
//      chunk_lb: per chunk the least dequantised bound (or entry_lb where
//      smaller), suffix minima, a trailing 0.
//
// Bound. Bytes: each splat's inputs read once (44 B: means, quats, scales,
// mask), the live pairs' keys and ids written and read once, and the (T, C)
// int32 rows (and chunk_lb) written once; a radix sort that moves each
// pair once a pass is beside that. The splat pass's ~300 f32 operations a
// splat are far below the card's rate.
//
// Numerics. f32, the operations and their order of tile_candidates_torch
// (_rotation_columns, _camera_dot, _splat_boxes), built with --fmad=false:
// no product is fused into a sum, so every box edge is the plain
// version's. Integer counts, scans and ballots decide every place, so the
// result does not depend on the order in which blocks run. NaN inputs are
// outside the contract (fminf/fmaxf drop a NaN that torch keeps).

#include <cmath>
#include <cstdint>
#include <cub/device/device_radix_sort.cuh>
#include <cuda_runtime.h>

#include "launch_common.cuh"

namespace {

constexpr int kThreads = 256;            // splats a block
constexpr int kWarps = kThreads / 32;
constexpr int kScanThreads = 1024;       // the one-block scans
constexpr int kRowThreads = 256;         // a tile's row
constexpr unsigned kFull = 0xffffffffu;
// Slot rows counted at once (their warp counts in shared memory).
constexpr int kRowGroup = 512;
constexpr float kEps = 1e-6f;
// sqrt(G.BOUNDING_THRESHOLD) rounded to f32, as torch rounds the scalar.
constexpr float kSqrt3 = 1.7320508075688772f;
constexpr float kThreshold = 3.0f;       // G.BOUNDING_THRESHOLD

enum : int { kDead = 0, kNarrow = 1, kWide = 2, kGlobal = 3 };

// The two int32 buffers of a call are laid out here alone; the host asks
// their sizes (rtgs_binning_scratch_ints, rtgs_binning_pair_ints) and
// allocates what it is told.
//
// The per-splat scratch: head [dmax's bits, live pairs, -, -], then per
// splat its box (tx0, ty0, wx, wy), lb and class, then per block its wide
// count (scanned in place into the blocks' wide ranks) and largest lb, then
// the live-pair counts of slot row r and block b at r·nb + b (scanned in
// place into places).
struct Scratch {
  int* head;
  int4* box;
  float* lb;
  int* cls;
  int* wide;
  float* bmax;
  int* cnt;
  Scratch(int* s, int n, int nb)
      : head(s),
        box(reinterpret_cast<int4*>(s + 4)),
        lb(reinterpret_cast<float*>(s + 4 + 4 * static_cast<size_t>(n))),
        cls(s + 4 + 5 * static_cast<size_t>(n)),
        wide(s + 4 + 6 * static_cast<size_t>(n)),
        bmax(reinterpret_cast<float*>(wide + nb)),
        cnt(wide + 2 * static_cast<size_t>(nb)) {}
  static size_t ints(int n, int nb, int slots) {
    return 4 + 6 * static_cast<size_t>(n) +
           (2 + static_cast<size_t>(slots)) * nb;
  }
};

inline size_t up64(size_t ints) { return (ints + 63) / 64 * 64; }

// The sort's buffer: CUB's temporary storage, two key and two id buffers
// of the live pairs and the T + 2 segment starts, each rounded up to 256
// bytes.
struct Pairs {
  void* temp;
  unsigned* keys[2];
  int* ids[2];
  int* start;
  Pairs(int* s, size_t temp_bytes, int live) {
    size_t at = up64((temp_bytes + 3) / 4);
    temp = s;
    for (int k = 0; k < 2; ++k) {
      keys[k] = reinterpret_cast<unsigned*>(s + at);
      at += up64(live);
    }
    for (int k = 0; k < 2; ++k) {
      ids[k] = s + at;
      at += up64(live);
    }
    start = s + at;
  }
  static size_t ints(size_t temp_bytes, int live, int num_tiles) {
    return up64((temp_bytes + 3) / 4) + 4 * up64(live) +
           up64(static_cast<size_t>(num_tiles) + 2);
  }
};

// _rotation_columns: c[i][j] is component j of q e_i q*, from (x, y, z, w).
__device__ __forceinline__ void rotation_columns(float x, float y, float z,
                                                 float w, float c[3][3]) {
  const float v[3] = {x, y, z};
  const float r[3][3] = {{w, z, -y}, {-z, w, x}, {y, -x, w}};
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const int a = (j + 1) % 3, b = (j + 2) % 3;
      c[i][j] = (w * r[i][j] + v[i] * v[j]) + (v[a] * r[i][b] - v[b] * r[i][a]);
    }
  }
}

__device__ __forceinline__ int tile_of(float v, int nt, int t) {
  const float f = fminf(fmaxf(floorf(v / static_cast<float>(t)), 0.0f),
                        static_cast<float>(nt - 1));
  return static_cast<int>(f);
}

struct Geometry {
  const float* means;
  const float* quats;
  const float* scales;
  const float* mask;
  const float* position;
  const float* rotation;
  const float* focal;
  int n, w, h, tw, th, ntx, nty, mtx, mty, narrow, wide_slots;
  float pad;
};

// One splat of _splat_boxes and the classes of tile_candidates_torch
// (before the wide budget's spill).
__device__ void splat_box(const Geometry& g, int i, int4& box, float& lb,
                          int& cls) {
  float cc[3][3];
  rotation_columns(__ldg(g.rotation), __ldg(g.rotation + 1),
                   __ldg(g.rotation + 2), __ldg(g.rotation + 3), cc);
  const float pos[3] = {__ldg(g.position), __ldg(g.position + 1),
                        __ldg(g.position + 2)};
  const float fx = __ldg(g.focal), fy = __ldg(g.focal + 1);
  const float m[3] = {g.means[3 * i], g.means[3 * i + 1], g.means[3 * i + 2]};
  const float s[3] = {g.scales[3 * i], g.scales[3 * i + 1],
                      g.scales[3 * i + 2]};
  float rc[3][3];
  rotation_columns(g.quats[4 * i], g.quats[4 * i + 1], g.quats[4 * i + 2],
                   g.quats[4 * i + 3], rc);
  // P[j][side][k]: the offset of the box's side on axis j from the camera,
  // times component j of camera column k.
  float P[3][2][3];
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    const float ext = fmaxf(fmaxf(fabsf(rc[0][j] * s[0]),
                                  fabsf(rc[1][j] * s[1])),
                            fabsf(rc[2][j] * s[2])) * kThreshold;
    const float d0 = (m[j] - ext) - pos[j], d1 = (m[j] + ext) - pos[j];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      P[j][0][k] = d0 * cc[k][j];
      P[j][1][k] = d1 * cc[k][j];
    }
  }
  const float cx = static_cast<float>(g.w) * 0.5f - 0.5f;
  const float cy = static_cast<float>(g.h) * 0.5f - 0.5f;
  bool behind = false;
  float px_min = INFINITY, px_max = -INFINITY;
  float py_min = INFINITY, py_max = -INFINITY;
#pragma unroll
  for (int corner = 0; corner < 8; ++corner) {
    const int a = corner >> 2, b = (corner >> 1) & 1, c = corner & 1;
    float pc[3];
#pragma unroll
    for (int k = 0; k < 3; ++k)
      pc[k] = (P[0][a][k] + P[1][b][k]) + P[2][c][k];
    behind |= pc[2] > -kEps;
    const float zs = fminf(pc[2], -kEps);
    const float px = fx * pc[0] / (-zs) + cx;
    const float py = fy * pc[1] / (-zs) + cy;
    px_min = fminf(px_min, px);
    px_max = fmaxf(px_max, px);
    py_min = fminf(py_min, py);
    py_max = fmaxf(py_max, py);
  }
  px_min = px_min - g.pad;
  px_max = px_max + g.pad;
  py_min = py_min - g.pad;
  py_max = py_max + g.pad;
  const bool off_screen =
      px_max < -0.5f || px_min > static_cast<float>(g.w) - 0.5f ||
      py_max < -0.5f || py_min > static_cast<float>(g.h) - 0.5f;
  const bool live = g.mask[i] > 0.0f && (behind || !off_screen);
  const int tx0 = tile_of(px_min, g.ntx, g.tw);
  const int tx1 = tile_of(px_max, g.ntx, g.tw);
  const int ty0 = tile_of(py_min, g.nty, g.th);
  const int ty1 = tile_of(py_max, g.nty, g.th);
  box = make_int4(tx0, ty0, tx1 - tx0 + 1, ty1 - ty0 + 1);
  // Center depth − √3·s_max, clamped at 0.
  const float depth =
      -(((m[0] - pos[0]) * cc[2][0] + (m[1] - pos[1]) * cc[2][1]) +
        (m[2] - pos[2]) * cc[2][2]);
  lb = fmaxf(depth - kSqrt3 * fmaxf(fmaxf(s[0], s[1]), s[2]), 0.0f);
  if (!live) {
    cls = kDead;
  } else if (behind || box.z > g.mtx || box.w > g.mty) {
    cls = kGlobal;
  } else if (g.wide_slots > 0 && (box.z > g.narrow || box.w > g.narrow)) {
    cls = kWide;
  } else {
    cls = kNarrow;
  }
}

__global__ void __launch_bounds__(kThreads)
    splat_kernel(Geometry g, Scratch sc) {
  __shared__ int s_wide[kWarps];
  __shared__ float s_max[kWarps];
  const int i = blockIdx.x * kThreads + threadIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int cls = kDead;
  float live_lb = 0.0f;
  if (i < g.n) {
    int4 box;
    float lb;
    splat_box(g, i, box, lb, cls);
    sc.box[i] = box;
    sc.lb[i] = lb;
    sc.cls[i] = cls;
    if (cls != kDead) live_lb = lb;
  }
  const int wide = __popc(__ballot_sync(kFull, cls == kWide));
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    live_lb = fmaxf(live_lb, __shfl_xor_sync(kFull, live_lb, o));
  if (lane == 0) {
    s_wide[warp] = wide;
    s_max[warp] = live_lb;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int total = 0;
    float mx = 0.0f;
    for (int k = 0; k < kWarps; ++k) {
      total += s_wide[k];
      mx = fmaxf(mx, s_max[k]);
    }
    sc.wide[blockIdx.x] = total;
    sc.bmax[blockIdx.x] = mx;
  }
}

__device__ __forceinline__ int warp_inclusive(int v, int lane) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int u = __shfl_up_sync(kFull, v, o);
    if (lane >= o) v += u;
  }
  return v;
}

// Exclusive prefix sum of data[0, len) in place by one block of
// kScanThreads: each warp a contiguous stretch, read 32 at a time
// (coalesced), its total first, then the warps' offsets, then the scan.
// Returns the total (to every thread).
__device__ int block_scan(int* data, int len) {
  constexpr int kScanWarps = kScanThreads / 32;
  __shared__ int s_warp[kScanWarps];
  __shared__ int s_total;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int per = (len + kScanWarps - 1) / kScanWarps;
  const int lo = min(warp * per, len), hi = min(lo + per, len);
  // Four loads in flight a lane: a warp's stretch is read 128 at a time.
  int sum = 0;
  for (int k = lo + lane; k < hi; k += 128) {
#pragma unroll
    for (int e = 0; e < 4; ++e)
      sum += k + 32 * e < hi ? data[k + 32 * e] : 0;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(kFull, sum, o);
  if (lane == 0) s_warp[warp] = sum;
  __syncthreads();
  if (warp == 0) {
    const int v = s_warp[lane];
    const int incl = warp_inclusive(v, lane);
    s_warp[lane] = incl - v;
    if (lane == 31) s_total = incl;
  }
  __syncthreads();
  // 128 at a time again, four consecutive a lane.
  int run = s_warp[warp];
  for (int k0 = lo; k0 < hi; k0 += 128) {
    const int k = k0 + 4 * lane;
    int v[4], t = 0;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      v[e] = k + e < hi ? data[k + e] : 0;
      t += v[e];
    }
    const int incl = warp_inclusive(t, lane);
    int at = run + incl - t;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (k + e < hi) data[k + e] = at;
      at += v[e];
    }
    run += __shfl_sync(kFull, incl, 31);
  }
  const int total = s_total;
  __syncthreads();
  return total;
}

__global__ void __launch_bounds__(kScanThreads)
    wide_kernel(Scratch sc, int nb) {
  block_scan(sc.wide, nb);
  __shared__ float s_max[kScanThreads / 32];
  float mx = 0.0f;
  for (int b = threadIdx.x; b < nb; b += kScanThreads)
    mx = fmaxf(mx, sc.bmax[b]);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, o));
  if ((threadIdx.x & 31) == 0) s_max[threadIdx.x >> 5] = mx;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int k = 0; k < kScanThreads / 32; ++k) mx = fmaxf(mx, s_max[k]);
    sc.head[0] = __float_as_int(fmaxf(mx, 1e-6f));
  }
}

// The slot rows, in the plain chain's order: the narrow fan-out's narrow²
// slots (dx·narrow + dy), the wide fan-out's wide_slots (dx·mty + dy), the
// global list.
struct SlotRows {
  int narrow, wide_slots, mty;
  __device__ __forceinline__ int count() const {
    return narrow * narrow + wide_slots + 1;
  }
  __device__ __forceinline__ int wide_end() const {
    return narrow * narrow + wide_slots;
  }
  __device__ __forceinline__ bool wide_row(int r) const {
    return r >= narrow * narrow && r < wide_end();
  }
  // Row r's class and tile offset, packed: class << 28 | dx << 14 | dy
  // (one division a row and block; the loops then read it from shared
  // memory).
  __device__ __forceinline__ int code(int r) const {
    const int nn = narrow * narrow;
    if (r < nn) return kNarrow << 28 | (r / narrow) << 14 | (r % narrow);
    r -= nn;
    if (r < wide_slots) return kWide << 28 | (r / mty) << 14 | (r % mty);
    return kGlobal << 28;
  }
};

// Does the splat of class cls and box occupy the row of this code?
__device__ __forceinline__ bool occupies(int code, int cls, const int4& box) {
  return cls == code >> 28 &&
         (cls == kGlobal ||
          ((code >> 14) & 0x3fff) < box.z && (code & 0x3fff) < box.w);
}

// The tile of a fan-out row's code (not the global row's).
__device__ __forceinline__ int code_tile(int code, const int4& box, int nty) {
  return (box.x + ((code >> 14) & 0x3fff)) * nty + (box.y + (code & 0x3fff));
}

// The codes of rows [r0, r1) into s_code, by the whole block.
__device__ __forceinline__ void row_codes(const SlotRows& rows, int r0,
                                          int r1, int* s_code) {
  for (int r = r0 + threadIdx.x; r < r1; r += blockDim.x)
    s_code[r - r0] = rows.code(r);
  __syncthreads();
}

// Warp w's live pairs in slot row r0 + q of this block, into
// s_rows[q·kWarps + w], for the rows of one group [r0, r1). A warp with no
// wide splat (any_wide: most warps) writes zeros for the wide rows.
__device__ __forceinline__ void count_rows(const SlotRows& rows, int r0,
                                           int r1, int cls, const int4& box,
                                           bool any_wide, const int* s_code,
                                           int* s_rows) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int r = r0; r < r1; ++r) {
    if (!any_wide && rows.wide_row(r)) {
      const int end = min(r1, rows.wide_end());
      for (int q = r + lane; q < end; q += 32)
        s_rows[(q - r0) * kWarps + warp] = 0;
      r = end - 1;
      continue;
    }
    const unsigned bal =
        __ballot_sync(kFull, occupies(s_code[r - r0], cls, box));
    if (lane == 0) s_rows[(r - r0) * kWarps + warp] = __popc(bal);
  }
}

__global__ void __launch_bounds__(kThreads)
    slot_kernel(Scratch sc, SlotRows rows, int n, int nb, int wlimit) {
  __shared__ int s_rows[kRowGroup * kWarps];
  __shared__ int s_code[kRowGroup];
  __shared__ int s_warp[kWarps];
  const int i = blockIdx.x * kThreads + threadIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int cls = kDead;
  int4 box = make_int4(0, 0, 0, 0);
  if (i < n) {
    cls = sc.cls[i];
    box = sc.box[i];
  }
  // Each wide splat's rank in id order; past the budget it spills.
  const unsigned bal = __ballot_sync(kFull, cls == kWide);
  if (lane == 0) s_warp[warp] = __popc(bal);
  __syncthreads();
  int before = sc.wide[blockIdx.x];
  for (int k = 0; k < warp; ++k) before += s_warp[k];
  if (cls == kWide &&
      before + __popc(bal & ((1u << lane) - 1)) >= wlimit) {
    cls = kGlobal;
    sc.cls[i] = cls;
  }
  const bool any_wide = __any_sync(kFull, cls == kWide);
  const int nrows = rows.count();
  for (int r0 = 0; r0 < nrows; r0 += kRowGroup) {
    const int r1 = min(r0 + kRowGroup, nrows);
    row_codes(rows, r0, r1, s_code);
    count_rows(rows, r0, r1, cls, box, any_wide, s_code, s_rows);
    __syncthreads();
    for (int r = r0 + threadIdx.x; r < r1; r += kThreads) {
      int total = 0;
      for (int k = 0; k < kWarps; ++k) total += s_rows[(r - r0) * kWarps + k];
      sc.cnt[static_cast<size_t>(r) * nb + blockIdx.x] = total;
    }
    __syncthreads();
  }
}

__global__ void __launch_bounds__(kScanThreads)
    scan_kernel(Scratch sc, int len) {
  const int total = block_scan(sc.cnt, len);
  if (threadIdx.x == 0) sc.head[1] = total;
}

__global__ void __launch_bounds__(kThreads)
    emit_kernel(Scratch sc, SlotRows rows, int n, int nb, int nty,
                int num_tiles, int sbits, unsigned* keys, int* ids) {
  __shared__ int s_rows[kRowGroup * kWarps];
  __shared__ int s_code[kRowGroup];
  const int i = blockIdx.x * kThreads + threadIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int cls = kDead;
  int4 box = make_int4(0, 0, 0, 0);
  unsigned dq = 0;
  if (i < n) {
    cls = sc.cls[i];
    box = sc.box[i];
    const float dmax = __int_as_float(sc.head[0]);
    dq = static_cast<unsigned>(static_cast<int>(
        fminf(fmaxf(sc.lb[i] / dmax * 65535.0f, 0.0f), 65534.0f)));
  }
  const unsigned below = (1u << lane) - 1;
  const bool any_wide = __any_sync(kFull, cls == kWide);
  const int nrows = rows.count();
  for (int r0 = 0; r0 < nrows; r0 += kRowGroup) {
    const int r1 = min(r0 + kRowGroup, nrows);
    row_codes(rows, r0, r1, s_code);
    count_rows(rows, r0, r1, cls, box, any_wide, s_code, s_rows);
    __syncthreads();
    // Each row's warp counts into the warps' offsets in the block.
    for (int r = r0 + threadIdx.x; r < r1; r += kThreads) {
      int run = 0;
      for (int k = 0; k < kWarps; ++k) {
        const int v = s_rows[(r - r0) * kWarps + k];
        s_rows[(r - r0) * kWarps + k] = run;
        run += v;
      }
    }
    __syncthreads();
    for (int r = r0; r < r1; ++r) {
      if (!any_wide && rows.wide_row(r)) {
        r = min(r1, rows.wide_end()) - 1;
        continue;
      }
      const int code = s_code[r - r0];
      const bool occ = occupies(code, cls, box);
      const unsigned bal = __ballot_sync(kFull, occ);
      if (!occ) continue;
      const int at = sc.cnt[static_cast<size_t>(r) * nb + blockIdx.x] +
                     s_rows[(r - r0) * kWarps + warp] + __popc(bal & below);
      const int tile = cls == kGlobal ? num_tiles : code_tile(code, box, nty);
      keys[at] = (static_cast<unsigned>(tile) << sbits) | (sbits ? dq : 0u);
      ids[at] = i;
    }
    __syncthreads();
  }
}

// start[t] = the first sorted pair of tile t or later, t in [0, T + 1];
// start[T + 1] = live.
__global__ void bounds_kernel(const unsigned* __restrict__ keys, int live,
                              int num_tiles, int sbits, int* start,
                              unsigned long long* local_overflow) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i == 0) *local_overflow = 0ull;
  if (live == 0) {
    if (i == 0)
      for (int t = 0; t <= num_tiles + 1; ++t) start[t] = 0;
    return;
  }
  if (i >= live) return;
  const int t = static_cast<int>(keys[i] >> sbits);
  const int prev = i == 0 ? -1 : static_cast<int>(keys[i - 1] >> sbits);
  for (int u = prev + 1; u <= t; ++u) start[u] = i;
  if (i == live - 1)
    for (int u = t + 1; u <= num_tiles + 1; ++u) start[u] = live;
}

struct RowArgs {
  const unsigned* keys;
  const int* ids;
  const int* start;
  const int* head;
  const float* entry_lb;
  int* candidates;
  int* counts;
  unsigned long long* local_overflow;
  int* global_overflow;
  float* chunk_lb;
  int num_tiles, sbits, max_candidates, max_global, total_c, chunk;
};

__global__ void __launch_bounds__(kRowThreads) rows_kernel(RowArgs a) {
  constexpr int kRowWarps = kRowThreads / 32;
  const int t = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int s0 = a.start[t], s1 = a.start[t + 1];
  const int g0 = a.start[a.num_tiles], g1 = a.start[a.num_tiles + 1];
  const int cl = min(s1 - s0, a.max_candidates);
  const int ng = min(g1 - g0, a.max_global);
  if (threadIdx.x == 0) {
    a.counts[t] = cl + ng;
    if (s1 - s0 > a.max_candidates)
      atomicAdd(a.local_overflow,
                static_cast<unsigned long long>(s1 - s0 - a.max_candidates));
    if (t == 0) *a.global_overflow = max(g1 - g0 - a.max_global, 0);
  }
  // Chunks a warp at a time (segments of 128 without chunk_lb).
  const bool bounds = a.chunk > 0 && a.chunk_lb != nullptr;
  const int seg = a.chunk > 0 ? a.chunk : 128;
  const int nseg = (a.total_c + seg - 1) / seg;
  const float scale =
      bounds && a.sbits ? __int_as_float(a.head[0]) / 65535.0f : 0.0f;
  int* row = a.candidates + static_cast<size_t>(t) * a.total_c;
  float* out = bounds ? a.chunk_lb + static_cast<size_t>(t) * (nseg + 1)
                      : nullptr;
  for (int c = warp; c < nseg; c += kRowWarps) {
    const int j1 = min((c + 1) * seg, a.total_c);
    float cmin = INFINITY;
    for (int j = c * seg + lane; j < j1; j += 32) {
      int src = -1;
      if (j < ng)
        src = g0 + j;
      else if (j - ng < cl)
        src = s0 + (j - ng);
      int id = -1;
      if (src >= 0) {
        id = a.ids[src];
        if (bounds && a.sbits) {
          float v = static_cast<float>(a.keys[src] & 0xffffu) * scale;
          if (a.entry_lb != nullptr) v = fminf(v, __ldg(a.entry_lb + id));
          cmin = fminf(cmin, v);
        }
      }
      row[j] = id;
    }
    if (bounds) {
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        cmin = fminf(cmin, __shfl_xor_sync(kFull, cmin, o));
      if (lane == 0) out[c] = a.sbits ? cmin : 0.0f;
    }
  }
  if (!bounds) return;
  // The chunks' minima into suffix minima, in place (the block's own
  // writes, visible to it after the barrier), and the trailing 0.
  __syncthreads();
  if (threadIdx.x == 0) {
    out[nseg] = 0.0f;
    float run = INFINITY;
    for (int c = nseg - 1; c >= 0; --c) {
      run = fminf(run, out[c]);
      out[c] = run;
    }
  }
}

int end_bit(int num_tiles, int sbits) {
  const unsigned most = (static_cast<unsigned>(num_tiles) << sbits) |
                        (sbits ? 0xffffu : 0u);
  int bits = 1;
  while (bits < 32 && (most >> bits) != 0u) ++bits;
  return bits;
}

// CUB's temporary storage, in bytes, for the sort of `live` pairs with keys
// of num_tiles tiles (sbits 16: packed with the depth; 0: the tile alone).
// Launches nothing.
cudaError_t sort_temp_bytes(int live, int num_tiles, int sbits,
                            cudaStream_t s, size_t* bytes) {
  *bytes = 0;
  cub::DoubleBuffer<unsigned> keys(nullptr, nullptr);
  cub::DoubleBuffer<int> ids(nullptr, nullptr);
  return cub::DeviceRadixSort::SortPairs(nullptr, *bytes, keys, ids, live, 0,
                                         end_bit(num_tiles, sbits), s);
}

}  // namespace

// Returns the cudaError_t of the launches (0 on success). Inputs: means
// (n, 3), quats (n, 4), scales (n, 3), mask (n,) f32; the camera's position
// (3,), rotation (4,) and focal length (2,) f32. scratch: an int32 buffer
// of rtgs_binning_scratch_ints(n, narrow² + wide_slots + 1) ints, which the
// call fills; its int 1 is then the live-pair count.
extern "C" int rtgs_binning_count(const float* means, const float* quats,
                                  const float* scales, const float* mask,
                                  const float* position,
                                  const float* rotation, const float* focal,
                                  int* scratch, int n, int w, int h, int tw,
                                  int th, int ntx, int nty, int mtx, int mty,
                                  int narrow, int wide_slots, int wlimit,
                                  float pad, int device, void* stream) {
  const cudaError_t err = use_device(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n < 0 || narrow < 1) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nb = (n + kThreads - 1) / kThreads;
  const Scratch sc(scratch, n, nb);
  const Geometry g{means, quats, scales, mask, position, rotation, focal,
                   n, w, h, tw, th, ntx, nty, mtx, mty, narrow, wide_slots,
                   pad};
  const SlotRows rows{narrow, wide_slots, mty};
  const int nrows = narrow * narrow + wide_slots + 1;
  if (nb > 0) splat_kernel<<<nb, kThreads, 0, s>>>(g, sc);
  wide_kernel<<<1, kScanThreads, 0, s>>>(sc, nb);
  if (nb > 0) slot_kernel<<<nb, kThreads, 0, s>>>(sc, rows, n, nb, wlimit);
  scan_kernel<<<1, kScanThreads, 0, s>>>(sc, nrows * nb);
  return static_cast<int>(cudaGetLastError());
}

// Into *ints (a host pointer): the size in int32 of the scratch of n
// splats and `slots` slot rows. Launches nothing.
extern "C" int rtgs_binning_scratch_ints(int n, int slots, long long* ints,
                                         int device, void* stream) {
  (void)device;
  (void)stream;
  if (n < 0 || slots < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int nb = (n + kThreads - 1) / kThreads;
  *ints = static_cast<long long>(Scratch::ints(n, nb, slots));
  return 0;
}

// Into *ints (a host pointer): the size in int32 of the sort's buffer for
// `live` pairs with keys of num_tiles tiles (sbits 16: packed with the
// depth; 0: the tile alone). Launches nothing.
extern "C" int rtgs_binning_pair_ints(int live, int num_tiles, int sbits,
                                      long long* ints, int device,
                                      void* stream) {
  const cudaError_t err = use_device(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (live < 0 || num_tiles < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  size_t bytes = 0;
  const cudaError_t e = sort_temp_bytes(live, num_tiles, sbits,
                                        static_cast<cudaStream_t>(stream),
                                        &bytes);
  *ints = static_cast<long long>(Pairs::ints(bytes, live, num_tiles));
  return static_cast<int>(e);
}

// Returns the cudaError_t of the launches (0 on success). scratch: as
// rtgs_binning_count left it; pairs: an int32 buffer of
// rtgs_binning_pair_ints(live, num_tiles, sbits) ints; entry_lb (n,) f32
// or null.
// Outputs: candidates (T, total_c) int32, counts (T,) int32,
// local_overflow () int64, global_overflow () int32, chunk_lb
// (T, total_c / chunk + 1) f32 or null (chunk 0: none).
extern "C" int rtgs_binning_rows(
    int* scratch, int* pairs, const float* entry_lb, int* candidates,
    int* counts, long long* local_overflow, int* global_overflow,
    float* chunk_lb, int n, int slots, int narrow, int wide_slots, int mty,
    int nty, int num_tiles, int sbits, int live, int max_candidates,
    int max_global, int total_c, int chunk, int device, void* stream) {
  const cudaError_t err = use_device(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (slots != narrow * narrow + wide_slots + 1 || num_tiles < 1 ||
      live < 0 || total_c < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nb = (n + kThreads - 1) / kThreads;
  const Scratch sc(scratch, n, nb);
  size_t bytes = 0;
  cudaError_t e = sort_temp_bytes(live, num_tiles, sbits, s, &bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  Pairs p(pairs, bytes, live);
  const SlotRows rows{narrow, wide_slots, mty};
  if (live > 0) {
    emit_kernel<<<nb, kThreads, 0, s>>>(sc, rows, n, nb, nty, num_tiles,
                                        sbits, p.keys[0], p.ids[0]);
    cub::DoubleBuffer<unsigned> keys(p.keys[0], p.keys[1]);
    cub::DoubleBuffer<int> ids(p.ids[0], p.ids[1]);
    e = cub::DeviceRadixSort::SortPairs(p.temp, bytes, keys, ids, live, 0,
                                        end_bit(num_tiles, sbits), s);
    if (e != cudaSuccess) return static_cast<int>(e);
    p.keys[0] = keys.Current();
    p.ids[0] = ids.Current();
  }
  const int bthreads = 256;
  const int bblocks = live > 0 ? (live + bthreads - 1) / bthreads : 1;
  bounds_kernel<<<bblocks, bthreads, 0, s>>>(
      p.keys[0], live, num_tiles, sbits, p.start,
      reinterpret_cast<unsigned long long*>(local_overflow));
  const RowArgs a{p.keys[0], p.ids[0], p.start, sc.head, entry_lb,
                  candidates, counts,
                  reinterpret_cast<unsigned long long*>(local_overflow),
                  global_overflow, chunk_lb, num_tiles, sbits,
                  max_candidates, max_global, total_c, chunk};
  rows_kernel<<<num_tiles, kRowThreads, 0, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// Device code shared by the fused-payload peel (peel_fwd.cu, peel_bwd.cu)
// and the top-K peel (peel_topk_fwd.cu, peel_topk_bwd.cu) on Hopper
// (sm_90a): the per-pixel top-K sweep over a tile's candidate slots, the
// f32 shading of one winner, the chain of per-layer cotangents into
// per-slot feature gradients, and the launch dispatch over the list
// capacity K.
//
// Geometry of every kernel here: one block per tile, one thread per pixel
// (blocks of at most kThreads; a tile with more pixels is swept once per
// group of kThreads).
//
// Numerics. The entry depth runs in float64 from the f32 tables and is
// rounded to f32 once (B² and 4A·c0 cancel in Δ), with the operations and
// order of rtgs_tpu_torch.ops.peel.entry_depth; shading is f32 in the
// order of rtgs_tpu_torch.ops.peel._shade_layers; the gradient chain
// follows rtgs_tpu_torch.ops.peel._slot_grads. Built with IEEE sqrt and
// division and --fmad=false, so the winners are bitwise the plain twins'.

#pragma once

#include <climits>
#include <cuda_runtime.h>
#include <math_constants.h>

#include <type_traits>

namespace {

constexpr int kChunk = 128;    // candidate slots per sweep step (CHUNK)
constexpr int kFeat = 64;      // packed feature row width
constexpr int kLanes = 59;     // lanes with a gradient (59:64 are padding)
constexpr int kPixFeat = 24;   // pixel feature row width
constexpr int kStage = 10;     // staged lanes: m6 (0:6), Me (6:9), c0 (9)
constexpr int kThreads = 256;  // pixels per group
constexpr int kMaxDepth = 64;  // largest list capacity instantiated

__device__ __forceinline__ bool lex_less(float ta, int sa, float tb, int sb) {
  return ta < tb || (ta == tb && sa < sb);
}

// One pixel's features: its ray direction, the d-quadratic features and
// the SH basis (lanes 0:3, 3:9 and 9:24 of its pix row).
struct Pixel {
  float dir[3], fd[6], y[15];
};

__device__ __forceinline__ Pixel load_pixel(const float* q) {
  Pixel px;
#pragma unroll
  for (int j = 0; j < 3; ++j) px.dir[j] = q[j];
#pragma unroll
  for (int j = 0; j < 6; ++j) px.fd[j] = q[3 + j];
#pragma unroll
  for (int j = 0; j < 15; ++j) px.y[j] = q[9 + j];
  return px;
}

// Shared memory of the sweep: lanes 0-9 of one chunk's rows, as float64.
struct SweepStage {
  double feat[kStage][kChunk];
  int live[kChunk];
};

// The K nearest hits of the pixel whose pix row is q, among the tile's
// slots [0, n_chunks·128), as a (t1, slot) list sorted lexicographically;
// vacant entries stay (+inf, INT_MAX). The block stages lanes 0-9 of each
// chunk's candidate rows straight from packed[cand[t, c]] (as float64, once
// per block), so no (T, C, 64) gather exists; a −1 slot is skipped (it
// would read the sentinel row, which never hits). Slots arrive in
// increasing order, so a hit whose t1 equals a listed one sorts after it:
// the TPU merge's lower-lane tie-break. Every thread of the block must call
// this (it synchronises); an inactive one only helps to stage.
template <int K>
__device__ __forceinline__ void sweep_topk(const float* __restrict__ packed,
                                           const int* __restrict__ cand_t,
                                           int n_chunks, bool active,
                                           const float* q, SweepStage& st,
                                           float (&kt)[K], int (&ks)[K]) {
  const double d0 = q[0], d1 = q[1], d2 = q[2];
  const double f0 = q[3], f1 = q[4], f2 = q[5], f3 = q[6], f4 = q[7],
               f5 = q[8];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    kt[k] = CUDART_INF_F;
    ks[k] = INT_MAX;
  }

  for (int c = 0; c < n_chunks; ++c) {
    __syncthreads();  // the previous chunk's readers are done
    for (int e = threadIdx.x; e < kChunk * kStage; e += blockDim.x) {
      const int i = e / kStage;
      const int lane = e - i * kStage;
      const int id = cand_t[c * kChunk + i];
      if (lane == 0) st.live[i] = id >= 0;
      st.feat[lane][i] =
          id >= 0 ? static_cast<double>(
                        packed[static_cast<size_t>(id) * kFeat + lane])
                  : 0.0;
    }
    __syncthreads();
    if (!active) continue;

#pragma unroll 2
    for (int i = 0; i < kChunk; ++i) {
      if (!st.live[i]) continue;
      double a = f0 * st.feat[0][i];
      a = a + f1 * st.feat[1][i];
      a = a + f2 * st.feat[2][i];
      a = a + f3 * st.feat[3][i];
      a = a + f4 * st.feat[4][i];
      a = a + f5 * st.feat[5][i];
      double b = d0 * st.feat[6][i];
      b = b + d1 * st.feat[7][i];
      b = b + d2 * st.feat[8][i];
      b = 2.0 * b;
      const double delta = b * b - (4.0 * a) * st.feat[9][i];
      if (!(delta >= 0.0)) continue;  // miss (or NaN)
      const double sq = sqrt(delta > 0.0 ? delta : 0.0);
      const double t1d = (-b - sq) / (2.0 * a);
      if (!(t1d > 0.0)) continue;
      const float t1 = static_cast<float>(t1d);
      const int slot = c * kChunk + i;
      if (!lex_less(t1, slot, kt[K - 1], ks[K - 1])) continue;
      // Insert: one compare-exchange pass carries the larger pair down.
      float ct = t1;
      int cs = slot;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const bool lt = lex_less(ct, cs, kt[k], ks[k]);
        const float tk = kt[k];
        const int sk = ks[k];
        kt[k] = lt ? ct : tk;
        ks[k] = lt ? cs : sk;
        ct = lt ? tk : ct;
        cs = lt ? sk : cs;
      }
    }
  }
}

// f32 response of one row to one pixel: the quadratic (a, b), ρ and α.
struct Quad {
  float a, b, rho, alpha;
};

// α = op·exp(B²/4A − (c0+3)) if Δ > 0, else 0 (a tangent winner keeps its
// layer with α = 0).
__device__ __forceinline__ Quad quad(const float* row, const Pixel& px) {
  float a = px.fd[0] * row[0];
#pragma unroll
  for (int j = 1; j < 6; ++j) a = a + px.fd[j] * row[j];
  float b = px.dir[0] * row[6];
  b = b + px.dir[1] * row[7];
  b = b + px.dir[2] * row[8];
  b = 2.f * b;
  const float cq = row[9];
  const float delta = b * b - (4.f * a) * cq;
  const float rho = delta > 0.f ? expf(b * b / (4.f * a) - (cq + 3.f)) : 0.f;
  return {a, b, rho, row[10] * rho};
}

// rgb = color + y·SH, channel ch.
__device__ __forceinline__ float color(const float* row, const Pixel& px,
                                       int ch) {
  const float* sh = row + 14 + 15 * ch;
  float acc = px.y[0] * sh[0];
#pragma unroll
  for (int j = 1; j < 15; ++j) acc = acc + px.y[j] * sh[j];
  return row[11 + ch] + acc;
}

// Per-slot feature gradients of one pixel group's layers, added into the
// tile's (C, 64) rows out_t. Layer k of this thread's pixel sits at slot
// sl[k] (−1 vacant) with cotangents ga[k] = ∂L/∂α and (gr, gg, gb)[k] =
// ∂L/∂rgb; through α = op·exp(B²/4A − (c0+3)) and rgb = color + y·SH, per
// row lane:
//   0:6  dA·fd      dA  = ga·α·(−B²/4A²)
//   6:9  2·dB·d     dB  = ga·α·B/2A
//   9    −ga·α      10  ga·ρ (masked by acceptance, not by α > 0)
//   11:14 g_rgb     14:59 g_rgb·y per channel; 59:64 stay 0.
// The pixels of a tile share their front splats, so this is the contended
// part. The block walks the tile's 128-slot chunks and skips every chunk
// that holds no winner (a block-wide __syncthreads_or vote, which is also
// the barrier that frees the accumulator). For a chunk that does, the
// threads add their layers' 59 lanes into a (59, 128) shared-memory
// accumulator with shared float atomics, and the block then stores the
// chunk's (128, 64) rows with coalesced writes (float atomics into device
// memory when the tile takes several pixel groups, one_group false).
// Untouched chunks stay at the zeros the wrapper allocates. Every thread
// of the block must call this.
template <int K>
__device__ __forceinline__ void add_slot_grads(
    const float* __restrict__ packed, const int* __restrict__ cand_t,
    int n_chunks, float* __restrict__ out_t, bool one_group, const Pixel& px,
    const int (&sl)[K], const float (&ga)[K], const float (&gr)[K],
    const float (&gg)[K], const float (&gb)[K], float (*s_acc)[kChunk]) {
  for (int c = 0; c < n_chunks; ++c) {
    const int lo = c * kChunk;
    bool mine = false;
#pragma unroll
    for (int k = 0; k < K; ++k) mine |= sl[k] >= lo && sl[k] < lo + kChunk;
    if (!__syncthreads_or(mine)) continue;
    for (int e = threadIdx.x; e < kLanes * kChunk; e += blockDim.x)
      (&s_acc[0][0])[e] = 0.f;
    __syncthreads();
#pragma unroll
    for (int k = 0; k < K; ++k) {
      if (sl[k] < lo || sl[k] >= lo + kChunk) continue;
      const int i = sl[k] - lo;
      const float* row = packed + static_cast<size_t>(cand_t[sl[k]]) * kFeat;
      const Quad qd = quad(row, px);
      const float g_a = ga[k];
      const float ga_alpha = g_a * qd.alpha;
      const float d_a = ga_alpha * (-(qd.b * qd.b) / ((4.f * qd.a) * qd.a));
      const float d_b = ga_alpha * (qd.b / (2.f * qd.a));
#pragma unroll
      for (int j = 0; j < 6; ++j) atomicAdd(&s_acc[j][i], d_a * px.fd[j]);
#pragma unroll
      for (int j = 0; j < 3; ++j)
        atomicAdd(&s_acc[6 + j][i], 2.f * d_b * px.dir[j]);
      atomicAdd(&s_acc[9][i], -ga_alpha);
      atomicAdd(&s_acc[10][i], g_a * qd.rho);
      atomicAdd(&s_acc[11][i], gr[k]);
      atomicAdd(&s_acc[12][i], gg[k]);
      atomicAdd(&s_acc[13][i], gb[k]);
#pragma unroll
      for (int j = 0; j < 15; ++j) {
        atomicAdd(&s_acc[14 + j][i], gr[k] * px.y[j]);
        atomicAdd(&s_acc[29 + j][i], gg[k] * px.y[j]);
        atomicAdd(&s_acc[44 + j][i], gb[k] * px.y[j]);
      }
    }
    __syncthreads();
    float* dst = out_t + static_cast<size_t>(lo) * kFeat;
    for (int e = threadIdx.x; e < kChunk * kFeat; e += blockDim.x) {
      const int i = e / kFeat;
      const int lane = e - i * kFeat;
      if (lane >= kLanes) continue;
      const float val = s_acc[lane][i];
      if (one_group)
        dst[e] = val;
      else if (val != 0.f)
        atomicAdd(dst + e, val);
    }
  }
}

// Check the shapes, then call launch(std::integral_constant<int, K>()) for
// the smallest list capacity K ∈ {8, 16, 32, 64} that holds depth. Returns
// the cudaError_t of the launch (0 on success).
template <typename Launch>
int launch_for_depth(int device, int C, int P, int depth, Launch&& launch) {
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (C % kChunk != 0 || P < 1 || P > 1024 || depth < 1 || depth > kMaxDepth)
    return static_cast<int>(cudaErrorInvalidValue);
  if (depth <= 8)
    launch(std::integral_constant<int, 8>());
  else if (depth <= 16)
    launch(std::integral_constant<int, 16>());
  else if (depth <= 32)
    launch(std::integral_constant<int, 32>());
  else
    launch(std::integral_constant<int, 64>());
  return static_cast<int>(cudaGetLastError());
}

inline int threads_for(int P) { return P < kThreads ? P : kThreads; }

}  // namespace

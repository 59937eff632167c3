// Device code shared by the keys kernel (keys.cu), the fused-payload peel
// (peel_fwd.cu, peel_bwd.cu) and the top-K peel (peel_topk_fwd.cu,
// peel_topk_bwd.cu) on Hopper (sm_90a): the exact f32 screen in front of the
// float64 entry depth, the staging of a candidate chunk and its sweep into
// a pixel's top-K list (by splat id for the keys kernel, by candidate slot
// for the peels: sweep_topk), the f32 shading of one winner, the contraction of the winners'
// per-layer gradient scalars over a tile's pixels into one row a (tile,
// slot) pair (stage 1 of the backward; segment_rows.cu adds the pairs' rows
// into the (N+1, 64) feature table), and the launch dispatch over the list
// capacity K.
//
// Replaces the shared bodies of rtgs_tpu/ops/peel.py: _intersect_t1 and
// _merge_topk (the sweep) and _sweep2_feature_grads (the contraction).
//
// Geometry of every kernel here: one block per tile, one thread per pixel
// (blocks of at most kThreads; a tile with more pixels is swept once per
// group of kThreads).
//
// Bound, and what the design does about it. The sweep is bound by float64
// instruction throughput (21 operations a (pixel, candidate) pair at half the
// f32 rate, no FMA), and ~98% of the pairs miss: every sweep puts
// screen_rejects() in front of the chain, ~13 f32 instructions that reject
// a pair only when a proven error bound says the float64 Δ is negative, so
// the result stays bitwise the unscreened one. The screen runs for 32
// candidates at once (independent chains), then each lane runs its own
// survivors through the float64 chain; a chunk is staged candidate-major
// in f32 (three 16-byte loads a row, 6 KB a block), never as float64. The contraction is bound by
// the bytes of the rows it adds into; the TPU design (and the first port)
// scattered every winner's 59 lanes with float atomics into a dense
// (T, C, 64) block. Per slot the gradient row is a sum over pixels of seven
// scalars times per-pixel vectors, a reduction: contract_slot_grads()
// groups a tile's winners by slot with an integer counting sort in shared
// memory, sums each slot's row in registers (a warp a slot, its entries in
// ascending order), and stores one row a (tile, slot) pair into a
// compacted buffer; segment_rows.cu then sums each splat's pairs in pair
// order. No float atomic anywhere: the gradient is bitwise repeatable.
//
// Numerics. The entry depth runs in float64 from the f32 tables and is
// rounded to f32 once (B² and 4A·c0 cancel in Δ), with the operations and
// order of rtgs_tpu_torch.ops.peel.entry_depth; shading is f32 in the
// order of rtgs_tpu_torch.ops.peel._shade_layers; the gradient scalars
// follow rtgs_tpu_torch.ops.peel._slot_grads. Built with IEEE sqrt and
// division and --fmad=false, so the winners are bitwise the plain twins';
// the screen's FMAs are explicit (__fmaf_rn).

#pragma once

#include <climits>
#include <cuda_runtime.h>
#include <math_constants.h>

#include <type_traits>

#include "launch_common.cuh"

namespace {

constexpr int kChunk = 128;    // candidate slots per sweep step (CHUNK)
constexpr int kFeat = 64;      // packed feature row width
constexpr int kLanes = 59;     // lanes with a gradient (59:64 are padding)
constexpr int kPixFeat = 24;   // pixel feature row width
constexpr int kStage = 10;     // staged lanes: m6 (0:6), Me (6:9), c0 (9)
constexpr int kThreads = 256;  // pixels per group
constexpr int kMaxDepth = 64;  // largest list capacity instantiated
constexpr int kGradScalars = 7;  // gradient scalars a winning layer

__device__ __forceinline__ bool lex_less(float ta, int sa, float tb, int sb) {
  return ta < tb || (ta == tb && sa < sb);
}

// ---------------------------------------------------------------------------
// The screen: an f32 evaluation of Δ/4 = b² − A·c0 (b = d·Me, A = fd·m6)
// that may reject a (pixel, candidate) pair before the float64 chain runs.
//
// It must never reject a pair the float64 chain accepts (Δ64 ≥ 0). With
// u = 2⁻²⁴, γₙ = nu/(1 − nu), Ā = Σ|fdⱼ·mⱼ| and b̄ = Σ|dⱼ·Meⱼ| (sums of
// absolute products), an f32 dot product of n terms, fused or not, in any
// order, is off by at most γₙ times the sum of absolute products, so
//   |Â − A| ≤ γ₆·Ā,  |b̂ − b| ≤ γ₃·b̄,  |b̂² − b²| ≤ (2γ₃ + γ₃²)·b̄²,
//   t̂ = fl(Â·c0):  |t̂ − A·c0| ≤ (γ₆ + u(1 + γ₆))·Ā|c0|,
//   q̂ = fl(b̂·b̂ − t̂), one rounding fused and two unfused:
//   |q̂ − (b̂² − t̂)| ≤ u(2 + u)(1 + γ₃)²·b̄² + u(1 + γ₆)(1 + u)·Ā|c0|.
// To first order that is 8u·(b̄² + Ā|c0|) for either evaluation (6u + 2u
// and 6u + u + u). The margin is 12u·(b̄² + Ā|c0|): the remaining 4u covers
// the second-order terms (~50u²), the margin's own f32 rounding (a sum of
// non-negative terms, relative error below γ₁₄) and the float64 chain's
// error against the exact Δ/4 (below 8·2⁻⁵³·(b̄² + Ā|c0|)). Gradual
// underflow adds at most 2⁻¹⁵⁰ a product: 6 in Â (then times |c0|), 3 in b̂
// (then times 2b̄), t̂ and the last, below 2⁻¹⁴⁷·(|c0| + b̄ + 1); the margin
// adds 2⁻¹⁴⁶ of that. Overflow: when b̄² + Ā|c0| is not below 2¹²⁰ (or is
// NaN) the margin is +inf and nothing is rejected; below it no intermediate
// overflows. Ā and b̄ are taken from the tile's largest |fdⱼ| and |dⱼ|
// (one block reduction), which only widens the margin, so the margin is a
// candidate's own and is computed once at staging. The predicate is
// q̂ < −margin: a NaN on either side compares false and the pair goes on to
// float64. The plain version is rtgs_tpu_torch.ops.peel.screen_margin /
// screen_rejects.
constexpr float kScreenRel = 12.f * 5.9604644775390625e-8f;  // 12·2⁻²⁴
constexpr float kScreenTiny = 1.1210387714598537e-44f;       // 2⁻¹⁴⁶
constexpr float kScreenMax = 1.329227995784916e36f;          // 2¹²⁰

// One staged candidate of a sweep: lanes 0-9 of its row (m6, Me, c0), the
// screen's margin and its id (negative: a padding slot); read as three
// 16-byte loads.
struct alignas(16) ScreenRow {
  float m[kStage];
  float margin;
  int id;
};

// The margin of one row against a tile whose largest |pix lanes 0:9| are
// mx (direction 0:3, quadratic features 3:9).
__device__ __forceinline__ float screen_margin(const float (&m)[kStage],
                                               const float (&mx)[9]) {
  float abar = mx[3] * fabsf(m[0]);
#pragma unroll
  for (int j = 1; j < 6; ++j) abar = __fmaf_rn(mx[3 + j], fabsf(m[j]), abar);
  float bbar = mx[0] * fabsf(m[6]);
#pragma unroll
  for (int j = 1; j < 3; ++j) bbar = __fmaf_rn(mx[j], fabsf(m[6 + j]), bbar);
  const float c0 = fabsf(m[9]);
  const float s = __fmaf_rn(bbar, bbar, abar * c0);
  const float margin =
      __fmaf_rn(kScreenRel, s, kScreenTiny * ((c0 + bbar) + 1.f));
  return s < kScreenMax ? margin : CUDART_INF_F;
}

// Whether the f32 Δ/4 of the pixel (d, fd) against the staged row (r0, r1,
// r2: its three 16-byte words) is below −margin.
__device__ __forceinline__ bool screen_rejects(const float (&d)[3],
                                               const float (&fd)[6],
                                               const float4& r0,
                                               const float4& r1,
                                               const float4& r2) {
  float a = fd[0] * r0.x;
  a = __fmaf_rn(fd[1], r0.y, a);
  a = __fmaf_rn(fd[2], r0.z, a);
  a = __fmaf_rn(fd[3], r0.w, a);
  a = __fmaf_rn(fd[4], r1.x, a);
  a = __fmaf_rn(fd[5], r1.y, a);
  float b = d[0] * r1.z;
  b = __fmaf_rn(d[1], r1.w, b);
  b = __fmaf_rn(d[2], r2.x, b);
  const float q = __fmaf_rn(b, b, -(a * r2.y));
  return q < -r2.z;
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

// Shared memory of a sweep: one chunk's candidates, candidate-major (6 KB),
// and the pixel group's largest |pix lanes 0:9| as bit patterns.
struct SweepStage {
  ScreenRow row[kChunk];
  unsigned max_bits[9];
};

// What the sweep keeps of one pixel: its direction and d-quadratic
// features (pix lanes 0:3 and 3:9), in f32 for the screen and in float64
// for the deciding chain.
struct SweepPixel {
  float d[3], fd[6];
  double d64[3], fd64[6];
};

__device__ __forceinline__ SweepPixel load_sweep_pixel(const float* q) {
  SweepPixel px;
#pragma unroll
  for (int j = 0; j < 3; ++j) px.d64[j] = px.d[j] = q[j];
#pragma unroll
  for (int j = 0; j < 6; ++j) px.fd64[j] = px.fd[j] = q[3 + j];
  return px;
}

// The pixel group's largest |d| and |fd| into st.max_bits, as bit patterns:
// they order like the values, and a NaN orders above +inf and so survives.
// Every thread of the block calls this with the pix row of a pixel of the
// group (an inactive thread with any of them); a __syncthreads() must
// follow before stage_chunk() reads the result.
__device__ __forceinline__ void stage_pixel_max(SweepStage& st,
                                                const float* q) {
  __syncthreads();  // the last group's staging is done with max_bits
  if (threadIdx.x < 9) st.max_bits[threadIdx.x] = 0u;
  __syncthreads();
  const unsigned mask = __activemask();
#pragma unroll
  for (int j = 0; j < 9; ++j) {
    const unsigned m = __reduce_max_sync(mask, __float_as_uint(fabsf(q[j])));
    if ((threadIdx.x & 31) == 0) atomicMax(&st.max_bits[j], m);
  }
}

// Stage chunk c of the tile's candidates, one thread a candidate: lanes
// 0-11 of packed[cand_t[c·128 + i]] as three 16-byte loads (no (T, C, 64)
// gather exists), the screen's margin against this pixel group, and the id.
// A padding slot (id < 0) is staged so that the screen rejects it: Δ/4 = 0
// is below its margin of −1 (and its id stops it should a NaN pixel carry
// it past).
__device__ __forceinline__ void stage_chunk(SweepStage& st,
                                            const float* __restrict__ packed,
                                            const int* __restrict__ cand_t,
                                            int c) {
  for (int i = threadIdx.x; i < kChunk; i += blockDim.x) {
    const int id = cand_t[c * kChunk + i];
    ScreenRow row;
    if (id >= 0) {
      const float4* src = reinterpret_cast<const float4*>(
          packed + static_cast<size_t>(id) * kFeat);
      const float4 r0 = __ldg(src), r1 = __ldg(src + 1), r2 = __ldg(src + 2);
      const float m[kStage] = {r0.x, r0.y, r0.z, r0.w, r1.x,
                               r1.y, r1.z, r1.w, r2.x, r2.y};
      float mx[9];
#pragma unroll
      for (int j = 0; j < 9; ++j) mx[j] = __uint_as_float(st.max_bits[j]);
#pragma unroll
      for (int j = 0; j < kStage; ++j) row.m[j] = m[j];
      row.margin = screen_margin(m, mx);
    } else {
#pragma unroll
      for (int j = 0; j < kStage; ++j) row.m[j] = 0.f;
      row.margin = -1.f;
    }
    row.id = id;
    st.row[i] = row;
  }
}

constexpr int kBatch = 32;  // candidates screened before their survivors run

// One staged chunk against one pixel. The screen runs for kBatch
// candidates at once (independent f32 chains); then the pixel's survivors
// of the batch run, in increasing slot order, through the float64 chain
// (operations and order of rtgs_tpu_torch.ops.peel.entry_depth), and a hit
// that beats the K-th pair is inserted with one unrolled compare-exchange
// pass: a warp takes as many float64 turns as its busiest lane has
// survivors, not one a candidate that any lane kept. The list is ordered by
// (t1, key), the key being the candidate's id (kById) or its slot
// slot_base + i; candidates arrive in increasing slot order, so among equal
// (t1, key) the earlier one stays in front. kCount: also count the live
// pairs and those the screen rejected.
template <int K, bool kById, bool kCount>
__device__ __forceinline__ void sweep_chunk(const SweepStage& st,
                                            int slot_base,
                                            const SweepPixel& px,
                                            float (&kt)[K], int (&ks)[K],
                                            unsigned long long& n_pairs,
                                            unsigned long long& n_rejected) {
  for (int i0 = 0; i0 < kChunk; i0 += kBatch) {
    unsigned pending = 0;
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const float4* rp = reinterpret_cast<const float4*>(&st.row[i0 + j]);
      const bool rejected = screen_rejects(px.d, px.fd, rp[0], rp[1], rp[2]);
      pending |= static_cast<unsigned>(!rejected) << j;
      if (kCount) {
        const int live = st.row[i0 + j].id >= 0;
        n_pairs += live;
        n_rejected += live && rejected;
      }
    }
    while (pending) {
      const int i = i0 + __ffs(pending) - 1;
      pending &= pending - 1;
      const ScreenRow& row = st.row[i];
      if (row.id < 0) continue;  // padding: never a hit
      double a = px.fd64[0] * static_cast<double>(row.m[0]);
      a = a + px.fd64[1] * static_cast<double>(row.m[1]);
      a = a + px.fd64[2] * static_cast<double>(row.m[2]);
      a = a + px.fd64[3] * static_cast<double>(row.m[3]);
      a = a + px.fd64[4] * static_cast<double>(row.m[4]);
      a = a + px.fd64[5] * static_cast<double>(row.m[5]);
      double b = px.d64[0] * static_cast<double>(row.m[6]);
      b = b + px.d64[1] * static_cast<double>(row.m[7]);
      b = b + px.d64[2] * static_cast<double>(row.m[8]);
      b = 2.0 * b;
      const double delta = b * b - (4.0 * a) * static_cast<double>(row.m[9]);
      if (!(delta >= 0.0)) continue;  // miss (or NaN)
      const double sq = sqrt(delta > 0.0 ? delta : 0.0);
      const double t1d = (-b - sq) / (2.0 * a);
      if (!(t1d > 0.0)) continue;
      const float t1 = static_cast<float>(t1d);
      const int key = kById ? row.id : slot_base + i;
      if (!lex_less(t1, key, kt[K - 1], ks[K - 1])) continue;
      // Insert: one compare-exchange pass carries the larger pair down.
      float ct = t1;
      int cs = key;
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

// Vacant entries are (+inf, INT_MAX): every hit orders before them.
template <int K>
__device__ __forceinline__ void clear_list(float (&kt)[K], int (&ks)[K]) {
#pragma unroll
  for (int k = 0; k < K; ++k) {
    kt[k] = CUDART_INF_F;
    ks[k] = INT_MAX;
  }
}

// The K nearest hits of the pixel whose pix row is q, among the tile's
// slots [0, n_chunks·128), as a (t1, slot) list sorted lexicographically;
// vacant entries stay (+inf, INT_MAX). The block stages each chunk once
// (stage_chunk) and every pixel sweeps it (sweep_chunk): the f32 screen in
// front of the float64 chain, so the list is bitwise the unscreened one. A
// hit whose t1 equals a listed one sorts after it: the TPU merge's
// lower-lane tie-break. Every thread of the block must call this (it
// synchronises); an inactive one passes the pix row of any pixel of the
// tile and only helps to stage. n_pairs, n_rejected: counters of sweep_chunk
// (kCount).
template <int K, bool kCount = false>
__device__ __forceinline__ void sweep_topk(const float* __restrict__ packed,
                                           const int* __restrict__ cand_t,
                                           int n_chunks, bool active,
                                           const float* q, SweepStage& st,
                                           float (&kt)[K], int (&ks)[K],
                                           unsigned long long& n_pairs,
                                           unsigned long long& n_rejected) {
  const SweepPixel px = load_sweep_pixel(q);
  clear_list(kt, ks);
  stage_pixel_max(st, q);
  for (int c = 0; c < n_chunks; ++c) {
    // The previous chunk's readers are done (and, in the first chunk,
    // max_bits is complete).
    __syncthreads();
    stage_chunk(st, packed, cand_t, c);
    __syncthreads();
    if (active)
      sweep_chunk<K, false, kCount>(st, c * kChunk, px, kt, ks, n_pairs,
                                    n_rejected);
  }
}

template <int K>
__device__ __forceinline__ void sweep_topk(const float* __restrict__ packed,
                                           const int* __restrict__ cand_t,
                                           int n_chunks, bool active,
                                           const float* q, SweepStage& st,
                                           float (&kt)[K], int (&ks)[K]) {
  unsigned long long n_pairs = 0, n_rejected = 0;
  sweep_topk<K, false>(packed, cand_t, n_chunks, active, q, st, kt, ks,
                       n_pairs, n_rejected);
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

// ---------------------------------------------------------------------------
// Shading from staged rows. A pixel shades its K winners from their 59-lane
// rows, and the 32 pixels of a warp hold up to 32 different winners: 32 rows
// a load instruction when the rows are read where they lie. A tile's pixels
// share its few hundred candidates, so where the tile's swept slots fit
// (kShadeRows of them: 99 KB, two blocks an SM), the block first copies
// every live slot's row into shared memory, slot s at s·kRowStride (16-byte
// loads; an odd stride, so the rows of a warp fall on different banks),
// and the pixels shade from there; a longer tile shades from device memory
// as before. The values and the arithmetic are the same either way.
constexpr int kShadeRows = 416;
constexpr int kRowStride = 61;
constexpr int kShadeBytes = kShadeRows * kRowStride * sizeof(float);

// Copy the rows of the tile's slots [0, n_slots) into s_rows if they fit;
// returns whether they did (the same for every thread of the block, which
// must all call this; it ends with a barrier when it staged).
__device__ __forceinline__ bool stage_tile_rows(
    float* s_rows, const float* __restrict__ packed,
    const int* __restrict__ cand_t, int n_slots) {
  if (n_slots > kShadeRows) return false;
  constexpr int kWords = (kLanes + 3) / 4;  // 16-byte words a row
  for (int e = threadIdx.x; e < n_slots * kWords; e += blockDim.x) {
    const int slot = e / kWords, w = e - slot * kWords;
    const int id = cand_t[slot];
    if (id < 0) continue;  // a gap: never a winner
    const float4 v = __ldg(reinterpret_cast<const float4*>(
                               packed + static_cast<size_t>(id) * kFeat) + w);
    float* dst = s_rows + slot * kRowStride + 4 * w;
    dst[0] = v.x;
    dst[1] = v.y;
    dst[2] = v.z;
    dst[3] = v.w;
  }
  __syncthreads();
  return true;
}

// The row of the winner in `slot`: staged, or where it lies in the table.
__device__ __forceinline__ const float* winner_row(
    bool staged, const float* s_rows, const float* __restrict__ packed,
    const int* __restrict__ cand_t, int slot) {
  return staged ? s_rows + slot * kRowStride
                : packed + static_cast<size_t>(cand_t[slot]) * kFeat;
}

// ---------------------------------------------------------------------------
// The contraction of the winners' gradients over a tile's pixels.
//
// Through α = op·exp(B²/4A − (c0+3)) and rgb = color + y·SH, a winner with
// cotangents ga = ∂L/∂α and (gr, gg, gb) = ∂L/∂rgb gives its row, per lane,
//   0:6  dA·fd      dA  = ga·α·(−B²/4A²)
//   6:9  2·dB·d     dB  = ga·α·B/2A
//   9    −ga·α      10  ga·ρ (masked by acceptance, not by α > 0)
//   11:14 g_rgb     14:59 g_rgb·y per channel; 59:64 stay 0:
// seven scalars (dA, 2dB, −ga·α, ga·ρ, gr, gg, gb) times lanes of the
// pixel's own row (fd, d, 1, y). A slot's row is the sum of that over the
// pixels it won: a reduction, in two deterministic stages, as the JAX
// backward's per-(tile, candidate) block and its segment_sum. The kernels
// put the seven scalars of every winning layer into shared memory
// (GradStage::put), kPassLayers layers a pass, and contract_slot_grads()
// then
//   B. groups the entries by slot with a stable counting sort: an integer
//      histogram over the tile's slots (kRange slots a round, integer
//      atomics: the counts are exact), a block prefix sum that also
//      compacts the winning slots, and a fill that leaves each slot's
//      entries in ascending entry index, layer-major within the pass, then
//      pixel (layer by layer and warp by warp between barriers, the lanes
//      of a warp ranked by __match_any_sync: an atomic fill would leave
//      them in the order the threads happened to run);
//   C. gives every winning slot to a warp, whose 32 lanes own row lanes ℓ
//      and ℓ + 32, sum scalar(ℓ)·pixel(ℓ) in registers over the slot's
//      entries in that order and store the finished row into the pair's
//      row of the compacted buffer dslot_t[slot] (the tile's rows start at
//      pair_base[t] = Σ counts of the tiles before it). A later pass, or
//      pixel group, reads the row back and goes on adding: the block owns
//      it, so that is a plain read-add-store, and the row is the sum over
//      (pixel group, layer, pixel) in that order, the order of
//      rtgs_tpu_torch.ops.peel._slot_grads.
// The block zero-fills its rows first (init_pair_rows, which also writes
// each row's splat id for stage 2), so a slot that never wins, a −1 gap
// and lanes 59:64 hold exact zeros. No float atomic, no (T, C, 64) block:
// Σ counts rows of 64 lanes.
constexpr int kPassLayers = 8;   // layers a contraction pass
constexpr int kRange = 2048;     // slots a histogram round
constexpr int kEntries = kPassLayers * kThreads;
constexpr int kLaneStride = kEntries + 1;  // scalar planes on distinct banks
static_assert(kEntries < 65536, "entry indices are 16 bits");

// Dynamic shared memory of the contraction.
struct GradStage {
  float sc[kGradScalars * kLaneStride];  // scalar si of entry e: si·stride + e
  int offs[kRange];                      // histogram, then fill cursors
  unsigned short order[kEntries];        // entries grouped by slot
  unsigned short wslot[kRange];          // the round's winning slots, ascending
  unsigned warp_tot[32];
  unsigned total;

  // Entry of layer k (within the pass) of this thread's pixel.
  __device__ __forceinline__ static int entry(int k) {
    return k * kThreads + threadIdx.x;
  }
  __device__ __forceinline__ void put(int k, float d_a, float d_b2,
                                      float neg_ga_alpha, float d_op, float gr,
                                      float gg, float gb) {
    float* s = sc + entry(k);
    s[0] = d_a;
    s[kLaneStride] = d_b2;
    s[2 * kLaneStride] = neg_ga_alpha;
    s[3 * kLaneStride] = d_op;
    s[4 * kLaneStride] = gr;
    s[5 * kLaneStride] = gg;
    s[6 * kLaneStride] = gb;
  }
};

// Which scalar and which pixel lane make row lane l (pixel lane −1: the
// factor is 1).
__device__ __forceinline__ void row_lane_factors(int l, int& si, int& fi) {
  if (l < 6) { si = 0; fi = 3 + l; }
  else if (l < 9) { si = 1; fi = l - 6; }
  else if (l < 14) { si = l - 7; fi = -1; }
  else if (l < 29) { si = 4; fi = l - 5; }
  else if (l < 44) { si = 5; fi = l - 20; }
  else { si = 6; fi = l - 35; }
}

// Before a tile's first pass: zero its n_slots pair rows (16-byte stores)
// and write each row's splat id (cand_t[slot], −1 for a gap) into
// pair_ids_t. Every thread of the block calls this; the barrier each pass
// starts with orders these stores before the contraction's.
__device__ __forceinline__ void init_pair_rows(
    float* __restrict__ dslot_t, int* __restrict__ pair_ids_t,
    const int* __restrict__ cand_t, int n_slots) {
  float4* rows = reinterpret_cast<float4*>(dslot_t);
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int i = threadIdx.x; i < n_slots * (kFeat / 4); i += blockDim.x)
    rows[i] = zero;
  for (int i = threadIdx.x; i < n_slots; i += blockDim.x)
    pair_ids_t[i] = cand_t[i];
}

// Phases B and C for one pass: sl[k] (k in [k0, k0 + kPassLayers)) are the
// slots of this thread's layers whose scalars st holds (−1: none), n_slots
// the tile's swept slots, pix_g the pix row of the group's first pixel,
// dslot_t the tile's pair rows; fresh: no earlier pass has written them
// (they still hold the zero fill, so they need not be read). Every thread
// of the block must call this; blockDim.x is a multiple of 32 and at most
// kThreads.
template <int K>
__device__ __forceinline__ void contract_slot_grads(
    GradStage& st, const int (&sl)[K], int k0, int n_slots,
    const float* __restrict__ pix_g, float* __restrict__ dslot_t,
    bool fresh) {
  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, n_warps = nt >> 5;
  int si0, fi0, si1, fi1;
  row_lane_factors(lane, si0, fi0);
  row_lane_factors(lane + 32 < kLanes ? lane + 32 : 0, si1, fi1);

  for (int r0 = 0; r0 < n_slots; r0 += kRange) {
    const int n = min(kRange, n_slots - r0);
    __syncthreads();  // the scalars are written; the last round is read
    for (int s = tid; s < n; s += nt) st.offs[s] = 0;
    __syncthreads();
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int s = sl[k] - r0;
      if (k >= k0 && k < k0 + kPassLayers && s >= 0 && s < n)
        atomicAdd(&st.offs[s], 1);
    }
    __syncthreads();

    // Exclusive prefix sum of the counts, entries in the high half of a
    // word and winning slots in the low half; a thread owns `per`
    // consecutive slots.
    const int per = (n + nt - 1) / nt;
    const int lo = min(tid * per, n), hi = min(lo + per, n);
    unsigned mine = 0;
    for (int s = lo; s < hi; ++s) {
      const unsigned c = st.offs[s];
      mine += (c << 16) | (c > 0);
    }
    unsigned incl = mine;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const unsigned up = __shfl_up_sync(0xffffffffu, incl, d);
      if (lane >= d) incl += up;
    }
    if (lane == 31) st.warp_tot[warp] = incl;
    __syncthreads();
    unsigned base = incl - mine;
    for (int w = 0; w < warp; ++w) base += st.warp_tot[w];
    if (tid == nt - 1) st.total = base + mine;
    for (int s = lo; s < hi; ++s) {
      const unsigned c = st.offs[s];
      if (c > 0) st.wslot[base & 0xffffu] = static_cast<unsigned short>(s);
      st.offs[s] = base >> 16;
      base += (c << 16) | (c > 0);
    }
    __syncthreads();
    const int n_won = st.total & 0xffffu;
    if (n_won == 0) continue;

    // The fill, stable: a slot's entries in ascending index, that is layer
    // by layer, and within a layer warp by warp (a barrier after each), a
    // lane placed after the same-slot lanes below it in its warp. The
    // integer order is all that the barriers buy: the counts were exact.
    const unsigned below = (1u << lane) - 1;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      if (k < k0 || k >= k0 + kPassLayers) continue;  // the same in all
      const int s0 = sl[k] - r0;
      const int s = s0 >= 0 && s0 < n ? s0 : -1;
      const unsigned peers = __match_any_sync(0xffffffffu, s);
      for (int w = 0; w < n_warps; ++w) {
        if (warp == w) {
          const int at = s >= 0 ? st.offs[s] : 0;
          __syncwarp();
          if (s >= 0) {
            st.order[at + __popc(peers & below)] =
                static_cast<unsigned short>(GradStage::entry(k - k0));
            if ((peers & below) == 0) st.offs[s] = at + __popc(peers);
          }
        }
        __syncthreads();
      }
    }
    // offs[s] is now the end of slot s's entries.

    const bool upper = lane + 32 < kLanes;  // row lane ℓ + 32 exists
    for (int j = warp; j < n_won; j += n_warps) {
      const int s = st.wslot[j];
      const int begin = j > 0 ? st.offs[st.wslot[j - 1]] : 0;
      const int end = st.offs[s];
      float* row = dslot_t + static_cast<size_t>(r0 + s) * kFeat;
      float acc0 = 0.f, acc1 = 0.f;  // the zero fill, unread in the first
      if (!fresh) {                  // pass; after it, the row so far
        acc0 = row[lane];
        if (upper) acc1 = row[lane + 32];
      }
      for (int i = begin; i < end; ++i) {
        const int e = st.order[i];
        const float* q = pix_g + (e & (kThreads - 1)) * kPixFeat;
        const float f0 = fi0 >= 0 ? __ldg(q + fi0) : 1.f;
        const float f1 = fi1 >= 0 ? __ldg(q + fi1) : 1.f;
        acc0 = acc0 + st.sc[si0 * kLaneStride + e] * f0;
        acc1 = acc1 + st.sc[si1 * kLaneStride + e] * f1;
      }
      row[lane] = acc0;
      if (upper) row[lane + 32] = acc1;
    }
  }
}

// Check the shapes, then call launch(std::integral_constant<int, K>()) for
// the smallest list capacity K ∈ {8, 16, 32, 64} that holds depth. Returns
// the cudaError_t of the launch (0 on success).
template <typename Launch>
int launch_for_depth(int device, int C, int P, int depth, Launch&& launch) {
  const cudaError_t err = use_device(device);
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

// The contraction shuffles across whole warps.
inline int warp_threads_for(int P) { return (threads_for(P) + 31) / 32 * 32; }

// Let a backward kernel take the contraction's stage as dynamic shared
// memory (it is above the 48 KB a kernel gets unasked). False on failure,
// with the error left for cudaGetLastError.
template <auto kKernel>
bool grad_stage_opt_in(int device) {
  return dynamic_smem_opt_in<kKernel>(
             device, static_cast<int>(sizeof(GradStage))) == cudaSuccess;
}

}  // namespace

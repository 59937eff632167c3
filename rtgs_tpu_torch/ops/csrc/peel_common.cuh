// Device code shared by the keys kernel (keys.cu), the fused-payload peel
// (peel_fwd.cu, peel_bwd.cu) and the top-K peel (peel_topk_fwd.cu,
// peel_topk_bwd.cu) on Hopper (sm_90a): the exact f32 screen in front of the
// float64 entry depth, the per-pixel top-K sweep over a tile's candidate
// slots, the f32 shading of one winner, the contraction of the winners'
// per-layer gradient scalars over a tile's pixels into the (N+1, 64)
// feature table, and the launch dispatch over the list capacity K.
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
// f32 rate, no FMA), and ~98% of the pairs miss: the keys kernel puts
// screen_rejects() in front of the chain, ~13 f32 instructions that reject
// a pair only when a proven error bound says the float64 Δ is negative, so
// the result stays bitwise the unscreened one. The contraction is bound by
// the bytes of the rows it adds into; the TPU design (and the first port)
// scattered every winner's 59 lanes with float atomics into a dense
// (T, C, 64) block. Per slot the gradient row is a sum over pixels of seven
// scalars times per-pixel vectors, a reduction: contract_slot_grads()
// groups a tile's winners by slot with an integer counting sort in shared
// memory, sums each slot's row in registers (a warp a slot), and adds one
// row a (tile, winning slot) straight into the table.
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

// One staged candidate of the keys sweep: lanes 0-9 of its row (m6, Me,
// c0), the screen's margin and its id; read as three 16-byte loads.
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
// pixels it won: a reduction. The kernels put the seven scalars of every
// winning layer into shared memory (GradStage::put), kPassLayers layers a
// pass, and contract_slot_grads() then
//   B. groups the entries by slot with a counting sort: an integer
//      histogram over the tile's slots (kRange slots a round), a block
//      prefix sum that also compacts the winning slots, and a fill, all
//      with integer atomics;
//   C. gives every winning slot to a warp, whose 32 lanes own row lanes ℓ
//      and ℓ + 32, walk the slot's entries and sum scalar(ℓ)·pixel(ℓ) in
//      registers; and adds the finished row into the table row
//      dpacked[cand[t, slot]] with red.global.add.f32.
// No float atomic in shared memory, no (T, C, 64) block, no zero-fill by
// the kernel; a vacant layer writes nothing, so the sentinel row stays 0.
// The sums run in the fill's order and rows of different tiles meet in
// device-memory atomics: results agree run to run to f32 rounding only.
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

// Phases B and C for one pass: sl[k] (k in [k0, k0 + kPassLayers)) are the
// slots of this thread's layers whose scalars st holds (−1: none), n_slots
// the tile's swept slots, pix_g the pix row of the group's first pixel.
// Every thread of the block must call this; blockDim.x is a multiple of 32
// and at most kThreads.
template <int K>
__device__ __forceinline__ void contract_slot_grads(
    GradStage& st, const int (&sl)[K], int k0, const int* __restrict__ cand_t,
    int n_slots, const float* __restrict__ pix_g, float* __restrict__ dpacked) {
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

#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int s = sl[k] - r0;
      if (k >= k0 && k < k0 + kPassLayers && s >= 0 && s < n)
        st.order[atomicAdd(&st.offs[s], 1)] =
            static_cast<unsigned short>(GradStage::entry(k - k0));
    }
    __syncthreads();  // offs[s] is now the end of slot s's entries

    for (int j = warp; j < n_won; j += n_warps) {
      const int s = st.wslot[j];
      const int begin = j > 0 ? st.offs[st.wslot[j - 1]] : 0;
      const int end = st.offs[s];
      float acc0 = 0.f, acc1 = 0.f;
      for (int i = begin; i < end; ++i) {
        const int e = st.order[i];
        const float* q = pix_g + (e & (kThreads - 1)) * kPixFeat;
        const float f0 = fi0 >= 0 ? __ldg(q + fi0) : 1.f;
        const float f1 = fi1 >= 0 ? __ldg(q + fi1) : 1.f;
        acc0 = acc0 + st.sc[si0 * kLaneStride + e] * f0;
        acc1 = acc1 + st.sc[si1 * kLaneStride + e] * f1;
      }
      float* row = dpacked + static_cast<size_t>(cand_t[r0 + s]) * kFeat;
      atomicAdd(row + lane, acc0);
      if (lane + 32 < kLanes) atomicAdd(row + lane + 32, acc1);
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

// The contraction shuffles across whole warps.
inline int warp_threads_for(int P) { return (threads_for(P) + 31) / 32 * 32; }

// Let a backward kernel take the contraction's stage as dynamic shared
// memory (it is above the 48 KB a kernel gets unasked). False on failure,
// with the error left for cudaGetLastError.
template <typename Kernel>
bool grad_stage_opt_in(Kernel* kernel) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(sizeof(GradStage))) ==
         cudaSuccess;
}

}  // namespace

// Fused-payload tile peel, backward, on Hopper (sm_90a).
//
// Replaces rtgs_tpu/ops/peel.py:_bwd_kernel (with _layer_cotangents and
// _sweep2_feature_grads): the per-candidate-slot feature gradients
// (T, C, 64) of Σ ḡ·radiance + Σ ḡ_T·transmittance for the forward's
// winners. Per pixel, with layers k in depth order, αₖ, rgbₖ and
// Tₖ = Π_{j<k} (1 − αⱼ):
//   ∂L/∂αₖ = Σ_ch ḡ_ch·Tₖ·(c_ch,k − U_ch) − ḡ_T·Tₖ·Vₖ, ∂L/∂rgbₖ = ḡ·Tₖ·αₖ,
// from the division-free suffix recurrences U = α·c + (1−α)·U and
// V = (1−α)·V (no division by 1 − α, so α → 1 stays finite); then through
// α = op·exp(B²/4A − (c0+3)) and rgb = color + y·SH, per row lane:
//   0:6  dA·fd      dA  = gA·α·(−B²/4A²)
//   6:9  2·dB·d     dB  = gA·α·B/2A
//   9    −gA·α      10  gA·ρ (masked by acceptance, not by α > 0)
//   11:14 g_rgb     14:59 g_rgb·y per channel; 59:64 stay 0.
// The caller scatter-adds the (T, C, 64) rows into (N+1, 64).
//
// Design. One block per tile, one thread per pixel (blocks of at most 256
// threads; larger tiles go in groups of 256). The TPU kernel re-runs the
// selection sweep; here the forward kernel hands over the winners' slots
// (T, K, P), so a thread reads its K slots, shades its K rows in f32 (the
// forward's arithmetic), and runs the prefix and suffix recurrences in
// registers. The pixel contraction is the contended part: the pixels of a
// tile share their front splats. As in _sweep2_feature_grads, the block
// walks the tile's 128-slot chunks and skips every chunk that holds no
// winner (a block-wide __syncthreads_or vote). For a chunk that does, the
// threads add their layers' 59 lanes into a (59, 128) shared-memory
// accumulator with shared float atomics, and the block then stores the
// chunk's (128, 64) rows with coalesced writes (float atomics into device
// memory when one tile takes several pixel groups). Untouched chunks stay
// at the zeros the wrapper allocates.
//
// Bound. Per (pixel, layer): one 59-lane row read (shared by the tile's
// pixels through L1), ~150 f32 flops and 59 shared atomics, of which the
// atomics on a tile's front splats serialise within a warp; writes are
// 256 B per touched slot. The (T, C, 64) output, mostly zeros, is the
// largest memory traffic (the wrapper's memset and the caller's
// scatter-add), as in the TPU design.
//
// Numerics. f32 throughout, in the order of
// rtgs_tpu_torch.ops.peel.peel_fused_bwd_torch; the atomics sum in no
// fixed order, so the result varies run to run in its low bits.

#include <cuda_runtime.h>

namespace {

constexpr int kChunk = 128;    // candidate slots per chunk (CHUNK)
constexpr int kFeat = 64;      // packed feature row width
constexpr int kLanes = 59;     // lanes with a gradient (59:64 are padding)
constexpr int kPixFeat = 24;   // pixel feature row width
constexpr int kThreads = 256;  // pixels per group

struct Quad {
  float a, b, rho, alpha;
};

// The forward kernel's f32 response of one row to one pixel.
__device__ __forceinline__ Quad quad(const float* row, const float* fd,
                                     const float* dir) {
  float a = fd[0] * row[0];
#pragma unroll
  for (int j = 1; j < 6; ++j) a = a + fd[j] * row[j];
  float b = dir[0] * row[6];
  b = b + dir[1] * row[7];
  b = b + dir[2] * row[8];
  b = 2.f * b;
  const float cq = row[9];
  const float delta = b * b - (4.f * a) * cq;
  const float rho = delta > 0.f ? expf(b * b / (4.f * a) - (cq + 3.f)) : 0.f;
  return {a, b, rho, row[10] * rho};
}

template <int K>
__global__ void __launch_bounds__(kThreads)
    peel_bwd_kernel(const float* __restrict__ packed,
                    const int* __restrict__ cand,
                    const int* __restrict__ counts,
                    const float* __restrict__ pix,
                    const int* __restrict__ slots,
                    const float* __restrict__ grad_rad,
                    const float* __restrict__ grad_trans,
                    float* __restrict__ out, int C, int P, int depth) {
  __shared__ float s_acc[kLanes][kChunk];

  const int t = blockIdx.x;
  const int* cand_t = cand + static_cast<size_t>(t) * C;
  const int n_chunks = (counts[t] + kChunk - 1) / kChunk;
  const bool one_group = P <= static_cast<int>(blockDim.x);

  for (int p0 = 0; p0 < P; p0 += blockDim.x) {
    const int p = p0 + threadIdx.x;
    const bool active = p < P;
    const int pp = active ? p : 0;
    const float* q = pix + (static_cast<size_t>(t) * P + pp) * kPixFeat;
    float dir[3], fd[6], y[15];
#pragma unroll
    for (int j = 0; j < 3; ++j) dir[j] = q[j];
#pragma unroll
    for (int j = 0; j < 6; ++j) fd[j] = q[3 + j];
#pragma unroll
    for (int j = 0; j < 15; ++j) y[j] = q[9 + j];
    const float gr = grad_rad[(static_cast<size_t>(t) * 3 + 0) * P + pp];
    const float gg = grad_rad[(static_cast<size_t>(t) * 3 + 1) * P + pp];
    const float gb = grad_rad[(static_cast<size_t>(t) * 3 + 2) * P + pp];
    const float gt = grad_trans[static_cast<size_t>(t) * P + pp];

    // Layers: slot, α, rgb and the prefix transmittance Tₖ (held in gk).
    int sl[K];
    float al[K], cr[K], cg[K], cb[K], gk[K];
    float tr = 1.f;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      sl[k] = -1;
      al[k] = cr[k] = cg[k] = cb[k] = 0.f;
      if (active && k < depth) {
        const int s = slots[(static_cast<size_t>(t) * depth + k) * P + p];
        if (s >= 0) {
          const float* row = packed + static_cast<size_t>(cand_t[s]) * kFeat;
          sl[k] = s;
          al[k] = quad(row, fd, dir).alpha;
          float col[3];
#pragma unroll
          for (int ch = 0; ch < 3; ++ch) {
            const float* sh = row + 14 + 15 * ch;
            float acc = y[0] * sh[0];
#pragma unroll
            for (int j = 1; j < 15; ++j) acc = acc + y[j] * sh[j];
            col[ch] = row[11 + ch] + acc;
          }
          cr[k] = col[0];
          cg[k] = col[1];
          cb[k] = col[2];
        }
      }
      gk[k] = tr;
      tr = tr * (1.f - al[k]);
    }

    // Suffix recurrences, back to front: gk ← ∂L/∂αₖ, c ← ḡ·Tₖ·αₖ. A vacant
    // layer (α = 0, rgb = 0) leaves U and V unchanged.
    float ur = 0.f, ug = 0.f, ub = 0.f, v = 1.f;
#pragma unroll
    for (int k = K - 1; k >= 0; --k) {
      const float tk = gk[k], ak = al[k];
      const float rk = cr[k], gc = cg[k], bk = cb[k];
      gk[k] = gr * tk * (rk - ur) + gg * tk * (gc - ug) +
              gb * tk * (bk - ub) - gt * tk * v;
      const float w = tk * ak;
      cr[k] = gr * w;
      cg[k] = gg * w;
      cb[k] = gb * w;
      ur = ak * rk + (1.f - ak) * ur;
      ug = ak * gc + (1.f - ak) * ug;
      ub = ak * bk + (1.f - ak) * ub;
      v = (1.f - ak) * v;
    }

    for (int c = 0; c < n_chunks; ++c) {
      const int lo = c * kChunk;
      bool mine = false;
#pragma unroll
      for (int k = 0; k < K; ++k) mine |= sl[k] >= lo && sl[k] < lo + kChunk;
      // The vote is also the barrier that frees the accumulator.
      if (!__syncthreads_or(mine)) continue;
      for (int e = threadIdx.x; e < kLanes * kChunk; e += blockDim.x)
        (&s_acc[0][0])[e] = 0.f;
      __syncthreads();
#pragma unroll
      for (int k = 0; k < K; ++k) {
        if (sl[k] < lo || sl[k] >= lo + kChunk) continue;
        const int i = sl[k] - lo;
        const float* row =
            packed + static_cast<size_t>(cand_t[sl[k]]) * kFeat;
        const Quad qd = quad(row, fd, dir);
        const float ga = gk[k];
        const float ga_alpha = ga * qd.alpha;
        const float d_a = ga_alpha * (-(qd.b * qd.b) / ((4.f * qd.a) * qd.a));
        const float d_b = ga_alpha * (qd.b / (2.f * qd.a));
#pragma unroll
        for (int j = 0; j < 6; ++j) atomicAdd(&s_acc[j][i], d_a * fd[j]);
#pragma unroll
        for (int j = 0; j < 3; ++j)
          atomicAdd(&s_acc[6 + j][i], 2.f * d_b * dir[j]);
        atomicAdd(&s_acc[9][i], -ga_alpha);
        atomicAdd(&s_acc[10][i], ga * qd.rho);
        atomicAdd(&s_acc[11][i], cr[k]);
        atomicAdd(&s_acc[12][i], cg[k]);
        atomicAdd(&s_acc[13][i], cb[k]);
#pragma unroll
        for (int j = 0; j < 15; ++j) {
          atomicAdd(&s_acc[14 + j][i], cr[k] * y[j]);
          atomicAdd(&s_acc[29 + j][i], cg[k] * y[j]);
          atomicAdd(&s_acc[44 + j][i], cb[k] * y[j]);
        }
      }
      __syncthreads();
      float* dst = out + (static_cast<size_t>(t) * C + lo) * kFeat;
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
}

template <int K>
void launch(const float* packed, const int* cand, const int* counts,
            const float* pix, const int* slots, const float* grad_rad,
            const float* grad_trans, float* out, int T, int C, int P,
            int depth, cudaStream_t stream) {
  const int threads = P < kThreads ? P : kThreads;
  peel_bwd_kernel<K><<<T, threads, 0, stream>>>(
      packed, cand, counts, pix, slots, grad_rad, grad_trans, out, C, P,
      depth);
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success). Shapes:
// packed (N+1, 64) f32, cand (T, C) i32, counts (T,) i32, pix (T, P, 24)
// f32, slots (T, depth, P) i32 (the forward's, −1 vacant), grad_rad
// (T, 3, P) f32, grad_trans (T, P) f32; out (T, C, 64) f32, zeroed by the
// caller.
extern "C" int rtgs_peel_bwd(const float* packed, const int* cand,
                             const int* counts, const float* pix,
                             const int* slots, const float* grad_rad,
                             const float* grad_trans, float* out, int T,
                             int C, int P, int depth, int device,
                             void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (C % kChunk != 0 || P < 1 || P > 1024 || depth < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (depth <= 8)
    launch<8>(packed, cand, counts, pix, slots, grad_rad, grad_trans, out, T,
              C, P, depth, s);
  else if (depth <= 16)
    launch<16>(packed, cand, counts, pix, slots, grad_rad, grad_trans, out,
               T, C, P, depth, s);
  else if (depth <= 32)
    launch<32>(packed, cand, counts, pix, slots, grad_rad, grad_trans, out,
               T, C, P, depth, s);
  else if (depth <= 64)
    launch<64>(packed, cand, counts, pix, slots, grad_rad, grad_trans, out,
               T, C, P, depth, s);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

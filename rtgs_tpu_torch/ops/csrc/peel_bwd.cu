// Fused-payload tile peel, backward, on Hopper (sm_90a).
//
// Replaces rtgs_tpu/ops/peel.py:_bwd_kernel (with _layer_cotangents and
// _sweep2_feature_grads): the gradient, with respect to the (N+1, 64)
// feature table, of Σ ḡ·radiance + Σ ḡ_T·transmittance for the forward's
// winners. Per pixel, with layers k in depth order, αₖ, rgbₖ and
// Tₖ = Π_{j<k} (1 − αⱼ):
//   ∂L/∂αₖ = Σ_ch ḡ_ch·Tₖ·(c_ch,k − U_ch) − ḡ_T·Tₖ·Vₖ, ∂L/∂rgbₖ = ḡ·Tₖ·αₖ,
// from the division-free suffix recurrences U = α·c + (1−α)·U and
// V = (1−α)·V (no division by 1 − α, so α → 1 stays finite); then through
// α and rgb into the row lanes (peel_common.cuh, the contraction).
//
// Design. One block per tile, one thread per pixel. The TPU kernel re-runs
// the selection sweep and scatters per slot into a dense (T, C, 64) block
// that the caller scatter-adds again; here the forward kernel hands over
// the winners' slots (T, K, P), so a thread reads its K slots, shades each
// winner once in f32 (the forward's arithmetic; it keeps α, ρ, rgb and the
// two quotients of the quadratic), runs the prefix and suffix recurrences
// in registers and puts each winning layer's seven gradient scalars into
// shared memory. contract_slot_grads() then sums them per slot over the
// tile's pixels and adds one row a (tile, winning slot) into the table:
// no float atomic in shared memory, no dense block.
//
// Bound. Bytes: the winners' rows read once (59 lanes, shared by a tile's
// pixels through L1), the slots and cotangents, and one 236-byte row added
// a live pair. Per (pixel, layer) ~150 f32 flops. The kernel's time is the
// scattered row reads of the shading and the device-memory adds of the
// rows (one a (tile, winning slot) and lane), not arithmetic.
//
// Numerics. f32 throughout, the scalars in the order of
// rtgs_tpu_torch.ops.peel.peel_fused_bwd_torch; a slot's sum runs in the
// order its entries were filled and rows of different tiles meet in
// device-memory atomics, so the result varies run to run in its low bits.

#include "peel_common.cuh"

namespace {

template <int K>
__global__ void __launch_bounds__(kThreads)
    peel_bwd_kernel(const float* __restrict__ packed,
                    const int* __restrict__ cand,
                    const int* __restrict__ counts,
                    const float* __restrict__ pix,
                    const int* __restrict__ slots,
                    const float* __restrict__ grad_rad,
                    const float* __restrict__ grad_trans,
                    float* __restrict__ dpacked, int C, int P, int depth) {
  extern __shared__ __align__(16) unsigned char smem[];
  GradStage& stage = *reinterpret_cast<GradStage*>(smem);

  const int t = blockIdx.x;
  const int* cand_t = cand + static_cast<size_t>(t) * C;
  const int n_slots = counts[t];

  for (int p0 = 0; p0 < P; p0 += blockDim.x) {
    const int p = p0 + threadIdx.x;
    const bool active = p < P;
    const int pp = active ? p : 0;
    const float* pix_g = pix + (static_cast<size_t>(t) * P + p0) * kPixFeat;
    const Pixel px =
        load_pixel(pix + (static_cast<size_t>(t) * P + pp) * kPixFeat);
    const float gr = grad_rad[(static_cast<size_t>(t) * 3 + 0) * P + pp];
    const float gg = grad_rad[(static_cast<size_t>(t) * 3 + 1) * P + pp];
    const float gb = grad_rad[(static_cast<size_t>(t) * 3 + 2) * P + pp];
    const float gt = grad_trans[static_cast<size_t>(t) * P + pp];

    // Layers, each winner shaded once: slot, α, ρ, rgb, the quotients
    // qa = −B²/4A² and qb = B/2A, and the prefix transmittance Tₖ (in gk).
    int sl[K];
    float al[K], rho[K], qa[K], qb[K], cr[K], cg[K], cb[K], gk[K];
    float tr = 1.f;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      sl[k] = -1;
      al[k] = rho[k] = qa[k] = qb[k] = cr[k] = cg[k] = cb[k] = 0.f;
      if (active && k < depth) {
        const int s = slots[(static_cast<size_t>(t) * depth + k) * P + p];
        if (s >= 0) {
          const float* row = packed + static_cast<size_t>(cand_t[s]) * kFeat;
          const Quad qd = quad(row, px);
          sl[k] = s;
          al[k] = qd.alpha;
          rho[k] = qd.rho;
          qa[k] = -(qd.b * qd.b) / ((4.f * qd.a) * qd.a);
          qb[k] = qd.b / (2.f * qd.a);
          cr[k] = color(row, px, 0);
          cg[k] = color(row, px, 1);
          cb[k] = color(row, px, 2);
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

#pragma unroll
    for (int k0 = 0; k0 < K; k0 += kPassLayers) {
      if (k0 >= depth) break;
      __syncthreads();  // the last pass's scalars are read
#pragma unroll
      for (int k = k0; k < k0 + kPassLayers && k < K; ++k) {
        if (sl[k] < 0) continue;
        const float ga_alpha = gk[k] * al[k];
        stage.put(k - k0, ga_alpha * qa[k], 2.f * (ga_alpha * qb[k]),
                  -ga_alpha, gk[k] * rho[k], cr[k], cg[k], cb[k]);
      }
      contract_slot_grads<K>(stage, sl, k0, cand_t, n_slots, pix_g, dpacked);
    }
  }
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success). Shapes:
// packed (N+1, 64) f32, cand (T, C) i32, counts (T,) i32, pix (T, P, 24)
// f32, slots (T, depth, P) i32 (the forward's, −1 vacant), grad_rad
// (T, 3, P) f32, grad_trans (T, P) f32; dpacked (N+1, 64) f32, which the
// kernel adds into (the caller zero-fills it).
extern "C" int rtgs_peel_bwd(const float* packed, const int* cand,
                             const int* counts, const float* pix,
                             const int* slots, const float* grad_rad,
                             const float* grad_trans, float* dpacked, int T,
                             int C, int P, int depth, int device,
                             void* stream) {
  return launch_for_depth(device, C, P, depth, [&](auto cap) {
    constexpr int K = decltype(cap)::value;
    if (!grad_stage_opt_in<peel_bwd_kernel<K>>(device)) return;
    peel_bwd_kernel<K><<<T, warp_threads_for(P), sizeof(GradStage),
                         static_cast<cudaStream_t>(stream)>>>(
        packed, cand, counts, pix, slots, grad_rad, grad_trans, dpacked, C, P,
        depth);
  });
}

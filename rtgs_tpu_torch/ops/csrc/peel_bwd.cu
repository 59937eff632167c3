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
// α and rgb into the row lanes by add_slot_grads (peel_common.cuh). The
// caller scatter-adds the (T, C, 64) rows into (N+1, 64).
//
// Design. One block per tile, one thread per pixel (peel_common.cuh). The
// TPU kernel re-runs the selection sweep; here the forward kernel hands
// over the winners' slots (T, K, P), so a thread reads its K slots, shades
// its K rows in f32 (the forward's arithmetic), and runs the prefix and
// suffix recurrences in registers. The pixel contraction, per 128-slot
// chunk with shared-memory atomics and chunks without a winner skipped, is
// add_slot_grads.
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
    const Pixel px =
        load_pixel(pix + (static_cast<size_t>(t) * P + pp) * kPixFeat);
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
          al[k] = quad(row, px).alpha;
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

    add_slot_grads<K>(packed, cand_t, n_chunks,
                      out + static_cast<size_t>(t) * C * kFeat, one_group, px,
                      sl, gk, cr, cg, cb, s_acc);
  }
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
  return launch_for_depth(device, C, P, depth, [&](auto cap) {
    peel_bwd_kernel<decltype(cap)::value>
        <<<T, threads_for(P), 0, static_cast<cudaStream_t>(stream)>>>(
            packed, cand, counts, pix, slots, grad_rad, grad_trans, out, C, P,
            depth);
  });
}

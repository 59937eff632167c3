// Top-K tile peel, backward, on Hopper (sm_90a).
//
// Replaces rtgs_tpu/ops/peel.py:_bwd_topk_kernel (launched by
// _pallas_bwd_topk): the gradient, with respect to the (N+1, 64) feature
// table, of the top-K forward's winners, from per-layer cotangents the
// caller's autograd hands over (through its merge and composite): ∂L/∂αₖ
// and ∂L/∂rgbₖ. The t1 cotangent is not an input: the order is piecewise
// constant.
//
// Design. The TPU kernel re-runs the selection sweep and scatters into a
// dense (T, C, 64) block; here the forward kernel hands over the winners'
// slots (T, K, P), so a thread reads its K slots and their four
// cotangents, shades each winner's quadratic once in f32, and the rest is
// peel_bwd.cu without its suffix recurrences: the seven gradient scalars of
// every winning layer go into shared memory, and contract_slot_grads()
// (peel_common.cuh) sums them per slot over the tile's pixels into one row
// a (tile, slot) pair of the compacted buffer dslot (stage 1);
// segment_rows.cu adds those into the table (stage 2).
//
// Bound. As peel_bwd.cu: bytes (the winners' rows' first 11 lanes, 16 bytes
// of cotangents a (pixel, layer) read coalesced, one 256-byte pair row
// written a live pair); ~100 f32 flops a (pixel, layer).
//
// Numerics. f32, the scalars in the order of
// rtgs_tpu_torch.ops.peel.peel_topk_bwd_torch; sums as peel_bwd.cu, in an
// order fixed by the inputs: bitwise repeatable.

#include "peel_common.cuh"

namespace {

constexpr int kCotangents = 4;  // ∂α, ∂r, ∂g, ∂b

template <int K>
__global__ void __launch_bounds__(kThreads, 2)
    peel_topk_bwd_kernel(const float* __restrict__ packed,
                         const int* __restrict__ cand,
                         const int* __restrict__ counts,
                         const float* __restrict__ pix,
                         const int* __restrict__ slots,
                         const float* __restrict__ grad_layers,
                         const int* __restrict__ pair_base,
                         float* __restrict__ dslot,
                         int* __restrict__ pair_ids, int C, int P,
                         int depth) {
  extern __shared__ __align__(16) unsigned char smem[];
  GradStage& stage = *reinterpret_cast<GradStage*>(smem);

  const int t = blockIdx.x;
  const int* cand_t = cand + static_cast<size_t>(t) * C;
  const int n_slots = counts[t];
  float* dslot_t = dslot + static_cast<size_t>(pair_base[t]) * kFeat;
  init_pair_rows(dslot_t, pair_ids + pair_base[t], cand_t, n_slots);
  // Lane l of layer k of pixel p: grad_layers[((t·4 + l)·depth + k)·P + p].
  const float* grad_t =
      grad_layers + static_cast<size_t>(t) * kCotangents * depth * P;
  const size_t lane_stride = static_cast<size_t>(depth) * P;

  for (int p0 = 0; p0 < P; p0 += blockDim.x) {
    const int p = p0 + threadIdx.x;
    const bool active = p < P;
    const int pp = active ? p : 0;
    const float* pix_g = pix + (static_cast<size_t>(t) * P + p0) * kPixFeat;
    const Pixel px =
        load_pixel(pix + (static_cast<size_t>(t) * P + pp) * kPixFeat);

    int sl[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      sl[k] = -1;
      if (active && k < depth)
        sl[k] = slots[(static_cast<size_t>(t) * depth + k) * P + p];
    }

#pragma unroll
    for (int k0 = 0; k0 < K; k0 += kPassLayers) {
      if (k0 >= depth) break;
      __syncthreads();  // the last pass's scalars are read
#pragma unroll
      for (int k = k0; k < k0 + kPassLayers && k < K; ++k) {
        if (sl[k] < 0) continue;
        const float* g = grad_t + static_cast<size_t>(k) * P + p;
        const Quad qd = quad(
            packed + static_cast<size_t>(cand_t[sl[k]]) * kFeat, px);
        const float g_a = g[0];
        const float ga_alpha = g_a * qd.alpha;
        const float d_a = ga_alpha * (-(qd.b * qd.b) / ((4.f * qd.a) * qd.a));
        const float d_b = ga_alpha * (qd.b / (2.f * qd.a));
        stage.put(k - k0, d_a, 2.f * d_b, -ga_alpha, g_a * qd.rho,
                  g[lane_stride], g[2 * lane_stride], g[3 * lane_stride]);
      }
      contract_slot_grads<K>(stage, sl, k0, n_slots, pix_g, dslot_t,
                             p0 == 0 && k0 == 0);
    }
  }
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success). Shapes:
// packed (N+1, 64) f32, cand (T, C) i32, counts (T,) i32, pix (T, P, 24)
// f32, slots (T, depth, P) i32 (the forward's, −1 vacant), grad_layers
// (T, 4, depth, P) f32 (lanes ∂α, ∂r, ∂g, ∂b), pair_base (T,) i32; dslot
// (M, 64) f32 and pair_ids (M,) i32, which the kernel fills as peel_bwd.cu
// does.
extern "C" int rtgs_peel_topk_bwd(const float* packed, const int* cand,
                                  const int* counts, const float* pix,
                                  const int* slots, const float* grad_layers,
                                  const int* pair_base, float* dslot,
                                  int* pair_ids, int T, int C, int P,
                                  int depth, int device, void* stream) {
  return launch_for_depth(device, C, P, depth, [&](auto cap) {
    constexpr int K = decltype(cap)::value;
    if (!grad_stage_opt_in<peel_topk_bwd_kernel<K>>(device)) return;
    peel_topk_bwd_kernel<K><<<T, warp_threads_for(P), sizeof(GradStage),
                              static_cast<cudaStream_t>(stream)>>>(
        packed, cand, counts, pix, slots, grad_layers, pair_base, dslot,
        pair_ids, C, P, depth);
  });
}

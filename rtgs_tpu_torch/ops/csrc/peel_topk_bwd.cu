// Top-K tile peel, backward, on Hopper (sm_90a).
//
// Replaces rtgs_tpu/ops/peel.py:_bwd_topk_kernel (launched by
// _pallas_bwd_topk): the per-candidate-slot feature gradients (T, C, 64)
// of the top-K forward's winners, from per-layer cotangents the caller's
// autograd hands over (through its merge and composite): ∂L/∂αₖ and
// ∂L/∂rgbₖ. The t1 cotangent is not an input: the order is piecewise
// constant. The caller scatter-adds the (T, C, 64) rows into (N+1, 64).
//
// Design. The TPU kernel re-runs the selection sweep; here the forward
// kernel hands over the winners' slots (T, K, P), so a thread reads its K
// slots and their four cotangents, and the rest is peel_bwd.cu without its
// suffix recurrences: add_slot_grads (peel_common.cuh) re-shades each
// winner in f32, chains the cotangents into the row lanes, and reduces over
// the tile's pixels per 128-slot chunk in shared memory, skipping chunks
// without a winner.
//
// Bound. As peel_bwd.cu: per (pixel, layer) one 59-lane row read shared
// through L1, ~100 f32 flops and 59 shared atomics, which serialise on a
// tile's front splats; plus 16 bytes of cotangents per (pixel, layer) read
// coalesced; the mostly-zero (T, C, 64) output dominates memory traffic.
//
// Numerics. f32, in the order of
// rtgs_tpu_torch.ops.peel.peel_topk_bwd_torch; the atomics sum in no fixed
// order, so the result varies run to run in its low bits.

#include "peel_common.cuh"

namespace {

constexpr int kGradLanes = 4;  // ∂α, ∂r, ∂g, ∂b

template <int K>
__global__ void __launch_bounds__(kThreads)
    peel_topk_bwd_kernel(const float* __restrict__ packed,
                         const int* __restrict__ cand,
                         const int* __restrict__ counts,
                         const float* __restrict__ pix,
                         const int* __restrict__ slots,
                         const float* __restrict__ grad_layers,
                         float* __restrict__ out, int C, int P, int depth) {
  __shared__ float s_acc[kLanes][kChunk];

  const int t = blockIdx.x;
  const int* cand_t = cand + static_cast<size_t>(t) * C;
  const int n_chunks = (counts[t] + kChunk - 1) / kChunk;
  const bool one_group = P <= static_cast<int>(blockDim.x);
  // Lane l of layer k of pixel p: grad_layers[((t·4 + l)·depth + k)·P + p].
  const float* grad_t =
      grad_layers + static_cast<size_t>(t) * kGradLanes * depth * P;
  const size_t lane_stride = static_cast<size_t>(depth) * P;

  for (int p0 = 0; p0 < P; p0 += blockDim.x) {
    const int p = p0 + threadIdx.x;
    const bool active = p < P;
    const int pp = active ? p : 0;
    const Pixel px =
        load_pixel(pix + (static_cast<size_t>(t) * P + pp) * kPixFeat);

    int sl[K];
    float ga[K], gr[K], gg[K], gb[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      sl[k] = -1;
      ga[k] = gr[k] = gg[k] = gb[k] = 0.f;
      if (active && k < depth) {
        const int s = slots[(static_cast<size_t>(t) * depth + k) * P + p];
        if (s >= 0) {
          const float* g = grad_t + static_cast<size_t>(k) * P + p;
          sl[k] = s;
          ga[k] = g[0];
          gr[k] = g[lane_stride];
          gg[k] = g[2 * lane_stride];
          gb[k] = g[3 * lane_stride];
        }
      }
    }
    add_slot_grads<K>(packed, cand_t, n_chunks,
                      out + static_cast<size_t>(t) * C * kFeat, one_group, px,
                      sl, ga, gr, gg, gb, s_acc);
  }
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success). Shapes:
// packed (N+1, 64) f32, cand (T, C) i32, counts (T,) i32, pix (T, P, 24)
// f32, slots (T, depth, P) i32 (the forward's, −1 vacant), grad_layers
// (T, 4, depth, P) f32 (lanes ∂α, ∂r, ∂g, ∂b); out (T, C, 64) f32, zeroed
// by the caller.
extern "C" int rtgs_peel_topk_bwd(const float* packed, const int* cand,
                                  const int* counts, const float* pix,
                                  const int* slots, const float* grad_layers,
                                  float* out, int T, int C, int P, int depth,
                                  int device, void* stream) {
  return launch_for_depth(device, C, P, depth, [&](auto cap) {
    peel_topk_bwd_kernel<decltype(cap)::value>
        <<<T, threads_for(P), 0, static_cast<cudaStream_t>(stream)>>>(
            packed, cand, counts, pix, slots, grad_layers, out, C, P, depth);
  });
}

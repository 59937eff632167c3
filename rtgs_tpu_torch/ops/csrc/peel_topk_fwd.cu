// Top-K tile peel, forward, on Hopper (sm_90a).
//
// Replaces rtgs_tpu/ops/peel.py:_fwd_topk_kernel (launched by
// _pallas_fwd_topk): for every pixel of a screen tile, the K nearest hits
// among the tile's candidate slots, ordered lexicographically by
// (t1, candidate slot), shaded and NOT composited. The caller composites
// the lists (rtgs_tpu_torch.render.oracle.composite_hits), or, in the
// primitive-sharded ring renderer, first merges lists from several shards
// by t1. Per layer k, depth-ascending, it writes
//   t1 (the float64 entry depth rounded once), α = op·exp(B²/4A − (c0+3))
//   if Δ > 0 else 0 (a tangent winner keeps its layer with α = 0), and
//   rgb = color + y·SH;
// a vacant layer has t1 = +inf and α = r = g = b = 0.
//
// Design. The sweep of peel_fwd.cu (sweep_topk in peel_common.cuh: one
// block per tile, one thread per pixel, a register (t1, slot) list, the
// tile's candidate rows staged into shared memory as float64), then the
// K winners shaded in f32 from their rows. The layer table is written
// (T, 5, K, P) — lanes t1, α, r, g, b — so that the threads of a warp,
// neighbouring pixels, write neighbouring words; the TPU kernel's
// (T, P, 5K) lane layout is a transpose the caller takes as a view. The
// winners' slots are written (T, K, P) as the residual of the backward
// kernel (csrc/peel_topk_bwd.cu).
//
// Bound. The sweep, as in peel_fwd.cu: float64 instruction issue and the
// list insertion. The output is 24 bytes per (pixel, layer), 6·K words
// per pixel, where peel_fwd.cu writes 4 + K.
//
// Numerics as peel_common.cuh. No atomics: the output is bitwise
// deterministic, and bitwise the plain twin's
// (rtgs_tpu_torch.ops.peel.peel_topk_torch) on the same card.

#include "peel_common.cuh"

namespace {

constexpr int kLayerLanes = 5;  // t1, α, r, g, b

template <int K>
__global__ void __launch_bounds__(kThreads)
    peel_topk_fwd_kernel(const float* __restrict__ packed,
                         const int* __restrict__ cand,
                         const int* __restrict__ counts,
                         const float* __restrict__ pix,
                         float* __restrict__ out_layers,
                         int* __restrict__ out_slot, int C, int P,
                         int depth) {
  __shared__ SweepStage stage;

  const int t = blockIdx.x;
  const int* cand_t = cand + static_cast<size_t>(t) * C;
  const int n_chunks = (counts[t] + kChunk - 1) / kChunk;
  // Lane l of layer k of pixel p: out_layers[((t·5 + l)·depth + k)·P + p].
  float* layers_t = out_layers + static_cast<size_t>(t) * kLayerLanes *
                                     depth * P;
  const size_t lane_stride = static_cast<size_t>(depth) * P;

  for (int p0 = 0; p0 < P; p0 += blockDim.x) {
    const int p = p0 + threadIdx.x;
    const bool active = p < P;
    const float* q =
        pix + (static_cast<size_t>(t) * P + (active ? p : 0)) * kPixFeat;
    float kt[K];
    int ks[K];
    sweep_topk<K>(packed, cand_t, n_chunks, active, q, stage, kt, ks);
    if (!active) continue;

    const Pixel px = load_pixel(q);
#pragma unroll
    for (int k = 0; k < K; ++k) {
      if (k < depth) {
        const bool hit = kt[k] < CUDART_INF_F;
        out_slot[(static_cast<size_t>(t) * depth + k) * P + p] =
            hit ? ks[k] : -1;
        float alpha = 0.f, r = 0.f, g = 0.f, b = 0.f;
        if (hit) {
          const float* row =
              packed + static_cast<size_t>(cand_t[ks[k]]) * kFeat;
          alpha = quad(row, px).alpha;
          r = color(row, px, 0);
          g = color(row, px, 1);
          b = color(row, px, 2);
        }
        float* dst = layers_t + static_cast<size_t>(k) * P + p;
        dst[0] = kt[k];  // +inf when vacant
        dst[lane_stride] = alpha;
        dst[2 * lane_stride] = r;
        dst[3 * lane_stride] = g;
        dst[4 * lane_stride] = b;
      }
    }
  }
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success). Shapes:
// packed (N+1, 64) f32, cand (T, C) i32, counts (T,) i32, pix (T, P, 24)
// f32; out_layers (T, 5, depth, P) f32 (lanes t1, α, r, g, b), out_slot
// (T, depth, P) i32 (−1 vacant).
extern "C" int rtgs_peel_topk_fwd(const float* packed, const int* cand,
                                  const int* counts, const float* pix,
                                  float* out_layers, int* out_slot, int T,
                                  int C, int P, int depth, int device,
                                  void* stream) {
  return launch_for_depth(device, C, P, depth, [&](auto cap) {
    peel_topk_fwd_kernel<decltype(cap)::value>
        <<<T, threads_for(P), 0, static_cast<cudaStream_t>(stream)>>>(
            packed, cand, counts, pix, out_layers, out_slot, C, P, depth);
  });
}

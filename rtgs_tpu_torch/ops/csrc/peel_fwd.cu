// Fused-payload tile peel, forward, on Hopper (sm_90a).
//
// Replaces rtgs_tpu/ops/peel.py:_fwd_kernel (with _peel_state,
// _chunk_update, _intersect_t1, _shade_q, _merge_topk and _composite): for
// every pixel of a screen tile, the K nearest hits among the tile's
// candidate slots, ordered lexicographically by (t1, candidate slot), then
// shaded and composited front to back:
//   A = fd·m6, B = 2·d·Me, Δ = B² − 4A·c0, t1 = (−B − √max(Δ,0)) / 2A,
//   a hit iff Δ ≥ 0 and t1 > 0;
//   α = op·exp(B²/4A − (c0+3)) if Δ > 0, else 0 (a tangent hit keeps its
//   layer with α = 0); rgb = color + y·SH;
//   radiance = Σₖ Tₖ αₖ rgbₖ, Tₖ = Π_{j<k} (1 − αⱼ), transmittance = T_K.
//
// Design. One block per tile, one thread per pixel (peel_common.cuh). The
// TPU kernel carries the whole (t1, slot, qa, r, g, b) state through its
// merge; here a thread keeps only its sorted (t1, slot) list in registers
// during the sweep (sweep_topk; K is a template parameter, so every list
// access is a compile-time index), and shades its K winners from their
// rows once the sweep is done, as the JAX two-phase variant does. The
// winners' slots are written out (T, K, P) as the residual of the backward
// kernel (csrc/peel_bwd.cu).
//
// Bound. The sweep costs ~20 float64 flops and a compare per (pixel,
// candidate) plus a square root and a division per hit, against 40 staged
// bytes per candidate shared by the whole block: it is bound by
// instruction issue (FP64 at half the FP32 rate) and the list insertion.
// Shading reads K rows of 59 lanes per pixel, which the pixels of a tile
// share through L1; the composite is K register updates.
//
// Numerics as peel_common.cuh. No atomics: the output is bitwise
// deterministic.

#include "peel_common.cuh"

namespace {

template <int K>
__global__ void __launch_bounds__(kThreads)
    peel_fwd_kernel(const float* __restrict__ packed,
                    const int* __restrict__ cand,
                    const int* __restrict__ counts,
                    const float* __restrict__ pix,
                    float* __restrict__ out_rad,
                    float* __restrict__ out_trans,
                    int* __restrict__ out_slot, int C, int P, int depth) {
  __shared__ SweepStage stage;

  const int t = blockIdx.x;
  const int* cand_t = cand + static_cast<size_t>(t) * C;
  const int n_chunks = (counts[t] + kChunk - 1) / kChunk;

  for (int p0 = 0; p0 < P; p0 += blockDim.x) {
    const int p = p0 + threadIdx.x;
    const bool active = p < P;
    const float* q =
        pix + (static_cast<size_t>(t) * P + (active ? p : 0)) * kPixFeat;
    float kt[K];
    int ks[K];
    sweep_topk<K>(packed, cand_t, n_chunks, active, q, stage, kt, ks);
    if (!active) continue;

    // Shade the winners in f32 and composite front to back.
    const Pixel px = load_pixel(q);
    float rr = 0.f, rg = 0.f, rb = 0.f, tr = 1.f;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      if (k < depth) {
        const bool hit = kt[k] < CUDART_INF_F;
        out_slot[(static_cast<size_t>(t) * depth + k) * P + p] =
            hit ? ks[k] : -1;
        if (hit) {
          const float* row =
              packed + static_cast<size_t>(cand_t[ks[k]]) * kFeat;
          const float alpha = quad(row, px).alpha;
          const float w = tr * alpha;
          rr = rr + w * color(row, px, 0);
          rg = rg + w * color(row, px, 1);
          rb = rb + w * color(row, px, 2);
          tr = tr * (1.f - alpha);
        }
      }
    }
    out_rad[(static_cast<size_t>(t) * 3 + 0) * P + p] = rr;
    out_rad[(static_cast<size_t>(t) * 3 + 1) * P + p] = rg;
    out_rad[(static_cast<size_t>(t) * 3 + 2) * P + p] = rb;
    out_trans[static_cast<size_t>(t) * P + p] = tr;
  }
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success). Shapes:
// packed (N+1, 64) f32, cand (T, C) i32, counts (T,) i32, pix (T, P, 24)
// f32; out_rad (T, 3, P) f32, out_trans (T, P) f32, out_slot (T, depth, P)
// i32 (−1 vacant).
extern "C" int rtgs_peel_fwd(const float* packed, const int* cand,
                             const int* counts, const float* pix,
                             float* out_rad, float* out_trans, int* out_slot,
                             int T, int C, int P, int depth, int device,
                             void* stream) {
  return launch_for_depth(device, C, P, depth, [&](auto cap) {
    peel_fwd_kernel<decltype(cap)::value>
        <<<T, threads_for(P), 0, static_cast<cudaStream_t>(stream)>>>(
            packed, cand, counts, pix, out_rad, out_trans, out_slot, C, P,
            depth);
  });
}

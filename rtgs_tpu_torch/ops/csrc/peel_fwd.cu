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
// Depth. The list holds at most kMaxDepth = 64 pairs (peel_common.cuh); a
// deeper peel runs in passes (rtgs_tpu_torch.ops.peel.peel_fused), each a
// launch that sweeps the tile again above the pixel's floor (floor_t1,
// floor_slot: the last winner of the pass before) and composites its own
// layers from T = 1; the caller chains the passes' radiance and
// transmittance. out_last_t1, where given, receives the t1 of the pass's
// last layer (+inf when vacant), the next pass's floor with its slot.
//
// Bound. Operations: the float64 chain is 21 operations a (pixel,
// candidate) pair without FMA at half the f32 rate, and ~98% of the pairs
// miss; 48 staged bytes a candidate are shared by the whole block. The
// sweep therefore screens in f32 first (sweep_topk: batches of 32
// candidates, then each lane's survivors through the float64 chain and the
// list insertion), as the keys kernel does, with which it shares the
// staging and the chunk sweep; two blocks of 256 threads an SM at K ≤ 16.
// Shading reads K rows of 59 lanes per pixel: the block copies its tile's
// rows into shared memory once where they fit (stage_tile_rows), and a
// longer tile's pixels share them through L1; the composite is K register
// updates.
//
// Numerics as peel_common.cuh. No atomics: the output is bitwise
// deterministic.

#include "peel_common.cuh"

namespace {

// kCount: also count the swept and the screened-out pairs into
// screen_counts[0:2] (the timed instantiation carries no counter).
template <int K, bool kCount>
__global__ void __launch_bounds__(kThreads, K <= 16 ? 2 : 1)
    peel_fwd_kernel(const float* __restrict__ packed,
                    const int* __restrict__ cand,
                    const int* __restrict__ counts,
                    const float* __restrict__ pix,
                    const float* __restrict__ floor_t1,
                    const int* __restrict__ floor_slot,
                    float* __restrict__ out_rad,
                    float* __restrict__ out_trans,
                    int* __restrict__ out_slot,
                    float* __restrict__ out_last_t1,
                    unsigned long long* __restrict__ screen_counts, int C,
                    int P, int depth) {
  __shared__ SweepStage stage;
  extern __shared__ __align__(16) float s_rows[];

  const int t = blockIdx.x;
  const int* cand_t = cand + static_cast<size_t>(t) * C;
  const int n_chunks = (counts[t] + kChunk - 1) / kChunk;
  const bool staged = stage_tile_rows(s_rows, packed, cand_t, counts[t]);
  unsigned long long n_pairs = 0, n_rejected = 0;

  for (int p0 = 0; p0 < P; p0 += blockDim.x) {
    const int p = p0 + threadIdx.x;
    const bool active = p < P;
    const size_t tp = static_cast<size_t>(t) * P + (active ? p : 0);
    const float* q = pix + tp * kPixFeat;
    float kt[K];
    int ks[K];
    sweep_topk<K, kCount>(packed, cand_t, n_chunks, active, q, stage, kt, ks,
                          load_floor(floor_t1, floor_slot, tp), n_pairs,
                          n_rejected);
    if (!active) continue;

    // Shade the winners in f32 and composite front to back.
    const Pixel px = load_pixel(q);
    float rr = 0.f, rg = 0.f, rb = 0.f, tr = 1.f, last = CUDART_INF_F;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      if (k < depth) {
        const bool hit = kt[k] < CUDART_INF_F;
        if (k == depth - 1 && hit) last = kt[k];
        out_slot[(static_cast<size_t>(t) * depth + k) * P + p] =
            hit ? ks[k] : -1;
        if (hit) {
          const float* row =
              winner_row(staged, s_rows, packed, cand_t, ks[k]);
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
    out_trans[tp] = tr;
    if (out_last_t1) out_last_t1[tp] = last;
  }
  if (kCount) {
    atomicAdd(screen_counts, n_pairs);
    atomicAdd(screen_counts + 1, n_rejected);
  }
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success). Shapes:
// packed (N+1, 64) f32, cand (T, C) i32, counts (T,) i32, pix (T, P, 24)
// f32, floor_t1 (T, P) f32 and floor_slot (T, P) i32 (both null: no
// floor); out_rad (T, 3, P) f32, out_trans (T, P) f32, out_slot
// (T, depth, P) i32 (−1 vacant), out_last_t1 (T, P) f32 or null;
// screen_counts: null, or two 64-bit counters the kernel adds the swept and
// the screened-out (pixel, live candidate) pairs into.
extern "C" int rtgs_peel_fwd(const float* packed, const int* cand,
                             const int* counts, const float* pix,
                             const float* floor_t1, const int* floor_slot,
                             float* out_rad, float* out_trans, int* out_slot,
                             float* out_last_t1,
                             unsigned long long* screen_counts, int T, int C,
                             int P, int depth, int device, void* stream) {
  return launch_for_depth(device, C, P, depth, [&](auto cap) {
    constexpr int K = decltype(cap)::value;
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (screen_counts) {
      if (dynamic_smem_opt_in<peel_fwd_kernel<K, true>>(device, kShadeBytes) !=
          cudaSuccess)
        return;
      peel_fwd_kernel<K, true><<<T, threads_for(P), kShadeBytes, s>>>(
          packed, cand, counts, pix, floor_t1, floor_slot, out_rad,
          out_trans, out_slot, out_last_t1, screen_counts, C, P, depth);
    } else {
      if (dynamic_smem_opt_in<peel_fwd_kernel<K, false>>(device,
                                                          kShadeBytes) !=
          cudaSuccess)
        return;
      peel_fwd_kernel<K, false><<<T, threads_for(P), kShadeBytes, s>>>(
          packed, cand, counts, pix, floor_t1, floor_slot, out_rad,
          out_trans, out_slot, out_last_t1, nullptr, C, P, depth);
    }
  });
}

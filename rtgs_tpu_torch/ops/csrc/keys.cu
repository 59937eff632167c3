// Keys-only tile top-K on Hopper (sm_90a).
//
// Replaces rtgs_tpu/ops/peel.py:_keys_sid_kernel_lp (and its lane-major
// sibling _keys_sid_kernel): for every pixel of a screen tile, the K
// lexicographically smallest (t1, splat id) pairs among the tile's
// candidates, where t1 is the ray's entry depth into the xᵀΣ⁻¹x = 3
// ellipsoid:
//   A = fd·m6, B = 2·d·Me, Δ = B² − 4A·c0, t1 = (−B − √max(Δ,0)) / 2A,
//   a hit iff Δ ≥ 0 and t1 > 0.
//
// Bound. Operations: 21 float64 operations a (pixel, candidate) pair, which
// must run without FMA (the result is bitwise the plain twin's) on a pipe
// of half the f32 width; the candidate's 40 bytes are read once a block and
// shared by its pixels, so memory traffic is far below that. ~98% of the
// pairs miss, and a miss needs no depth.
//
// Design. One block per tile, one thread per pixel (groups of kThreads). A
// thread keeps its pixel's direction features in registers, in f32 and in
// float64, and a sorted list of K (t1, id) pairs in registers (K is a
// template parameter, so every list access is a compile-time index). The
// block sweeps the tile's candidates in chunks of 128, with the staging and
// the chunk sweep it shares with the fused and top-K peels (stage_chunk and
// sweep_chunk, peel_common.cuh). Staging, one thread
// a candidate: lanes 0-11 of packed[cand[t, c]] as three 16-byte loads (no
// (T, C, 64) gather exists), the screen's margin for this tile (from the
// tile's largest |d| and |fd|, one block reduction a pixel group), and the
// id, into a candidate-major row of 48 bytes. Sweep, kBatch candidates at a
// time: a thread reads each row as three 16-byte broadcast loads and
// evaluates Δ/4 in f32 with explicit FMAs (screen_rejects,
// peel_common.cuh, where the margin's derivation is), kBatch independent
// chains; a pair goes on only when the f32 value is not provably negative.
// Then each thread runs its own survivors of the batch through the float64
// chain, exactly as before (the row's ten lanes converted in registers; a
// hit that beats the K-th pair is inserted with one unrolled
// compare-exchange pass), so a warp takes as many float64 turns as its
// busiest lane has survivors, not one a candidate that any lane kept.
// Nothing is staged as float64 (measured: staging it too changes nothing
// at 100k @ 640x384 and gains 7% at 1M @ 256x192), and shared memory a
// block is 6 KB, so occupancy is the registers': two blocks of 256 threads
// an SM at K <= 16 measured best (three force spills and gain nothing; a
// batch of 32 beat 4, 8 and 16).
// Before each chunk the block votes (__syncthreads_or) whether any
// pixel's K-th t1 still exceeds the chunk's entry-depth lower bound
// chunk_lb[t, c]; when none does, no later candidate can enter any list and
// the sweep stops, with the result exactly the full sweep's. Thread p
// writes out[t, k, p], which coalesces.
//
// Depth. A list holds at most kMaxDepth = 64 pairs in registers (at K = 64
// already 128 registers a thread, one block an SM; K = 128 would spill).
// A deeper peel runs in passes (rtgs_tpu_torch.ops.peel.peel_keys): pass
// j + 1 gets pass j's last winner per pixel, (out_t1, out_sid)[:, K − 1],
// as its floor, and lists only the pairs lexicographically after it
// (Floor, peel_common.cuh). The floor only removes candidates, so the early
// exit stays exact.
//
// Numerics. B² and 4A·c0 nearly cancel in Δ (their ratio is within
// ~3/|Σ^-½e|² of 1), so an f32 chain loses up to ~1e-3 of t1 at bench
// splat sizes; the deciding chain runs in float64 from the f32 tables and
// t1 is rounded to f32 once. Built with IEEE sqrt and division and
// --fmad=false; the operations and their order are those of
// rtgs_tpu_torch.ops.peel.entry_depth, so the plain torch twin on the card
// gives bitwise the same t1 and ids. The screen only skips pairs whose
// float64 Δ is negative, so it changes no bit of the result.

#include "peel_common.cuh"

namespace {

// kCount: also count the evaluated and the rejected pairs into
// screen_counts[0:2] (the timed instantiation carries no counter).
template <int K, bool kCount>
__global__ void __launch_bounds__(kThreads, K <= 16 ? 2 : 1)
    keys_sid_kernel(const float* __restrict__ packed,
                    const int* __restrict__ cand,
                    const int* __restrict__ counts,
                    const float* __restrict__ chunk_lb,
                    const float* __restrict__ pix,
                    const float* __restrict__ floor_t1,
                    const int* __restrict__ floor_sid,
                    float* __restrict__ out_t1, int* __restrict__ out_sid,
                    unsigned long long* __restrict__ screen_counts, int C,
                    int P, int depth) {
  __shared__ SweepStage stage;

  const int t = blockIdx.x;
  const int* cand_t = cand + static_cast<size_t>(t) * C;
  const float* lb_t = chunk_lb + static_cast<size_t>(t) * (C / kChunk + 1);
  const int n_chunks = (counts[t] + kChunk - 1) / kChunk;
  unsigned long long n_pairs = 0, n_rejected = 0;

  for (int p0 = 0; p0 < P; p0 += blockDim.x) {
    const int p = p0 + threadIdx.x;
    const bool active = p < P;
    const float* q =
        pix + (static_cast<size_t>(t) * P + (active ? p : P - 1)) * kPixFeat;
    const SweepPixel px = load_sweep_pixel(q);
    const Floor fl = load_floor(floor_t1, floor_sid,
                                static_cast<size_t>(t) * P + (active ? p : 0));
    stage_pixel_max(stage, q);

    float kt[K];
    int ks[K];
    clear_list(kt, ks);

    for (int c = 0; c < n_chunks; ++c) {
      float kth = kt[0];
#pragma unroll
      for (int k = 1; k < K; ++k) kth = (k == depth - 1) ? kt[k] : kth;
      // The vote is also the barrier that frees the staging rows (and, in
      // the first chunk, publishes the group's largest |d| and |fd|).
      if (!__syncthreads_or(active && kth > lb_t[c])) break;
      stage_chunk(stage, packed, cand_t, c);
      __syncthreads();
      if (active)
        sweep_chunk<K, true, kCount>(stage, 0, px, fl, kt, ks, n_pairs,
                                     n_rejected);
    }

    if (!active) continue;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      if (k < depth) {
        const size_t o = (static_cast<size_t>(t) * depth + k) * P + p;
        const bool hit = kt[k] < CUDART_INF_F;
        out_t1[o] = hit ? kt[k] : CUDART_INF_F;
        out_sid[o] = hit ? ks[k] : -1;
      }
    }
  }
  if (kCount) {
    atomicAdd(screen_counts, n_pairs);
    atomicAdd(screen_counts + 1, n_rejected);
  }
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success). Shapes:
// packed (N+1, 64) f32, cand (T, C) i32, counts (T,) i32,
// chunk_lb (T, C/128 + 1) f32, pix (T, P, 24) f32, floor_t1 (T, P) f32 and
// floor_sid (T, P) i32 (both null: no floor), outputs (T, depth, P);
// screen_counts: null, or two 64-bit counters the kernel adds the evaluated
// and the screened-out (pixel, live candidate) pairs into.
extern "C" int rtgs_keys_sid(const float* packed, const int* cand,
                             const int* counts, const float* chunk_lb,
                             const float* pix, const float* floor_t1,
                             const int* floor_sid, float* out_t1, int* out_sid,
                             unsigned long long* screen_counts, int T, int C,
                             int P, int depth, int device, void* stream) {
  return launch_for_depth(device, C, P, depth, [&](auto cap) {
    constexpr int K = decltype(cap)::value;
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (screen_counts)
      keys_sid_kernel<K, true><<<T, threads_for(P), 0, s>>>(
          packed, cand, counts, chunk_lb, pix, floor_t1, floor_sid, out_t1,
          out_sid, screen_counts, C, P, depth);
    else
      keys_sid_kernel<K, false><<<T, threads_for(P), 0, s>>>(
          packed, cand, counts, chunk_lb, pix, floor_t1, floor_sid, out_t1,
          out_sid, nullptr, C, P, depth);
  });
}

extern "C" const char* rtgs_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

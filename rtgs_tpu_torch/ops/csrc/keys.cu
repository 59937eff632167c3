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
// block sweeps the tile's candidates in chunks of 128. Staging, one thread
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

constexpr int kBatch = 32;  // candidates screened before their survivors run

// kCount: also count the evaluated and the rejected pairs into
// screen_counts[0:2] (the timed instantiation carries no counter).
template <int K, bool kCount>
__global__ void __launch_bounds__(kThreads, K <= 16 ? 2 : 1)
    keys_sid_kernel(const float* __restrict__ packed,
                    const int* __restrict__ cand,
                    const int* __restrict__ counts,
                    const float* __restrict__ chunk_lb,
                    const float* __restrict__ pix,
                    float* __restrict__ out_t1, int* __restrict__ out_sid,
                    unsigned long long* __restrict__ screen_counts, int C,
                    int P, int depth) {
  __shared__ ScreenRow s_row[kChunk];
  __shared__ unsigned s_max[9];

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
    const float d[3] = {q[0], q[1], q[2]};
    const float fd[6] = {q[3], q[4], q[5], q[6], q[7], q[8]};
    const double d0 = d[0], d1 = d[1], d2 = d[2];
    const double f0 = fd[0], f1 = fd[1], f2 = fd[2], f3 = fd[3], f4 = fd[4],
                 f5 = fd[5];

    // The group's largest |d| and |fd|, as bit patterns: they order like
    // the values, and a NaN orders above +inf and so survives.
    __syncthreads();  // the last group's staging is done with s_max
    if (threadIdx.x < 9) s_max[threadIdx.x] = 0u;
    __syncthreads();
    {
      const unsigned mask = __activemask();
#pragma unroll
      for (int j = 0; j < 9; ++j) {
        const unsigned m =
            __reduce_max_sync(mask, __float_as_uint(fabsf(q[j])));
        if ((threadIdx.x & 31) == 0) atomicMax(&s_max[j], m);
      }
    }

    // Vacant entries are (+inf, INT_MAX): every hit orders before them.
    float kt[K];
    int ks[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      kt[k] = CUDART_INF_F;
      ks[k] = INT_MAX;
    }

    for (int c = 0; c < n_chunks; ++c) {
      float kth = kt[0];
#pragma unroll
      for (int k = 1; k < K; ++k) kth = (k == depth - 1) ? kt[k] : kth;
      // The vote is also the barrier that frees the staging rows (and, in
      // the first chunk, publishes s_max).
      if (!__syncthreads_or(active && kth > lb_t[c])) break;

      for (int i = threadIdx.x; i < kChunk; i += blockDim.x) {
        const int id = cand_t[c * kChunk + i];
        ScreenRow row;
        if (id >= 0) {
          const float4* src = reinterpret_cast<const float4*>(
              packed + static_cast<size_t>(id) * kFeat);
          const float4 r0 = __ldg(src), r1 = __ldg(src + 1),
                       r2 = __ldg(src + 2);
          const float m[kStage] = {r0.x, r0.y, r0.z, r0.w, r1.x,
                                   r1.y, r1.z, r1.w, r2.x, r2.y};
          float mx[9];
#pragma unroll
          for (int j = 0; j < 9; ++j) mx[j] = __uint_as_float(s_max[j]);
#pragma unroll
          for (int j = 0; j < kStage; ++j) row.m[j] = m[j];
          row.margin = screen_margin(m, mx);
        } else {
          // Padding: Δ/4 = −0 < 1, rejected by the screen (and by its id
          // should a NaN pixel carry it past).
#pragma unroll
          for (int j = 0; j < kStage; ++j) row.m[j] = 0.f;
          row.margin = -1.f;
        }
        row.id = id;
        s_row[i] = row;
      }
      __syncthreads();
      if (!active) continue;

      for (int i0 = 0; i0 < kChunk; i0 += kBatch) {
        // The screen for kBatch candidates at once (independent chains),
        // then this pixel's survivors, each through the float64 chain: a
        // warp takes as many turns as its busiest lane has survivors.
        unsigned pending = 0;
#pragma unroll
        for (int j = 0; j < kBatch; ++j) {
          const float4* rp = reinterpret_cast<const float4*>(&s_row[i0 + j]);
          const bool rejected = screen_rejects(d, fd, rp[0], rp[1], rp[2]);
          pending |= static_cast<unsigned>(!rejected) << j;
          if (kCount) {
            const int live = s_row[i0 + j].id >= 0;
            n_pairs += live;
            n_rejected += live && rejected;
          }
        }
        while (pending) {
          const ScreenRow& row = s_row[i0 + __ffs(pending) - 1];
          pending &= pending - 1;
          const int id = row.id;
          if (id < 0) continue;  // padding: never a hit
          double a = f0 * static_cast<double>(row.m[0]);
          a = a + f1 * static_cast<double>(row.m[1]);
          a = a + f2 * static_cast<double>(row.m[2]);
          a = a + f3 * static_cast<double>(row.m[3]);
          a = a + f4 * static_cast<double>(row.m[4]);
          a = a + f5 * static_cast<double>(row.m[5]);
          double b = d0 * static_cast<double>(row.m[6]);
          b = b + d1 * static_cast<double>(row.m[7]);
          b = b + d2 * static_cast<double>(row.m[8]);
          b = 2.0 * b;
          const double delta =
              b * b - (4.0 * a) * static_cast<double>(row.m[9]);
          if (!(delta >= 0.0)) continue;  // miss (or NaN)
          const double sq = sqrt(delta > 0.0 ? delta : 0.0);
          const double t1d = (-b - sq) / (2.0 * a);
          if (!(t1d > 0.0)) continue;
          const float t1 = static_cast<float>(t1d);
          if (!lex_less(t1, id, kt[K - 1], ks[K - 1])) continue;
          // Insert: one compare-exchange pass carries the larger pair down.
          float ct = t1;
          int cs = id;
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
// chunk_lb (T, C/128 + 1) f32, pix (T, P, 24) f32, outputs (T, depth, P);
// screen_counts: null, or two 64-bit counters the kernel adds the evaluated
// and the screened-out (pixel, live candidate) pairs into.
extern "C" int rtgs_keys_sid(const float* packed, const int* cand,
                             const int* counts, const float* chunk_lb,
                             const float* pix, float* out_t1, int* out_sid,
                             unsigned long long* screen_counts, int T, int C,
                             int P, int depth, int device, void* stream) {
  return launch_for_depth(device, C, P, depth, [&](auto cap) {
    constexpr int K = decltype(cap)::value;
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (screen_counts)
      keys_sid_kernel<K, true><<<T, threads_for(P), 0, s>>>(
          packed, cand, counts, chunk_lb, pix, out_t1, out_sid, screen_counts,
          C, P, depth);
    else
      keys_sid_kernel<K, false><<<T, threads_for(P), 0, s>>>(
          packed, cand, counts, chunk_lb, pix, out_t1, out_sid, nullptr, C, P,
          depth);
  });
}

extern "C" const char* rtgs_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

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
// Design. One block per tile, one thread per pixel (P ≤ 1024). A thread
// keeps its pixel's direction features in registers and a sorted list of
// K (t1, id) pairs in registers (K is a template parameter, so every list
// access is a compile-time index). The block sweeps the tile's candidates
// in chunks of 128: it stages lanes 0-9 (m6, Me, c0) and the id of each
// candidate straight from packed[cand[t, c]] into shared memory — no
// (T, C, 64) gather is ever materialised, and only 40 of each row's 256
// bytes are read — then every thread evaluates the chunk against its
// pixel and inserts each hit that beats its current K-th pair with one
// unrolled compare-exchange pass. Before each chunk the block votes
// (__syncthreads_or) whether any pixel's K-th t1 still exceeds the
// chunk's entry-depth lower bound chunk_lb[t, c]; when none does, no later
// candidate can enter any list and the sweep stops, with the result exactly
// the full sweep's. Thread p writes out[t, k, p], which coalesces.
//
// Bound. Per (pixel, candidate): ~20 float64 flops and a compare, plus a
// square root and a division on hits; the candidate's 40 bytes are read
// once per block and shared by all P threads, so the kernel is bound by
// instruction issue (FP64 runs at half the FP32 rate) and the insertion,
// not by memory traffic. The early exit cuts the swept candidates; the
// register list keeps the insertion free of shared-memory traffic; the
// staged features are converted to float64 once per block, not per pixel.
//
// Numerics. B² and 4A·c0 nearly cancel in Δ (their ratio is within
// ~3/|Σ^-½e|² of 1), so an f32 chain loses up to ~1e-3 of t1 at bench
// splat sizes; the chain runs in float64 from the f32 tables and t1 is
// rounded to f32 once. Built with IEEE sqrt and division and --fmad=false;
// the operations and their order are those of
// rtgs_tpu_torch.ops.peel.entry_depth, so the plain torch twin on the card
// gives bitwise the same t1 and ids.

#include <climits>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kChunk = 128;  // candidate slots per sweep step (ops/peel.py CHUNK)
constexpr int kFeat = 64;    // packed feature row width
constexpr int kPixFeat = 24; // pixel feature row width
constexpr int kStage = 10;   // staged lanes: m6 (0:6), Me (6:9), c0 (9)

__device__ __forceinline__ bool lex_less(float ta, int ia, float tb, int ib) {
  return ta < tb || (ta == tb && ia < ib);
}

template <int K>
__global__ void keys_sid_kernel(const float* __restrict__ packed,
                                const int* __restrict__ cand,
                                const int* __restrict__ counts,
                                const float* __restrict__ chunk_lb,
                                const float* __restrict__ pix,
                                float* __restrict__ out_t1,
                                int* __restrict__ out_sid,
                                int C, int P, int depth) {
  __shared__ double s_feat[kStage][kChunk];
  __shared__ int s_id[kChunk];

  const int t = blockIdx.x;
  const int p = threadIdx.x;
  const float* q = pix + (static_cast<size_t>(t) * P + p) * kPixFeat;
  const double d0 = q[0], d1 = q[1], d2 = q[2];
  const double f0 = q[3], f1 = q[4], f2 = q[5], f3 = q[6], f4 = q[7],
               f5 = q[8];

  // Vacant entries are (+inf, INT_MAX): every hit orders before them.
  float kt[K];
  int ks[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    kt[k] = CUDART_INF_F;
    ks[k] = INT_MAX;
  }

  const int* cand_t = cand + static_cast<size_t>(t) * C;
  const float* lb_t = chunk_lb + static_cast<size_t>(t) * (C / kChunk + 1);
  const int n_chunks = (counts[t] + kChunk - 1) / kChunk;
  for (int c = 0; c < n_chunks; ++c) {
    float kth = kt[0];
#pragma unroll
    for (int k = 1; k < K; ++k) kth = (k == depth - 1) ? kt[k] : kth;
    // The vote is also the barrier that frees the staging buffers.
    if (!__syncthreads_or(kth > lb_t[c])) break;

    for (int e = threadIdx.x; e < kChunk * kStage; e += blockDim.x) {
      const int i = e / kStage;
      const int lane = e - i * kStage;
      const int id = cand_t[c * kChunk + i];
      if (lane == 0) s_id[i] = id;
      s_feat[lane][i] = id >= 0 ? static_cast<double>(
                                      packed[static_cast<size_t>(id) * kFeat +
                                             lane])
                                : 0.0;
    }
    __syncthreads();

#pragma unroll 2
    for (int i = 0; i < kChunk; ++i) {
      const int id = s_id[i];
      if (id < 0) continue;  // padding: never read the row
      double a = f0 * s_feat[0][i];
      a = a + f1 * s_feat[1][i];
      a = a + f2 * s_feat[2][i];
      a = a + f3 * s_feat[3][i];
      a = a + f4 * s_feat[4][i];
      a = a + f5 * s_feat[5][i];
      double b = d0 * s_feat[6][i];
      b = b + d1 * s_feat[7][i];
      b = b + d2 * s_feat[8][i];
      b = 2.0 * b;
      const double delta = b * b - (4.0 * a) * s_feat[9][i];
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

template <int K>
void launch(const float* packed, const int* cand, const int* counts,
            const float* chunk_lb, const float* pix, float* out_t1,
            int* out_sid, int T, int C, int P, int depth,
            cudaStream_t stream) {
  keys_sid_kernel<K><<<T, P, 0, stream>>>(packed, cand, counts, chunk_lb, pix,
                                          out_t1, out_sid, C, P, depth);
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success). Shapes:
// packed (N+1, 64) f32, cand (T, C) i32, counts (T,) i32,
// chunk_lb (T, C/128 + 1) f32, pix (T, P, 24) f32, outputs (T, depth, P).
extern "C" int rtgs_keys_sid(const float* packed, const int* cand,
                             const int* counts, const float* chunk_lb,
                             const float* pix, float* out_t1, int* out_sid,
                             int T, int C, int P, int depth, int device,
                             void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (C % kChunk != 0 || P < 1 || P > 1024 || depth < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (depth <= 8)
    launch<8>(packed, cand, counts, chunk_lb, pix, out_t1, out_sid, T, C, P,
              depth, s);
  else if (depth <= 16)
    launch<16>(packed, cand, counts, chunk_lb, pix, out_t1, out_sid, T, C, P,
               depth, s);
  else if (depth <= 32)
    launch<32>(packed, cand, counts, chunk_lb, pix, out_t1, out_sid, T, C, P,
               depth, s);
  else if (depth <= 64)
    launch<64>(packed, cand, counts, chunk_lb, pix, out_t1, out_sid, T, C, P,
               depth, s);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* rtgs_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

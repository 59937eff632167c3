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
// Design. One block per tile, one thread per pixel (blocks of at most 256
// threads; a tile with more pixels is swept once per group of 256). The
// TPU kernel carries the whole (t1, slot, qa, r, g, b) state through its
// merge; here a thread keeps only its sorted (t1, slot) list in registers
// during the sweep (K is a template parameter, so every list access is a
// compile-time index), and shades its K winners from their rows once the
// sweep is done, as the JAX two-phase variant does. The block sweeps the
// tile's slots [0, ceil(count/128)·128) in chunks of 128, staging lanes
// 0-9 of each candidate's row straight from packed[cand[t, c]] into shared
// memory (as float64, once per block), so no (T, C, 64) gather exists. A
// −1 slot is skipped: it would read the sentinel row, which never hits.
// Slots arrive in increasing order, so a hit whose t1 equals a listed one
// sorts after it, which is the TPU merge's lower-lane tie-break. The
// winners' slots are written out (T, K, P) as the residual of the
// backward kernel (csrc/peel_bwd.cu).
//
// Bound. The sweep costs ~20 float64 flops and a compare per (pixel,
// candidate) plus a square root and a division per hit, against 40 staged
// bytes per candidate shared by the whole block: it is bound by
// instruction issue (FP64 at half the FP32 rate) and the list insertion.
// Shading reads K rows of 59 lanes per pixel, which the pixels of a tile
// share through L1; the composite is K register updates.
//
// Numerics. The entry depth runs in float64 from the f32 tables and is
// rounded to f32 once (B² and 4A·c0 cancel in Δ), with the operations and
// order of rtgs_tpu_torch.ops.peel.entry_depth, so the winners are bitwise
// those of the plain twin. Shading is f32 in the order of
// rtgs_tpu_torch.ops.peel._shade_layers. Built with IEEE sqrt and division
// and --fmad=false. No atomics: the output is bitwise deterministic.

#include <climits>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kChunk = 128;    // candidate slots per sweep step (CHUNK)
constexpr int kFeat = 64;      // packed feature row width
constexpr int kPixFeat = 24;   // pixel feature row width
constexpr int kStage = 10;     // staged lanes: m6 (0:6), Me (6:9), c0 (9)
constexpr int kThreads = 256;  // pixels per sweep group

__device__ __forceinline__ bool lex_less(float ta, int sa, float tb, int sb) {
  return ta < tb || (ta == tb && sa < sb);
}

template <int K>
__global__ void __launch_bounds__(kThreads)
    peel_fwd_kernel(const float* __restrict__ packed,
                    const int* __restrict__ cand,
                    const int* __restrict__ counts,
                    const float* __restrict__ pix,
                    float* __restrict__ out_rad,
                    float* __restrict__ out_trans,
                    int* __restrict__ out_slot, int C, int P, int depth) {
  __shared__ double s_feat[kStage][kChunk];
  __shared__ int s_live[kChunk];

  const int t = blockIdx.x;
  const int* cand_t = cand + static_cast<size_t>(t) * C;
  const int n_chunks = (counts[t] + kChunk - 1) / kChunk;

  for (int p0 = 0; p0 < P; p0 += blockDim.x) {
    const int p = p0 + threadIdx.x;
    const bool active = p < P;
    const float* q =
        pix + (static_cast<size_t>(t) * P + (active ? p : 0)) * kPixFeat;
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

    for (int c = 0; c < n_chunks; ++c) {
      __syncthreads();  // the previous chunk's readers are done
      for (int e = threadIdx.x; e < kChunk * kStage; e += blockDim.x) {
        const int i = e / kStage;
        const int lane = e - i * kStage;
        const int id = cand_t[c * kChunk + i];
        if (lane == 0) s_live[i] = id >= 0;
        s_feat[lane][i] =
            id >= 0 ? static_cast<double>(
                          packed[static_cast<size_t>(id) * kFeat + lane])
                    : 0.0;
      }
      __syncthreads();
      if (!active) continue;

#pragma unroll 2
      for (int i = 0; i < kChunk; ++i) {
        if (!s_live[i]) continue;
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
        const int slot = c * kChunk + i;
        if (!lex_less(t1, slot, kt[K - 1], ks[K - 1])) continue;
        // Insert: one compare-exchange pass carries the larger pair down.
        float ct = t1;
        int cs = slot;
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
    if (!active) continue;

    // Shade the winners in f32 and composite front to back.
    float fd[6], dir[3], y[15];
#pragma unroll
    for (int j = 0; j < 3; ++j) dir[j] = q[j];
#pragma unroll
    for (int j = 0; j < 6; ++j) fd[j] = q[3 + j];
#pragma unroll
    for (int j = 0; j < 15; ++j) y[j] = q[9 + j];
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
          float a = fd[0] * row[0];
#pragma unroll
          for (int j = 1; j < 6; ++j) a = a + fd[j] * row[j];
          float b = dir[0] * row[6];
          b = b + dir[1] * row[7];
          b = b + dir[2] * row[8];
          b = 2.f * b;
          const float cq = row[9];
          const float delta = b * b - (4.f * a) * cq;
          const float rho =
              delta > 0.f ? expf(b * b / (4.f * a) - (cq + 3.f)) : 0.f;
          const float alpha = row[10] * rho;
          float col[3];
#pragma unroll
          for (int ch = 0; ch < 3; ++ch) {
            const float* sh = row + 14 + 15 * ch;
            float acc = y[0] * sh[0];
#pragma unroll
            for (int j = 1; j < 15; ++j) acc = acc + y[j] * sh[j];
            col[ch] = row[11 + ch] + acc;
          }
          const float w = tr * alpha;
          rr = rr + w * col[0];
          rg = rg + w * col[1];
          rb = rb + w * col[2];
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

template <int K>
void launch(const float* packed, const int* cand, const int* counts,
            const float* pix, float* out_rad, float* out_trans, int* out_slot,
            int T, int C, int P, int depth, cudaStream_t stream) {
  const int threads = P < kThreads ? P : kThreads;
  peel_fwd_kernel<K><<<T, threads, 0, stream>>>(
      packed, cand, counts, pix, out_rad, out_trans, out_slot, C, P, depth);
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
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (C % kChunk != 0 || P < 1 || P > 1024 || depth < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (depth <= 8)
    launch<8>(packed, cand, counts, pix, out_rad, out_trans, out_slot, T, C,
              P, depth, s);
  else if (depth <= 16)
    launch<16>(packed, cand, counts, pix, out_rad, out_trans, out_slot, T, C,
               P, depth, s);
  else if (depth <= 32)
    launch<32>(packed, cand, counts, pix, out_rad, out_trans, out_slot, T, C,
               P, depth, s);
  else if (depth <= 64)
    launch<64>(packed, cand, counts, pix, out_rad, out_trans, out_slot, T, C,
               P, depth, s);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

// Ablations of the fused forward peel on Hopper (sm_90a).
//
// Replaces the pl.pallas_call of scripts/kprobe.py (_kernel, variants
// empty, intersect, merge_t1, shade_nomerge, shade_qa, shade_dots; its
// prod and prod_static are the production kernel itself, peel_fwd.cu,
// launched by the probe through rtgs_peel_fwd). Same geometry as the
// production kernel: one block per tile, one thread per pixel, the tile's
// candidate rows read from packed[cand[t, c]] with no (T, C, 64) gather,
// the swept prefix cut at counts[t]. Output (T, 4, P) f32: lane 0 of the
// (t1, qa, r, g) state each variant would carry:
//   empty         — pix lanes 0-3, plus 1e-30 × lane 0 of the tile's first
//                   candidate row in channel 0 (launch and write floor);
//   intersect     — min over the swept candidates of the float64 entry
//                   depth; channels 1-3 stay at the initial state
//                   (qa_init, 0, 0);
//   merge_t1      — the production sweep (sweep_topk: the f32 screen, the
//                   float64 chain on its survivors, the register merge):
//                   the nearest t1 in all four channels (a pixel with no
//                   hit: +inf, 0, 0, 0; a tile with no chunk keeps the
//                   initial state);
//   shade_nomerge — intersect, plus the whole f32 shading of every swept
//                   candidate, min-reduced into channel 1;
//   shade_qa      — intersect, plus the log-domain response only;
//   shade_dots    — intersect, plus the three SH dot products only.
// Channel 1 starts at qa_init, and a swept candidate that the ray misses
// contributes qa_miss to shade_nomerge's and shade_qa's reduction. The
// probe passes −inf for both, as the TPU state and its shading do, so the
// shade variants' channel 1 stays −inf: the variants differ in their work,
// not in their result. Both are arguments so that the compiler cannot fold
// the reduction away, and so that a check can pass +inf for both: channel 1
// is then the minimum of the shading terms over the candidates that hit
// (over every swept candidate for shade_dots), which a plain version can
// be held against.
//
// Bound: instruction throughput. intersect is the float64 chain of ~20 flops
// per (pixel, candidate); the shade variants add ~110 f32 flops and a
// log or exp per pair.

#include "peel_common.cuh"

namespace {

enum Variant {
  kEmpty, kIntersect, kMergeT1, kShadeNomerge, kShadeQa, kShadeDots
};

__device__ __forceinline__ void write4(float* out, int t, int P, int p,
                                       float c0, float c1, float c2,
                                       float c3) {
  float* o = out + static_cast<size_t>(t) * 4 * P + p;
  o[0] = c0;
  o[static_cast<size_t>(P)] = c1;
  o[static_cast<size_t>(2) * P] = c2;
  o[static_cast<size_t>(3) * P] = c3;
}

__global__ void __launch_bounds__(kThreads)
    empty_kernel(const float* __restrict__ packed,
                 const int* __restrict__ cand, const float* __restrict__ pix,
                 float* __restrict__ out, int C, int P, int n_sentinel) {
  const int t = blockIdx.x;
  const int id = cand[static_cast<size_t>(t) * C];
  const float f00 = packed[static_cast<size_t>(id >= 0 ? id : n_sentinel) * kFeat];
  for (int p = threadIdx.x; p < P; p += blockDim.x) {
    const float* q = pix + (static_cast<size_t>(t) * P + p) * kPixFeat;
    write4(out, t, P, p, q[0] + f00 * 1e-30f, q[1], q[2], q[3]);
  }
}

// Shared memory of sweep_kernel: lanes 0-9 of one chunk's rows, as float64.
struct ChainStage {
  double feat[kStage][kChunk];
  int live[kChunk];
};

// The float64 chain on every (pixel, candidate) pair, with no screen and no
// list: per pixel the minimum entry depth, and per variant a min-reduction
// of shading terms into acc.
template <int V>
__global__ void __launch_bounds__(kThreads)
    sweep_kernel(const float* __restrict__ packed,
                 const int* __restrict__ cand, const int* __restrict__ counts,
                 const float* __restrict__ pix, float* __restrict__ out,
                 int C, int P, float qa_init, float qa_miss) {
  __shared__ ChainStage st;
  __shared__ int s_id[kChunk];
  const int t = blockIdx.x;
  const int* cand_t = cand + static_cast<size_t>(t) * C;
  const int n_chunks = (counts[t] + kChunk - 1) / kChunk;

  for (int p0 = 0; p0 < P; p0 += blockDim.x) {
    const int p = p0 + threadIdx.x;
    const bool active = p < P;
    const float* q =
        pix + (static_cast<size_t>(t) * P + (active ? p : 0)) * kPixFeat;
    const Pixel px = load_pixel(q);
    const double d0 = q[0], d1 = q[1], d2 = q[2];
    const double f0 = q[3], f1 = q[4], f2 = q[5], f3 = q[6], f4 = q[7],
                 f5 = q[8];
    float tmin = CUDART_INF_F;
    float acc = qa_init;
    for (int c = 0; c < n_chunks; ++c) {
      __syncthreads();
      for (int e = threadIdx.x; e < kChunk * kStage; e += blockDim.x) {
        const int i = e / kStage;
        const int lane = e - i * kStage;
        const int id = cand_t[c * kChunk + i];
        if (lane == 0) {
          st.live[i] = id >= 0;
          s_id[i] = id;
        }
        st.feat[lane][i] =
            id >= 0 ? static_cast<double>(
                          packed[static_cast<size_t>(id) * kFeat + lane])
                    : 0.0;
      }
      __syncthreads();
      if (!active) continue;
      for (int i = 0; i < kChunk; ++i) {
        if (!st.live[i]) continue;
        double a = f0 * st.feat[0][i];
        a = a + f1 * st.feat[1][i];
        a = a + f2 * st.feat[2][i];
        a = a + f3 * st.feat[3][i];
        a = a + f4 * st.feat[4][i];
        a = a + f5 * st.feat[5][i];
        double b = d0 * st.feat[6][i];
        b = b + d1 * st.feat[7][i];
        b = b + d2 * st.feat[8][i];
        b = 2.0 * b;
        const double delta = b * b - (4.0 * a) * st.feat[9][i];
        bool hit = false;
        if (delta >= 0.0) {
          const double sq = sqrt(delta > 0.0 ? delta : 0.0);
          const double t1d = (-b - sq) / (2.0 * a);
          if (t1d > 0.0) {
            hit = true;
            tmin = fminf(tmin, static_cast<float>(t1d));
          }
        }
        if constexpr (V != kIntersect) {
          const float* row = packed + static_cast<size_t>(s_id[i]) * kFeat;
          if constexpr (V == kShadeNomerge || V == kShadeQa) {
            const Quad qd = quad(row, px);
            const float cq = row[9];
            const float d32 = qd.b * qd.b - (4.f * qd.a) * cq;
            float qa = qa_miss;
            if (hit && d32 > 0.f)
              qa = qd.b * qd.b / (4.f * qd.a) - (cq + 3.f) + logf(row[10]);
            if constexpr (V == kShadeNomerge)
              qa = qa + color(row, px, 0) + color(row, px, 1) +
                   color(row, px, 2);
            acc = fminf(acc, qa);
          } else {
#pragma unroll
            for (int ch = 0; ch < 3; ++ch)
              acc = fminf(acc, color(row, px, ch) - row[11 + ch]);
          }
        }
      }
    }
    if (active) write4(out, t, P, p, tmin, acc, 0.f, 0.f);
  }
}

template <int K>
__global__ void __launch_bounds__(kThreads)
    merge_kernel(const float* __restrict__ packed,
                 const int* __restrict__ cand, const int* __restrict__ counts,
                 const float* __restrict__ pix, float* __restrict__ out,
                 int C, int P, float qa_init) {
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
    const bool hit = kt[0] < CUDART_INF_F;
    const float pay = hit ? kt[0] : 0.f;
    if (n_chunks == 0)
      write4(out, t, P, p, CUDART_INF_F, qa_init, 0.f, 0.f);
    else
      write4(out, t, P, p, hit ? kt[0] : CUDART_INF_F, pay, pay, pay);
  }
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success). variant indexes
// rtgs_tpu_torch.probes.kprobe.KERNEL_VARIANTS. packed (N+1, 64) f32, cand
// (T, C) i32, counts (T,) i32, pix (T, P, 24) f32, out (T, 4, P) f32.
extern "C" int rtgs_probe_ablate(int variant, const float* packed,
                                 const int* cand, const int* counts,
                                 const float* pix, float* out, int T, int C,
                                 int P, int depth, int n_sentinel,
                                 float qa_init, float qa_miss, int device,
                                 void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (variant == kMergeT1)
    return launch_for_depth(device, C, P, depth, [&](auto cap) {
      merge_kernel<decltype(cap)::value><<<T, threads_for(P), 0, s>>>(
          packed, cand, counts, pix, out, C, P, qa_init);
    });
  const cudaError_t err = use_device(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (C % kChunk != 0 || C < kChunk || P < 1 || T < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int th = threads_for(P);
  switch (variant) {
    case kEmpty:
      empty_kernel<<<T, th, 0, s>>>(packed, cand, pix, out, C, P, n_sentinel);
      break;
    case kIntersect:
      sweep_kernel<kIntersect><<<T, th, 0, s>>>(packed, cand, counts, pix,
                                                out, C, P, qa_init, qa_miss);
      break;
    case kShadeNomerge:
      sweep_kernel<kShadeNomerge><<<T, th, 0, s>>>(packed, cand, counts, pix,
                                                   out, C, P, qa_init, qa_miss);
      break;
    case kShadeQa:
      sweep_kernel<kShadeQa><<<T, th, 0, s>>>(packed, cand, counts, pix, out,
                                              C, P, qa_init, qa_miss);
      break;
    case kShadeDots:
      sweep_kernel<kShadeDots><<<T, th, 0, s>>>(packed, cand, counts, pix,
                                                out, C, P, qa_init, qa_miss);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

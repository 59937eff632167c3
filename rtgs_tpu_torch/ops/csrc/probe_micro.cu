// Microbenchmark kernels of elementary operations at the peel kernels'
// launch shape, on Hopper (sm_90a).
//
// Replaces the kernel family of scripts/kmicro.py (make_raw,
// make_scratch16 and make_scratch: the three pl.pallas_call sites there,
// one launch shape here, the variant decides its shared memory). Every
// variant is a function (T, P, C) f32 -> (T, P, C) f32, one block per
// tile; the plain torch versions and the map from the TPU variant names
// are in rtgs_tpu_torch/probes/kmicro.py, whose VARIANTS order is the
// enum below.
//
// Mechanisms contrasted (what the TPU variants contrasted, in Hopper's
// terms): state in registers against state in shared memory
// (loop13_anywhen_reg / loop13_anywhen, merge16_loop_reg /
// merge16_loop_smem); a block-wide __syncthreads_or predicate against
// none (the same pairs, and any_when); a top-K merge by register insertion
// against a warp-shuffle bitonic network (merge16_loop_reg /
// merge16_loop_shfl); a row reduction by warp shuffles (min_reduce,
// matvec_ones, argmin_pass, concat144) against a column reduction by one
// thread per column (min_reduce_sub).
//
// Bound. Elementwise variants move 8 bytes per element and are bound by
// bytes (they read and write 16 bytes a thread where the tile's element
// count is a multiple of 4); the merges and the chunk body are bound by instruction throughput (the
// list insertion, the shuffles, the float64 entry depth of sweep_topk).
//
// Numerics: built with IEEE sqrt and division and --fmad=false, so a*m+b
// is a rounded product and a rounded sum, as in the plain versions.

#include "peel_common.cuh"

namespace {

enum Variant {
  kCopy, kMult, kChain10, kDiv, kSqrt, kExp, kExp2, kExpWhere, kMinReduce,
  kMinReduceSub, kAnyWhen, kAnyWhen8, kFori16, kFori128Tiny, kDynsliceSub,
  kArgminPass, kMatvecOnes, kRollSub16, kLoop13Static, kLoop13Dynslice,
  kLoop13Anywhen, kLoop13Full, kLoop13AnywhenReg, kConcat144, kMerge16,
  kMerge16LoopReg, kMerge16LoopShfl, kMerge16LoopSmem, kChunkbody,
  kNumVariants
};

constexpr int kK = 16;        // list capacity of the merge variants
constexpr int kLoops = 13;    // chunk-loop trip count of the TPU probes
constexpr int kWide = 6 * kK; // lanes of a dumped (t1, ord, 4 payloads) state
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float warp_min(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fminf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

// One compare-exchange step of a bitonic network across the lanes of a
// warp, on (t, s) pairs ordered lexicographically.
__device__ __forceinline__ void shfl_cmpx(float& t, int& s, int j,
                                          bool keep_min) {
  const float pt = __shfl_xor_sync(kFull, t, j);
  const int ps = __shfl_xor_sync(kFull, s, j);
  const bool mine_less = lex_less(t, s, pt, ps);
  if (keep_min != mine_less) {
    t = pt;
    s = ps;
  }
}

// Insert (t, s) into a sorted register list of kK pairs.
__device__ __forceinline__ void insert_reg(float (&kt)[kK], int (&ks)[kK],
                                           float t, int s) {
  if (!lex_less(t, s, kt[kK - 1], ks[kK - 1])) return;
  float ct = t;
  int cs = s;
#pragma unroll
  for (int k = 0; k < kK; ++k) {
    const bool lt = lex_less(ct, cs, kt[k], ks[k]);
    const float tk = kt[k];
    const int sk = ks[k];
    kt[k] = lt ? ct : tk;
    ks[k] = lt ? cs : sk;
    ct = lt ? tk : ct;
    cs = lt ? sk : cs;
  }
}

// The dumped state of a merge loop over chunk c = slot / 128, lane
// i = slot % 128: t1 = v[i]·(1+c), ord = slot, payload j = v[i]·(1+j+c).
__device__ __forceinline__ void dump_merge_state(const float* xrow,
                                                 float* orow, int k, float t,
                                                 int s) {
  const bool hit = t < CUDART_INF_F;
  orow[k] = hit ? t : CUDART_INF_F;
  orow[kK + k] = hit ? static_cast<float>(s) : CUDART_INF_F;
  const int c = hit ? s / kChunk : 0;
  const float v = hit ? xrow[s % kChunk] : 0.f;
#pragma unroll
  for (int j = 1; j <= 4; ++j)
    orow[(1 + j) * kK + k] = hit ? v * (1.f + j + c) : 0.f;
}

// One element of an elementwise variant.
template <int V>
__device__ __forceinline__ float elementwise(float v) {
  float r = v;
  if constexpr (V == kMult) r = v * 1.0001f;
  if constexpr (V == kChain10) {
#pragma unroll
    for (int i = 0; i < 10; ++i) r = r * 1.0001f + 1e-9f;
  }
  if constexpr (V == kFori16) {
    for (int i = 0; i < 16; ++i) r = r * 1.0001f + 1e-9f;
  }
  if constexpr (V == kDiv) r = 1.0f / v;
  if constexpr (V == kSqrt) r = sqrtf(v);
  if constexpr (V == kExp) r = expf(v);
  if constexpr (V == kExp2) r = exp2f(v);
  if constexpr (V == kExpWhere) r = v > 1.0f ? expf(v) : 0.f;
  return r;
}

template <int V>
__global__ void __launch_bounds__(kThreads)
    micro_kernel(const float* __restrict__ x, float* __restrict__ out, int P,
                 int C, const float* __restrict__ packed,
                 const int* __restrict__ cand, const float* __restrict__ pix) {
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x;
  const int nthr = blockDim.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarp = nthr >> 5;
  const size_t base = static_cast<size_t>(blockIdx.x) * P * C;
  const float* xt = x + base;
  float* ot = out + base;
  const int n = P * C;

  if constexpr (V <= kExpWhere || V == kFori16) {
    // Streaming: 16-byte loads and stores a thread where the tile's element
    // count allows (the tile then starts on a 16-byte boundary too).
    if ((n & 3) == 0) {
      const float4* x4 = reinterpret_cast<const float4*>(xt);
      float4* o4 = reinterpret_cast<float4*>(ot);
      for (int e = tid; e < n / 4; e += nthr) {
        const float4 v = x4[e];
        o4[e] = make_float4(elementwise<V>(v.x), elementwise<V>(v.y),
                            elementwise<V>(v.z), elementwise<V>(v.w));
      }
    } else {
      for (int e = tid; e < n; e += nthr) ot[e] = elementwise<V>(xt[e]);
    }
  } else if constexpr (V == kMinReduce || V == kConcat144 ||
                       V == kMatvecOnes || V == kArgminPass) {
    // One warp per pixel row; the lanes stride the row, then shuffle.
    for (int p = warp; p < P; p += nwarp) {
      const float* xr = xt + static_cast<size_t>(p) * C;
      float* orow = ot + static_cast<size_t>(p) * C;
      if constexpr (V == kMatvecOnes) {
        float s = 0.f;
        for (int c = lane; c < C; c += 32) s = s + xr[c];
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) s = s + __shfl_xor_sync(kFull, s, o);
        for (int c = lane; c < C; c += 32) orow[c] = c < 8 ? s : xr[c];
      } else if constexpr (V == kArgminPass) {
        float m = CUDART_INF_F;
        int mi = INT_MAX;
        for (int c = lane; c < C; c += 32)
          if (lex_less(xr[c], c, m, mi)) {
            m = xr[c];
            mi = c;
          }
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) {
          const float pm = __shfl_xor_sync(kFull, m, o);
          const int pi = __shfl_xor_sync(kFull, mi, o);
          if (lex_less(pm, pi, m, mi)) {
            m = pm;
            mi = pi;
          }
        }
        // Six extract sums of the first minimum, the field scaled by
        // 1.0001 between them.
        float acc = 0.f, w = m;
        if (m < CUDART_INF_F) {
          for (int i = 0; i < 6; ++i) {
            acc = acc + w;
            w = w * 1.0001f;
          }
        }
        for (int c = lane; c < C; c += 32) orow[c] = c == 0 ? acc : xr[c];
      } else {
        float m = CUDART_INF_F;
        for (int c = lane; c < C; c += 32) m = fminf(m, xr[c]);
        m = warp_min(m);
        for (int c = lane; c < C; c += 32) {
          if constexpr (V == kMinReduce)
            orow[c] = m;
          else
            orow[c] = c == 0 ? m : xr[c] * 1.0001f;
        }
      }
    }
  } else if constexpr (V == kMinReduceSub) {
    // One thread per column; smem holds the C column minima.
    for (int c = tid; c < C; c += nthr) {
      float m = CUDART_INF_F;
      for (int p = 0; p < P; ++p) m = fminf(m, xt[static_cast<size_t>(p) * C + c]);
      smem[c] = m;
    }
    __syncthreads();
    for (int e = tid; e < n; e += nthr) ot[e] = smem[e % C];
  } else if constexpr (V == kAnyWhen) {
    bool mine = false;
    for (int e = tid; e < n; e += nthr) mine |= xt[e] < 0.5f;
    const float f = __syncthreads_or(mine) ? 2.0f : 1.0f;
    for (int e = tid; e < n; e += nthr) ot[e] = xt[e] * f;
  } else if constexpr (V == kAnyWhen8) {
    unsigned mine = 0;
    for (int e = tid; e < n; e += nthr) {
      const float v = xt[e];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        mine |= (v < static_cast<float>(0.1 * i)) ? (1u << i) : 0u;
    }
    float f = 1.0f;  // the last predicated block that fires wins
#pragma unroll
    for (int i = 0; i < 8; ++i)
      if (__syncthreads_or(mine & (1u << i))) f = 1.0f + i;
    for (int e = tid; e < n; e += nthr) ot[e] = xt[e] * f;
  } else if constexpr (V == kFori128Tiny) {
    for (int e = tid; e < n; e += nthr) {
      float r = xt[e];
      if (e < 8 * C)
        for (int i = 0; i < 128; ++i) r = r * 1.0001f;
      ot[e] = r;
    }
  } else if constexpr (V == kDynsliceSub) {
    for (int e = tid; e < n; e += nthr) {
      float r = xt[e];
      if (e < C) {
        r = 0.f;
        for (int i = 0; i < 128; ++i)
          r = r + xt[static_cast<size_t>(i % P) * C + e];
      }
      ot[e] = r;
    }
  } else if constexpr (V == kRollSub16) {
    for (int e = tid; e < n; e += nthr) {
      const int p = e / C, c = e - p * C;
      float m = xt[e];
      for (int d = 1; d <= 16; ++d) {
        const int q = ((p - d) % P + P) % P;
        m = fminf(m, xt[static_cast<size_t>(q) * C + c]);
      }
      ot[e] = m;
    }
  } else if constexpr (V == kLoop13Static || V == kLoop13Dynslice) {
    constexpr int off = V == kLoop13Dynslice ? 16 : 0;
    for (int e = tid; e < n; e += nthr) {
      float r = xt[e];
      if (e < 32 * C) {
        r = 0.f;
        for (int c = 0; c < kLoops; ++c)
          r = r + xt[static_cast<size_t>(c) * off * C + e] * 1.0001f;
      }
      ot[e] = r;
    }
  } else if constexpr (V == kLoop13AnywhenReg) {
    for (int e = tid; e < n; e += nthr) {
      float r = xt[e];
      if (e < 8 * C) {
        r = 0.f;
        for (int c = 0; c < kLoops; ++c) r = fmaxf(r, xt[e] * (1.0f + c));
      }
      ot[e] = r;
    }
  } else if constexpr (V == kLoop13Anywhen || V == kLoop13Full) {
    // Running maximum in shared memory (8·C floats), updated only when a
    // block-wide vote finds an element above it.
    constexpr int off = V == kLoop13Full ? 16 : 0;
    const int m = 8 * C;
    for (int e = tid; e < m; e += nthr) smem[e] = 0.f;
    __syncthreads();
    for (int c = 0; c < kLoops; ++c) {
      bool mine = false;
      for (int e = tid; e < m; e += nthr)
        mine |= xt[static_cast<size_t>(c) * off * C + e] * (1.0f + c) > smem[e];
      if (!__syncthreads_or(mine)) continue;
      for (int e = tid; e < m; e += nthr)
        smem[e] = fmaxf(smem[e],
                        xt[static_cast<size_t>(c) * off * C + e] * (1.0f + c));
      __syncthreads();
    }
    for (int e = tid; e < n; e += nthr) ot[e] = e < m ? smem[e] : xt[e];
  } else if constexpr (V == kMerge16) {
    // One merge of a 16-lane state (the row's first 16 values) with the
    // 128-lane chunk (the row): one thread per pixel, register insertion
    // in lane order of the 144-lane concatenation.
    for (int p = tid; p < P; p += nthr) {
      const float* xr = xt + static_cast<size_t>(p) * C;
      float* orow = ot + static_cast<size_t>(p) * C;
      float kt[kK];
      int ks[kK];
#pragma unroll
      for (int k = 0; k < kK; ++k) {
        kt[k] = CUDART_INF_F;
        ks[k] = INT_MAX;
      }
      for (int i = 0; i < kK; ++i) insert_reg(kt, ks, xr[i], i);
      for (int i = 0; i < C; ++i) insert_reg(kt, ks, xr[i], kK + i);
      for (int c = 2 * kK; c < C; ++c) orow[c] = xr[c] * 1.0001f;
#pragma unroll
      for (int k = 0; k < kK; ++k) {
        const bool hit = kt[k] < CUDART_INF_F;
        orow[k] = kt[k];
        orow[kK + k] = hit ? kt[k] * 2.0f : 0.f;
      }
    }
  } else if constexpr (V == kMerge16LoopReg) {
    for (int p = tid; p < P; p += nthr) {
      const float* xr = xt + static_cast<size_t>(p) * C;
      float* orow = ot + static_cast<size_t>(p) * C;
      float kt[kK];
      int ks[kK];
#pragma unroll
      for (int k = 0; k < kK; ++k) {
        kt[k] = CUDART_INF_F;
        ks[k] = INT_MAX;
      }
      for (int c = 0; c < kLoops; ++c)
        for (int i = 0; i < kChunk; ++i)
          insert_reg(kt, ks, xr[i] * (1.0f + c), c * kChunk + i);
      for (int c = kWide; c < C; ++c) orow[c] = xr[c] * 1.0001f;
#pragma unroll
      for (int k = 0; k < kK; ++k) dump_merge_state(xr, orow, k, kt[k], ks[k]);
    }
  } else if constexpr (V == kMerge16LoopSmem) {
    // The list lives in shared memory, [k][thread] (conflict-free), and a
    // chunk is merged only when the block votes that some pixel has a
    // candidate below its K-th entry.
    float* s_t = smem;
    int* s_s = reinterpret_cast<int*>(smem + kK * nthr);
    for (int p0 = 0; p0 < P; p0 += nthr) {
      const int p = p0 + tid;
      const bool active = p < P;
      const float* xr = xt + static_cast<size_t>(active ? p : 0) * C;
      for (int k = 0; k < kK; ++k) {
        s_t[k * nthr + tid] = CUDART_INF_F;
        s_s[k * nthr + tid] = INT_MAX;
      }
      for (int c = 0; c < kLoops; ++c) {
        const float kth = s_t[(kK - 1) * nthr + tid];
        bool mine = false;
        if (active)
          for (int i = 0; i < kChunk; ++i) mine |= xr[i] * (1.0f + c) < kth;
        if (!__syncthreads_or(mine)) continue;
        if (!active) continue;
        for (int i = 0; i < kChunk; ++i) {
          float ct = xr[i] * (1.0f + c);
          int cs = c * kChunk + i;
          if (!lex_less(ct, cs, s_t[(kK - 1) * nthr + tid],
                        s_s[(kK - 1) * nthr + tid]))
            continue;
          for (int k = 0; k < kK; ++k) {
            const float tk = s_t[k * nthr + tid];
            const int sk = s_s[k * nthr + tid];
            if (lex_less(ct, cs, tk, sk)) {
              s_t[k * nthr + tid] = ct;
              s_s[k * nthr + tid] = cs;
              ct = tk;
              cs = sk;
            }
          }
        }
      }
      if (active) {
        float* orow = ot + static_cast<size_t>(p) * C;
        for (int c = kWide; c < C; ++c) orow[c] = xr[c] * 1.0001f;
        for (int k = 0; k < kK; ++k)
          dump_merge_state(xr, orow, k, s_t[k * nthr + tid],
                           s_s[k * nthr + tid]);
      }
    }
  } else if constexpr (V == kMerge16LoopShfl) {
    // One warp per pixel row. The sorted list sits in lanes 0-15 (lanes
    // 16-31 vacant). Each group of 32 candidates is sorted across the
    // lanes by a bitonic network of shuffles; its 16 smallest, reversed
    // into lanes 16-31, make a bitonic sequence with the list, and one
    // bitonic merge leaves the new list in lanes 0-15.
    for (int p = warp; p < P; p += nwarp) {
      const float* xr = xt + static_cast<size_t>(p) * C;
      float* orow = ot + static_cast<size_t>(p) * C;
      float lt = CUDART_INF_F;
      int ls = INT_MAX;
      for (int c = 0; c < kLoops; ++c) {
        for (int j = 0; j < kChunk / 32; ++j) {
          const int i = j * 32 + lane;
          float t = xr[i] * (1.0f + c);
          int s = c * kChunk + i;
#pragma unroll
          for (int k = 2; k <= 32; k <<= 1)
#pragma unroll
            for (int h = k >> 1; h > 0; h >>= 1)
              shfl_cmpx(t, s, h, ((lane & k) == 0) == ((lane & h) == 0));
          const float rt = __shfl_sync(kFull, t, 31 - lane);
          const int rs = __shfl_sync(kFull, s, 31 - lane);
          if (lane >= kK) {
            lt = rt;
            ls = rs;
          }
#pragma unroll
          for (int h = 16; h > 0; h >>= 1)
            shfl_cmpx(lt, ls, h, (lane & h) == 0);
          if (lane >= kK) {
            lt = CUDART_INF_F;
            ls = INT_MAX;
          }
        }
      }
      for (int c = kWide + lane; c < C; c += 32) orow[c] = xr[c] * 1.0001f;
      if (lane < kK) dump_merge_state(xr, orow, lane, lt, ls);
    }
  } else if constexpr (V == kChunkbody) {
    // The production chunk body 13 times: the float64 entry-depth sweep
    // with register insertion (sweep_topk), then the K winners shaded in
    // the log domain, qa = B²/4A − (c0+3) + log(op), and their colors.
    // packed, cand and pix are views of x that the wrapper lays out: row
    // r of packed is x[t, p, 0:64], chunk c of cand the 128 rows from
    // (c % 2)·64, pix x[t, p, 0:24].
    SweepStage& stage = *reinterpret_cast<SweepStage*>(smem);
    const int t = blockIdx.x;
    const int* cand_t = cand + static_cast<size_t>(t) * kLoops * kChunk;
    for (int p0 = 0; p0 < P; p0 += nthr) {
      const int p = p0 + tid;
      const bool active = p < P;
      const float* q =
          pix + (static_cast<size_t>(t) * P + (active ? p : 0)) * kPixFeat;
      float kt[kK];
      int ks[kK];
      sweep_topk<kK>(packed, cand_t, kLoops, active, q, stage, kt, ks);
      if (!active) continue;
      const Pixel px = load_pixel(q);
      const float* xr = xt + static_cast<size_t>(p) * C;
      float* orow = ot + static_cast<size_t>(p) * C;
      for (int c = kWide; c < C; ++c) orow[c] = xr[c] * 1.0001f;
#pragma unroll
      for (int k = 0; k < kK; ++k) {
        const bool hit = kt[k] < CUDART_INF_F;
        float qa = -CUDART_INF_F, r = 0.f, g = 0.f, b = 0.f;
        if (hit) {
          const float* row =
              packed + static_cast<size_t>(cand_t[ks[k]]) * kFeat;
          const Quad qd = quad(row, px);
          const float cq = row[9];
          const float delta = qd.b * qd.b - (4.f * qd.a) * cq;
          if (delta > 0.f)
            qa = qd.b * qd.b / (4.f * qd.a) - (cq + 3.f) + logf(row[10]);
          r = color(row, px, 0);
          g = color(row, px, 1);
          b = color(row, px, 2);
        }
        orow[k] = hit ? kt[k] : CUDART_INF_F;
        orow[kK + k] = hit ? static_cast<float>(ks[k]) : CUDART_INF_F;
        orow[2 * kK + k] = qa;
        orow[3 * kK + k] = r;
        orow[4 * kK + k] = g;
        orow[5 * kK + k] = b;
      }
    }
  }
}

template <int V>
int launch_variant(int variant, const float* x, float* out, int T, int P,
                   int C, const float* packed, const int* cand,
                   const float* pix, cudaStream_t s) {
  if constexpr (V == kNumVariants) {
    return static_cast<int>(cudaErrorInvalidValue);
  } else {
    if (variant != V)
      return launch_variant<V + 1>(variant, x, out, T, P, C, packed, cand,
                                   pix, s);
    size_t shm = 0;
    if (V == kMinReduceSub) shm = sizeof(float) * C;
    if (V == kLoop13Anywhen || V == kLoop13Full) shm = sizeof(float) * 8 * C;
    if (V == kMerge16LoopSmem) shm = 2 * sizeof(float) * kK * kThreads;
    if (V == kChunkbody) shm = sizeof(SweepStage);
    if (shm > 48 * 1024) {
      const cudaError_t err = cudaFuncSetAttribute(
          micro_kernel<V>, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(shm));
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    micro_kernel<V><<<T, kThreads, shm, s>>>(x, out, P, C, packed, cand, pix);
    return static_cast<int>(cudaGetLastError());
  }
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success). x and out are
// (T, P, C) f32. variant indexes rtgs_tpu_torch.probes.kmicro.VARIANTS.
// The merge variants need C == 128 and P·C ≥ the rows they read (checked
// by the wrapper); chunkbody also takes packed (T·P, 64) f32, cand
// (T, 13·128) i32 and pix (T, P, 24) f32, which are null otherwise.
extern "C" int rtgs_probe_micro(int variant, const float* x, float* out,
                                int T, int P, int C, const float* packed,
                                const int* cand, const float* pix, int device,
                                void* stream) {
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (T < 1 || P < 1 || C < 1) return static_cast<int>(cudaErrorInvalidValue);
  return launch_variant<0>(variant, x, out, T, P, C, packed, cand, pix,
                           static_cast<cudaStream_t>(stream));
}

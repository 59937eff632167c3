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
// The deep pass (K = 32, 64: depth > 16): a lane pair a pixel. One thread
// holding a list of 64 (t1, slot) pairs pins 128 registers to it, and the
// one-thread body ran there at 252 registers, one block of 256 threads (8
// warps) an SM. Here blocks are 512 threads, a pixel group's 256 pixels as
// 256 lane pairs (lane ^ 1): the even lane holds the front half of the
// sorted list (positions [0, K/2)), the odd lane the back half, each in
// registers with compile-time indices; at K = 64 the kernel fits 128
// registers a thread with no spill, one block of 16 warps an SM (115 at
// K = 32). Each lane screens and chains alternate candidates of a batch
// (sweep_chunk_pair). A round inserts both lanes' hits: the front lane takes
// its own hit, then its partner's, with a compare-exchange pass over its
// K/2 pairs each time, and each pair it lets go goes by shuffle to the back
// lane, which inserts it the same way one step later (insert_pair_round).
// The slots are distinct, so the list is the K least (t1, slot) pairs
// whatever the order of insertion: bitwise the one-thread list, ties in t1
// included. Shading: in step j the even lane shades layer 2j and the odd
// lane layer 2j + 1; the two swap their α and rgb by shuffle and both run
// the composite over 2j, then 2j + 1, with the one-thread body's operations
// in its order, so radiance and transmittance are bitwise the same too.
//
// What bounds the deep pass on an H100 (the busiest band of the 1M @
// 1920x1088 frame: 1,020 tiles of 1,730 slots on average, 873 of them past
// the 416 that shading stages; device ms of one K = 64 launch). The
// one-thread body: 3.85. Lane pairs alone: 3.82, so 16 warps an SM buy
// ~1%: the pass is bound by instruction throughput, not by latency. Their
// split: screen, staging and float64 chain 1.32 (the pass without its
// insertions), the insertions 0.80, shading 1.70, most of it 59 4-byte
// loads a layer from rows that lie in the table (a warp's 32 lanes read 32
// rows). So a layer whose row lies in the table is shaded from its 15
// 16-byte words (shade_table_row): 2.74 in all, −29%; a chain of two passes
// to depth 128 7.85 → 5.47. What is left is mostly the sweep, which does
// not depend on K (a whole K = 16 pass takes 1.26), and the insertions,
// which stop where every lane of the warp carries a vacant pair.
//
// Numerics as peel_common.cuh. No atomics: the output is bitwise
// deterministic.

#include "peel_common.cuh"

namespace {

// ---------------------------------------------------------------------------
// The deep pass: a lane pair a pixel (see the note at the top).

// Capacities that take the pair layout.
template <int K>
constexpr bool kPairs = K > 16;

constexpr int kPairThreads = 2 * kThreads;  // a pixel group's lane pairs
constexpr unsigned kWarpMask = 0xffffffffu;
// Between its sweep and its shading a pixel group's list slots wait in
// shared memory behind the staged rows, entry k of thread l at
// k·kSlotStride + l (an odd stride: a warp's 32 reads fall on 32 banks),
// not in 32 registers a thread: with them the shading spilled (173 KB a
// block in all, one block an SM as the registers allow).
constexpr int kSlotStride = kPairThreads + 1;
constexpr int kPairShadeBytes =
    kShadeBytes + kMaxDepth / 2 * kSlotStride * sizeof(int);

// Threads of a pair block for P pixels a tile: two a pixel of a group, in
// whole warps (a lane past the tile's pixels is an inactive pixel's).
inline int pair_threads_for(int P) {
  return (2 * threads_for(P) + 31) / 32 * 32;
}

// The entry depth of a staged row against the pixel: sweep_chunk's float64
// chain, operation for operation; false for a padding slot, a miss or a hit
// at t1 ≤ 0. The pixel's f32 lanes are widened here (exactly), so no float64
// copy of them holds registers through the sweep.
__device__ __forceinline__ double wide(float x) {
  return static_cast<double>(x);
}

__device__ __forceinline__ bool entry_t1(const ScreenRow& row,
                                         const SweepPixel& px, float& t1) {
  if (row.id < 0) return false;  // padding: never a hit
  double a = wide(px.fd[0]) * wide(row.m[0]);
  a = a + wide(px.fd[1]) * wide(row.m[1]);
  a = a + wide(px.fd[2]) * wide(row.m[2]);
  a = a + wide(px.fd[3]) * wide(row.m[3]);
  a = a + wide(px.fd[4]) * wide(row.m[4]);
  a = a + wide(px.fd[5]) * wide(row.m[5]);
  double b = wide(px.d[0]) * wide(row.m[6]);
  b = b + wide(px.d[1]) * wide(row.m[7]);
  b = b + wide(px.d[2]) * wide(row.m[8]);
  b = 2.0 * b;
  const double delta = b * b - (4.0 * a) * wide(row.m[9]);
  if (!(delta >= 0.0)) return false;  // miss (or NaN)
  const double sq = sqrt(delta > 0.0 ? delta : 0.0);
  const double t1d = (-b - sq) / (2.0 * a);
  if (!(t1d > 0.0)) return false;
  t1 = static_cast<float>(t1d);
  return true;
}

// Where a pixel's floor lies (load_floor's arguments). The deep pass reads
// it at each hit that would enter the list, not once into two registers
// held through the sweep: with them the sweep spilled.
struct FloorAt {
  const float* t1;
  const int* key;
  size_t i;
};

// Whether (t1, key) lies after the floor at f: an earlier pass listed the
// rest.
__device__ __forceinline__ bool after_floor(const FloorAt& f, float t1,
                                            int key) {
  const Floor fl = load_floor(f.t1, f.key, f.i);
  return lex_less(fl.t1, fl.key, t1, key);
}

// Insert (ct, cs) into this lane's sorted half of the list with one
// compare-exchange pass; (ct, cs) leaves as the pair that falls off the
// half's end (itself where it orders after the whole half). The warp skips
// the pass where no lane's pair enters its half: each pair is then its own
// leaver. Once a lane carries a vacant pair, the rest of its pass changes
// nothing (the entries after it are vacant too): the warp stops where every
// lane does, looked at every 8 entries.
template <int H>
__device__ __forceinline__ void insert_half(float (&kt)[H], int (&ks)[H],
                                            float& ct, int& cs) {
  if (!__any_sync(kWarpMask, lex_less(ct, cs, kt[H - 1], ks[H - 1]))) return;
#pragma unroll
  for (int k = 0; k < H; ++k) {
    if (k > 0 && k % 8 == 0 && !__any_sync(kWarpMask, cs != INT_MAX)) return;
    const bool lt = lex_less(ct, cs, kt[k], ks[k]);
    const float tk = kt[k];
    const int sk = ks[k];
    kt[k] = lt ? ct : tk;
    ks[k] = lt ? cs : sk;
    ct = lt ? tk : ct;
    cs = lt ? sk : cs;
  }
}

// One round of a pair's insertions, every lane of the warp together. In:
// (xt, xk), this lane's hit of the round or (+inf, INT_MAX); (pt, pk), on
// the back lane, the pair the front half let go in the round before, still
// to insert (out: the one it lets go in this round). Step 1: the front lane
// inserts its own hit while the back lane inserts (pt, pk); step 2: the
// front lane inserts the back lane's hit while the back lane inserts what
// step 1 let go of the front half. What leaves the back half lies past the
// list's K pairs and is dropped.
template <int H>
__device__ __forceinline__ void insert_pair_round(float (&kt)[H],
                                                  int (&ks)[H], float xt,
                                                  int xk, float& pt, int& pk) {
  const bool back = threadIdx.x & 1;
  const int front = threadIdx.x & 30;  // the pair's front lane
  const float yt = __shfl_xor_sync(kWarpMask, xt, 1);
  const int yk = __shfl_xor_sync(kWarpMask, xk, 1);
  float ct = back ? pt : xt;
  int cs = back ? pk : xk;
  insert_half(kt, ks, ct, cs);
  const float ft = __shfl_sync(kWarpMask, ct, front);
  const int fk = __shfl_sync(kWarpMask, cs, front);
  ct = back ? ft : yt;
  cs = back ? fk : yk;
  insert_half(kt, ks, ct, cs);
  pt = __shfl_sync(kWarpMask, ct, front);
  pk = __shfl_sync(kWarpMask, cs, front);
}

// sweep_chunk for a lane pair: lane h (0 front, 1 back) screens candidates
// i0 + 2j + h of each batch of kBatch, and in each round every lane runs
// one of its survivors through the float64 chain; the pair's hits that lie
// after the floor and before the list's last pair go into the list
// (insert_pair_round). That last pair is read from the back lane at the
// start of each round: the pending leaver can only lower the list's true
// last pair, so the test admits every hit that can enter. Every lane of the
// block calls this (an inactive pixel's lanes take part with no survivor).
// At K = 64 the screen is unrolled 8 candidates deep, not 16: with 64 list
// registers pinned, the deeper unroll spilled.
template <int H, bool kCount>
__device__ __forceinline__ void sweep_chunk_pair(
    const SweepStage& st, int slot_base, const SweepPixel& px,
    const FloorAt& fl, bool active, float (&kt)[H], int (&ks)[H], float& pt,
    int& pk, unsigned long long& n_pairs, unsigned long long& n_rejected) {
  constexpr int kUnroll = H > 16 ? 8 : kBatch / 2;
  const int h = threadIdx.x & 1;
  const int back = (threadIdx.x & 30) + 1;  // the pair's back lane
  for (int i0 = 0; i0 < kChunk; i0 += kBatch) {
    unsigned pending = 0;
    if (active) {
#pragma unroll kUnroll
      for (int j = 0; j < kBatch / 2; ++j) {
        const ScreenRow& row = st.row[i0 + 2 * j + h];
        const float4* rp = reinterpret_cast<const float4*>(&row);
        const bool rejected =
            screen_rejects(px.d, px.fd, rp[0], rp[1], rp[2]);
        pending |= static_cast<unsigned>(!rejected) << j;
        if (kCount) {
          const int live = row.id >= 0;
          n_pairs += live;
          n_rejected += live && rejected;
        }
      }
    }
    while (__any_sync(kWarpMask, pending)) {
      const float lt = __shfl_sync(kWarpMask, kt[H - 1], back);
      const int lk = __shfl_sync(kWarpMask, ks[H - 1], back);
      float xt = CUDART_INF_F;
      int xk = INT_MAX;
      if (pending) {
        const int i = i0 + 2 * (__ffs(pending) - 1) + h;
        pending &= pending - 1;
        float t1;
        const int key = slot_base + i;
        // A hit before the list's last pair and after the floor.
        if (entry_t1(st.row[i], px, t1) && lex_less(t1, key, lt, lk) &&
            after_floor(fl, t1, key)) {
          xt = t1;
          xk = key;
        }
      }
      insert_pair_round(kt, ks, xt, xk, pt, pk);
    }
  }
}

// sweep_topk for a lane pair: the pixel's K = 2H nearest hits after the
// floor, the front lane holding positions [0, H) of the sorted list and the
// back lane [H, 2H). Every entry of the front half orders before every
// entry of the back half, and the two are the K least (t1, slot) pairs of
// the hits, sweep_topk's one list: the slots are distinct, so the order is
// total and the order of insertion cannot change the result.
template <int H, bool kCount>
__device__ __forceinline__ void sweep_topk_pair(
    const float* __restrict__ packed, const int* __restrict__ cand_t,
    int n_chunks, bool active, const float* q, SweepStage& st,
    float (&kt)[H], int (&ks)[H], const FloorAt& fl,
    unsigned long long& n_pairs, unsigned long long& n_rejected) {
  const SweepPixel px = load_sweep_pixel(q);
  clear_list(kt, ks);
  float pt = CUDART_INF_F;
  int pk = INT_MAX;
  stage_pixel_max(st, q);
  for (int c = 0; c < n_chunks; ++c) {
    __syncthreads();
    stage_chunk(st, packed, cand_t, c);
    __syncthreads();
    sweep_chunk_pair<H, kCount>(st, c * kChunk, px, fl, active, kt, ks, pt,
                                pk, n_pairs, n_rejected);
  }
  // The front half's last leaver into the back half.
  const bool back = threadIdx.x & 1;
  float ct = back ? pt : CUDART_INF_F;
  int cs = back ? pk : INT_MAX;
  insert_half(kt, ks, ct, cs);
}

// α and rgb of a winner whose row lies in the table, as quad() and color()
// give them, from the row's 15 16-byte words (rows are 256-byte aligned)
// read in order: a shaded layer costs 15 loads, not 59.
__device__ __forceinline__ void shade_table_row(const float* row,
                                                const Pixel& px, float& alpha,
                                                float& cr, float& cg,
                                                float& cb) {
  const float4* r4 = reinterpret_cast<const float4*>(row);
  const float4 w0 = __ldg(r4), w1 = __ldg(r4 + 1), w2 = __ldg(r4 + 2);
  float a = px.fd[0] * w0.x;
  a = a + px.fd[1] * w0.y;
  a = a + px.fd[2] * w0.z;
  a = a + px.fd[3] * w0.w;
  a = a + px.fd[4] * w1.x;
  a = a + px.fd[5] * w1.y;
  float b = px.dir[0] * w1.z;
  b = b + px.dir[1] * w1.w;
  b = b + px.dir[2] * w2.x;
  b = 2.f * b;
  const float cq = w2.y;
  const float delta = b * b - (4.f * a) * cq;
  const float rho = delta > 0.f ? expf(b * b / (4.f * a) - (cq + 3.f)) : 0.f;
  alpha = w2.z * rho;
  // Lanes 11:14 are the colors' bases, 14 + 15·ch + j the SH coefficients:
  // each channel's sum runs over j in order, as in color().
  float base[3] = {w2.w, 0.f, 0.f}, acc[3] = {0.f, 0.f, 0.f};
#pragma unroll
  for (int w = 3; w < 15; ++w) {
    const float4 q = __ldg(r4 + w);
    const float lane[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int l = 4 * w + e;
      if (l < 14) {
        base[l - 11] = lane[e];
      } else if (l < kLanes) {
        const int ch = (l - 14) / 15, j = (l - 14) % 15;
        acc[ch] = j == 0 ? px.y[0] * lane[e] : acc[ch] + px.y[j] * lane[e];
      }
    }
  }
  cr = base[0] + acc[0];
  cg = base[1] + acc[1];
  cb = base[2] + acc[2];
}

// The kernel's body at K = 2H: sweep, shade and composite as the
// one-thread body does. Shading: in step j the front lane shades layer 2j
// and the back lane layer 2j + 1 (the slot read from where the lane that
// held it left it); the two swap their α and rgb, and both run the
// composite over layer 2j, then 2j + 1, in the one-thread body's
// operations.
template <int H, bool kCount>
__device__ __forceinline__ void peel_pixel_pairs(
    SweepStage& stage, float* s_rows, const float* __restrict__ packed,
    const int* __restrict__ cand, const int* __restrict__ counts,
    const float* __restrict__ pix, const float* __restrict__ floor_t1,
    const int* __restrict__ floor_slot, float* __restrict__ out_rad,
    float* __restrict__ out_trans, int* __restrict__ out_slot,
    float* __restrict__ out_last_t1,
    unsigned long long* __restrict__ screen_counts, int C, int P,
    int depth) {
  static_assert(H % 2 == 0, "a step's two layers lie in one half");
  const int t = blockIdx.x;
  const int* cand_t = cand + static_cast<size_t>(t) * C;
  const int n_chunks = (counts[t] + kChunk - 1) / kChunk;
  const bool staged = stage_tile_rows(s_rows, packed, cand_t, counts[t]);
  const int h = threadIdx.x & 1;
  const int front = threadIdx.x & 30;
  int* slots = reinterpret_cast<int*>(s_rows + kShadeRows * kRowStride);
  unsigned long long n_pairs = 0, n_rejected = 0;

  for (int p0 = 0; p0 < P; p0 += blockDim.x / 2) {
    const int p = p0 + (threadIdx.x >> 1);
    const bool active = p < P;
    const size_t tp = static_cast<size_t>(t) * P + (active ? p : 0);
    const float* q = pix + tp * kPixFeat;
    float kt[H];
    int ks[H];
    sweep_topk_pair<H, kCount>(packed, cand_t, n_chunks, active, q, stage,
                               kt, ks, FloorAt{floor_t1, floor_slot, tp},
                               n_pairs, n_rejected);

    // Each entry's slot (−1 vacant) into shared memory, and the last
    // layer's t1 from the lane that holds it.
    float last = CUDART_INF_F;
#pragma unroll
    for (int k = 0; k < H; ++k) {
      const bool hit = kt[k] < CUDART_INF_F;
      if (h * H + k == depth - 1 && hit) last = kt[k];
      slots[k * kSlotStride + threadIdx.x] = hit ? ks[k] : -1;
    }
    last = __shfl_sync(kWarpMask, last, front + (depth > H));
    __syncwarp();  // the partner's slots are written

    // Shade the winners in f32 and composite front to back.
    const Pixel px = load_pixel(q);
    float rr = 0.f, rg = 0.f, rb = 0.f, tr = 1.f;
#pragma unroll
    for (int j = 0; j < H; ++j) {
      // Layer k = 2j + h: entry k of the front lane's half, or entry k − H
      // of the back lane's.
      const int k = 2 * j + h;
      const bool in_back = 2 * j >= H;
      int s = slots[(k - (in_back ? H : 0)) * kSlotStride + (threadIdx.x & ~1) +
                    in_back];
      if (k >= depth)
        s = -1;  // past the pass's layers
      else if (active)
        out_slot[(static_cast<size_t>(t) * depth + k) * P + p] = s;
      float alpha = 0.f, cr = 0.f, cg = 0.f, cb = 0.f;
      if (s >= 0) {
        const float* row = winner_row(staged, s_rows, packed, cand_t, s);
        if (staged) {
          alpha = quad(row, px).alpha;
          cr = color(row, px, 0);
          cg = color(row, px, 1);
          cb = color(row, px, 2);
        } else {
          shade_table_row(row, px, alpha, cr, cg, cb);
        }
      }
      const int s2 = __shfl_xor_sync(kWarpMask, s, 1);
      const float alpha2 = __shfl_xor_sync(kWarpMask, alpha, 1);
      const float cr2 = __shfl_xor_sync(kWarpMask, cr, 1);
      const float cg2 = __shfl_xor_sync(kWarpMask, cg, 1);
      const float cb2 = __shfl_xor_sync(kWarpMask, cb, 1);
#pragma unroll
      for (int e = 0; e < 2; ++e) {  // layer 2j, then 2j + 1
        const bool own = e == h;
        if ((own ? s : s2) >= 0) {
          const float a = own ? alpha : alpha2;
          const float w = tr * a;
          rr = rr + w * (own ? cr : cr2);
          rg = rg + w * (own ? cg : cg2);
          rb = rb + w * (own ? cb : cb2);
          tr = tr * (1.f - a);
        }
      }
    }
    if (active && h == 0) {
      out_rad[(static_cast<size_t>(t) * 3 + 0) * P + p] = rr;
      out_rad[(static_cast<size_t>(t) * 3 + 1) * P + p] = rg;
      out_rad[(static_cast<size_t>(t) * 3 + 2) * P + p] = rb;
      out_trans[tp] = tr;
      if (out_last_t1) out_last_t1[tp] = last;
    }
  }
  if (kCount) {
    atomicAdd(screen_counts, n_pairs);
    atomicAdd(screen_counts + 1, n_rejected);
  }
}

// kCount: also count the swept and the screened-out pairs into
// screen_counts[0:2] (the timed instantiation carries no counter).
template <int K, bool kCount>
__global__ void __launch_bounds__(kPairs<K> ? kPairThreads : kThreads,
                                  kPairs<K> ? 1 : 2)
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

  if constexpr (kPairs<K>) {
    peel_pixel_pairs<K / 2, kCount>(stage, s_rows, packed, cand, counts, pix,
                                    floor_t1, floor_slot, out_rad, out_trans,
                                    out_slot, out_last_t1, screen_counts, C,
                                    P, depth);
  } else {
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
      sweep_topk<K, kCount>(packed, cand_t, n_chunks, active, q, stage, kt,
                            ks, load_floor(floor_t1, floor_slot, tp),
                            n_pairs, n_rejected);
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
    const int threads = kPairs<K> ? pair_threads_for(P) : threads_for(P);
    const int smem = kPairs<K> ? kPairShadeBytes : kShadeBytes;
    if (screen_counts) {
      if (dynamic_smem_opt_in<peel_fwd_kernel<K, true>>(device, smem) !=
          cudaSuccess)
        return;
      peel_fwd_kernel<K, true><<<T, threads, smem, s>>>(
          packed, cand, counts, pix, floor_t1, floor_slot, out_rad,
          out_trans, out_slot, out_last_t1, screen_counts, C, P, depth);
    } else {
      if (dynamic_smem_opt_in<peel_fwd_kernel<K, false>>(device, smem) !=
          cudaSuccess)
        return;
      peel_fwd_kernel<K, false><<<T, threads, smem, s>>>(
          packed, cand, counts, pix, floor_t1, floor_slot, out_rad,
          out_trans, out_slot, out_last_t1, nullptr, C, P, depth);
    }
  });
}

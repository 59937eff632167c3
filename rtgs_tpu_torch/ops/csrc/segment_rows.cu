// Ordered segment sum of 64-lane f32 rows on Hopper (sm_90a):
// out[r] = Σ rows[i] over the i with ids[i] = r, in ascending i.
//
// Stage 2 of every backward of the port (the counterpart of the JAX
// backwards' jax.ops.segment_sum): the fused and top-K peels' per-pair rows
// (peel_bwd.cu, peel_topk_bwd.cu) and the keys path's per-winner rows
// (render/tiled.py:_ShadeWinnersKP.backward) go into the (N+1, 64) feature
// table. The JAX package's _bwd_kernel (rtgs_tpu/ops/peel.py:870) leaves
// this sum to its caller; its keys path does it in XLA.
//
// Design. The caller hands over the ids sorted stably (torch.sort, stable)
// and the permutation that sorts them, so each id's rows form a run, in
// ascending i. segment_starts_kernel finds, one thread an output row, where
// the row's run starts (a binary search of the sorted ids). segment_rows_kernel
// gives every output row to a warp: lane l owns lanes 2l and 2l + 1 (one
// 8-byte load a lane, 256 bytes a row), walks the run in order with four
// rows in flight, adds in f32 and stores the row once. No atomic of any
// kind; a row no id names is stored as zero; ids outside [0, n_out) are
// skipped.
//
// Bound. Bytes: every input row read once and every output row written
// once, (M + n_out)·256, beside 4 bytes a sorted id and 8 a permutation
// entry; one f32 add a lane and row.
//
// Numerics. Plain f32 adds from 0 in ascending i (built with --fmad=false,
// which adds nothing to fuse here): bitwise what index_add_ on the CPU
// gives, which adds row by row (rtgs_tpu_torch.ops.peel.segment_rows_torch).

#include <cuda_runtime.h>

#include "launch_common.cuh"

namespace {

constexpr int kRow = 64;      // lanes a row
constexpr int kWarps = 8;     // output rows a block
constexpr int kInFlight = 4;  // rows loaded before they are added

// starts[r] = the first i with sorted_ids[i] >= r, for r in [0, n_out].
__global__ void segment_starts_kernel(const int* __restrict__ sorted_ids,
                                      int m, int* __restrict__ starts,
                                      int n_out) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r > n_out) return;
  int lo = 0, hi = m;
  while (lo < hi) {
    const int mid = lo + (hi - lo) / 2;
    if (__ldg(sorted_ids + mid) < r)
      lo = mid + 1;
    else
      hi = mid;
  }
  starts[r] = lo;
}

__global__ void __launch_bounds__(kWarps * 32)
    segment_rows_kernel(const float* __restrict__ rows,
                        const long long* __restrict__ perm,
                        const int* __restrict__ starts,
                        float* __restrict__ out, int n_out) {
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (r >= n_out) return;
  const int begin = starts[r], end = starts[r + 1];
  const float2* src = reinterpret_cast<const float2*>(rows) + lane;
  float2 acc = make_float2(0.f, 0.f);
  int i = begin;
  for (; i + kInFlight <= end; i += kInFlight) {
    float2 v[kInFlight];
#pragma unroll
    for (int u = 0; u < kInFlight; ++u)
      v[u] = __ldg(src + __ldg(perm + i + u) * (kRow / 2));
#pragma unroll
    for (int u = 0; u < kInFlight; ++u) {
      acc.x = acc.x + v[u].x;
      acc.y = acc.y + v[u].y;
    }
  }
  for (; i < end; ++i) {
    const float2 v = __ldg(src + __ldg(perm + i) * (kRow / 2));
    acc.x = acc.x + v.x;
    acc.y = acc.y + v.y;
  }
  reinterpret_cast<float2*>(out + static_cast<size_t>(r) * kRow)[lane] = acc;
}

}  // namespace

// Returns the cudaError_t of the launches (0 on success). Shapes: rows
// (M, 64) f32; sorted_ids (M,) i32, ascending; perm (M,) i64 with
// sorted_ids[j] = ids[perm[j]] and perm ascending among equal ids (a stable
// sort); starts (n_out + 1,) i32, scratch; out (n_out, 64) f32, every row
// of which the kernel writes.
extern "C" int rtgs_segment_rows(const float* rows, const int* sorted_ids,
                                 const long long* perm, int* starts,
                                 float* out, int m, int n_out, int device,
                                 void* stream) {
  const cudaError_t err = use_device(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (m < 0 || n_out < 1) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  segment_starts_kernel<<<(n_out + 1 + 255) / 256, 256, 0, s>>>(
      sorted_ids, m, starts, n_out);
  segment_rows_kernel<<<(n_out + kWarps - 1) / kWarps, kWarps * 32, 0, s>>>(
      rows, perm, starts, out, n_out);
  return static_cast<int>(cudaGetLastError());
}

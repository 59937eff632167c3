// Floor kernels of the keys kernel's launch shape on Hopper (sm_90a).
//
// Replaces the pl.pallas_call of scripts/lpprobe.py (nothing_kernel and
// touch_kernel): one block per tile, one thread per pixel, output
// (T, 2K, P) f32 as the keys kernel's (t1, id) pair of (T, K, P).
//   nothing — writes +inf everywhere: the cost of the launch and of the
//             output's bytes;
//   touch   — per tile, the sum over the tile's C candidate rows of
//             feature lane 0 (a −1 slot reads the sentinel row N, as a
//             gather would), broadcast over the tile's output: adds one
//             dependent read of every candidate's row to the floor.
//
// Bound: bytes. nothing writes T·2K·P·4 bytes; touch also reads T·C ids
// and one 32-byte sector of each candidate's row. touch sums in the order
// of a block reduction (per thread, then shuffles), so it agrees with a
// plain sum to f32 rounding only.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kFeat = 64;
constexpr unsigned kFull = 0xffffffffu;

__global__ void nothing_kernel(float* __restrict__ out, int rows, int P) {
  float* ot = out + static_cast<size_t>(blockIdx.x) * rows * P;
  for (int k = 0; k < rows; ++k)
    for (int p = threadIdx.x; p < P; p += blockDim.x)
      ot[static_cast<size_t>(k) * P + p] = CUDART_INF_F;
}

__global__ void touch_kernel(const float* __restrict__ packed,
                             const int* __restrict__ cand,
                             float* __restrict__ out, int C, int n_sentinel,
                             int rows, int P) {
  __shared__ float s_part[32];
  __shared__ float s_sum;
  const int* cand_t = cand + static_cast<size_t>(blockIdx.x) * C;
  float acc = 0.f;
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    const int id = cand_t[c];
    acc = acc + packed[static_cast<size_t>(id >= 0 ? id : n_sentinel) * kFeat];
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) acc = acc + __shfl_xor_sync(kFull, acc, o);
  if ((threadIdx.x & 31) == 0) s_part[threadIdx.x >> 5] = acc;
  __syncthreads();
  if (threadIdx.x == 0) {
    float s = 0.f;
    for (int w = 0; w < (blockDim.x + 31) / 32; ++w) s = s + s_part[w];
    s_sum = s;
  }
  __syncthreads();
  const float s = s_sum;
  float* ot = out + static_cast<size_t>(blockIdx.x) * rows * P;
  for (int k = 0; k < rows; ++k)
    for (int p = threadIdx.x; p < P; p += blockDim.x)
      ot[static_cast<size_t>(k) * P + p] = s;
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success). variant 0 =
// nothing, 1 = touch. packed (N+1, 64) f32, cand (T, C) i32, out
// (T, rows, P) f32 with rows = 2·depth. Threads: P rounded up to a warp,
// at most 1024.
extern "C" int rtgs_probe_floor(int variant, const float* packed,
                                const int* cand, float* out, int T, int C,
                                int P, int rows, int n_sentinel, int device,
                                void* stream) {
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (T < 1 || P < 1 || rows < 1 || C < 0 || variant < 0 || variant > 1)
    return static_cast<int>(cudaErrorInvalidValue);
  int threads = (P + 31) / 32 * 32;
  if (threads > 1024) threads = 1024;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (variant == 0)
    nothing_kernel<<<T, threads, 0, s>>>(out, rows, P);
  else
    touch_kernel<<<T, threads, 0, s>>>(packed, cand, out, C, n_sentinel, rows,
                                       P);
  return static_cast<int>(cudaGetLastError());
}

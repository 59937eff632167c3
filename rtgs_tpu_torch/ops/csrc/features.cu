// The features layer's forward on Hopper (sm_90a): the (N+1, 64) feature
// table and the (T, P, 24) pixel table of render/tiled.py, bitwise their
// plain chains (precompute_features_torch + pack_features,
// pixel_table_torch) on the same CUDA tensors.
//
// Replaces no TPU kernel: the JAX package builds both tables in XLA
// (rtgs_tpu/render/tiled.py:precompute_features, pack_features,
// _tile_pixel_features). The port's plain chains are ~150 torch operations
// a frame, which the host dispatches one by one, and the (N+1, 64) table is
// assembled by torch.cat from six fields that each gained a sentinel row by
// another torch.cat.
//
// Design: two kernels, one launching host call each, outputs allocated by
// the caller.
//  rtgs_features_table: table_kernel, a block of 128 splats (a thread a
//   splat). The block's SH coefficients, a contiguous run of 128 x 45
//   floats, are read in 16-byte words by the whole block and transposed in
//   shared memory into lanes 14 + 15c + k; each thread computes its splat's
//   direct Σ⁻¹, Me, c0 and copies opacity and color into its row there (the
//   block holding row N writes the sentinel); then the block's rows, a
//   contiguous 32 KB of the table, go out in 16-byte words. It also writes
//   the (N+1,) c0 with TileFeatures' inf sentinel (the table holds 1e30
//   there).
//  rtgs_features_pixels: pixel_kernel, a block of 256 consecutive rows of
//   the tile-major (T, P) pixel order (a thread a pixel, padding past the
//   image edge included): the ray through the (jittered) pixel centre,
//   rotated by the camera's rotation columns, its six d-quadratic products
//   and its 15 SH basis values, staged in shared memory and written in
//   16-byte words.
//
// Bound. Bytes: the table reads 236 B a splat (means, quats, scales,
// colors, opacity, 45 SH floats) and writes 260 (its row and c0); the pixel
// table writes 96 B a pixel and reads nothing but the camera. A few dozen
// f32 operations a row are far below the card's rate.
//
// Numerics. f32, the plain chains' operations in their order, each an
// explicitly rounded intrinsic (__fmul_rn, __fadd_rn, __fsub_rn, __fdiv_rn,
// __fsqrt_rn), so that no product is fused into a sum whatever the flags:
// gaussians.py:inv_covariance_direct6 (with
// utils/quaternion.py:rotation_columns), gaussians.py:sh_basis,
// tiled.py:direction_features, precompute_features_torch and
// pixel_table_torch. Each Python constant is a double rounded to f32 once,
// as torch rounds a Python scalar. NaN inputs are outside the contract.

#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

#include "launch_common.cuh"

namespace {

constexpr int kRows = 128;        // splats (table rows) a block
constexpr int kLanes = 64;        // F_DIM
constexpr int kStride = kLanes + 1;   // a staged row, padded off the banks
constexpr int kSh = 45;           // 15 coefficients x 3 channels
constexpr int kPix = 256;         // pixel rows a block
constexpr int kPixLanes = 24;     // G_DIM
constexpr float kThreshold = 3.0f;    // G.BOUNDING_THRESHOLD

// gaussians.py's C_0 ... C_6 (Python's doubles, by repr).
constexpr double kC0 = 0.9772050238058398;
constexpr double kC1 = 2.1850968611841584;
constexpr double kC2 = 1.2615662610100802;
constexpr double kC3 = 2.360174359706574;
constexpr double kC4 = 5.781222885281108;
constexpr double kC5 = 1.828183197857863;
constexpr double kC6 = 1.4927053303604616;

__device__ __forceinline__ float mul(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ float add(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ float sub(float a, float b) {
  return __fsub_rn(a, b);
}

// utils/quaternion.py:rotation_columns: c[i][j] is component j of q e_i q*.
__device__ __forceinline__ void rotation_columns(float x, float y, float z,
                                                 float w, float c[3][3]) {
  const float v[3] = {x, y, z};
  const float r[3][3] = {{w, z, -y}, {-z, w, x}, {y, -x, w}};
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const int a = (j + 1) % 3, b = (j + 2) % 3;
      c[i][j] = add(add(mul(w, r[i][j]), mul(v[i], v[j])),
                    sub(mul(v[a], r[i][b]), mul(v[b], r[i][a])));
    }
  }
}

// One splat's lanes 0-13 (m6, Me, c0, opacity, color) into `row`:
// inv_covariance_direct6, then precompute_features_torch. Returns c0.
__device__ __forceinline__ float splat_lanes(
    const float* __restrict__ means, const float* __restrict__ quats,
    const float* __restrict__ scales, const float* __restrict__ colors,
    const float* __restrict__ opacities, const float pos[3], int i,
    float* row) {
  float q[4];
  if ((reinterpret_cast<uintptr_t>(quats) & 15) == 0) {
    const float4 q4 = __ldg(reinterpret_cast<const float4*>(quats) + i);
    q[0] = q4.x, q[1] = q4.y, q[2] = q4.z, q[3] = q4.w;
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k) q[k] = __ldg(quats + 4 * i + k);
  }
  float c[3][3];
  rotation_columns(q[0], q[1], q[2], q[3], c);
  const float qq = add(add(add(mul(q[0], q[0]), mul(q[1], q[1])),
                           mul(q[2], q[2])),
                       mul(q[3], q[3]));
  const float inv_n2 = __fdiv_rn(1.0f, mul(qq, qq));
  float a[3][3];   // a[k][j]: component j of column k over |q|⁴ s_k
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float ik = __fdiv_rn(inv_n2, __ldg(scales + 3 * i + k));
#pragma unroll
    for (int j = 0; j < 3; ++j) a[k][j] = mul(c[k][j], ik);
  }
  // m6 = (m00, m01, m02, m11, m12, m22), each (u u + v v) + w w.
  constexpr int kI[6] = {0, 0, 0, 1, 1, 2}, kJ[6] = {0, 1, 2, 1, 2, 2};
  float m6[6];
#pragma unroll
  for (int l = 0; l < 6; ++l) {
    const int p = kI[l], r = kJ[l];
    m6[l] = add(add(mul(a[0][p], a[0][r]), mul(a[1][p], a[1][r])),
                mul(a[2][p], a[2][r]));
    row[l] = m6[l];
  }
  float e[3];
#pragma unroll
  for (int j = 0; j < 3; ++j) e[j] = sub(pos[j], __ldg(means + 3 * i + j));
  // Σ⁻¹ by row: (m00 m01 m02), (m01 m11 m12), (m02 m12 m22).
  const float me[3] = {
      add(add(mul(m6[0], e[0]), mul(m6[1], e[1])), mul(m6[2], e[2])),
      add(add(mul(m6[1], e[0]), mul(m6[3], e[1])), mul(m6[4], e[2])),
      add(add(mul(m6[2], e[0]), mul(m6[4], e[1])), mul(m6[5], e[2]))};
  const float c0 = sub(add(add(mul(e[0], me[0]), mul(e[1], me[1])),
                           mul(e[2], me[2])),
                       kThreshold);
  row[6] = me[0], row[7] = me[1], row[8] = me[2];
  row[9] = c0;
  row[10] = __ldg(opacities + i);
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) row[11 + ch] = __ldg(colors + 3 * i + ch);
  return c0;
}

// SH coefficient f of the block's run (splat f / 45, coefficient k, channel
// c) to its staged lane 14 + 15c + k.
__device__ __forceinline__ void stage_sh(float* rows, int f, float value) {
  const int r = f / kSh, rem = f - kSh * r;
  const int k = rem / 3, ch = rem - 3 * k;
  rows[r * kStride + 14 + 15 * ch + k] = value;
}

__global__ void __launch_bounds__(kRows) table_kernel(
    const float* __restrict__ means, const float* __restrict__ quats,
    const float* __restrict__ scales, const float* __restrict__ colors,
    const float* __restrict__ opacities, const float* __restrict__ sh,
    const float* __restrict__ position, float* __restrict__ table,
    float* __restrict__ c0_out, int n) {
  __shared__ float rows[kRows * kStride];
  const int r0 = blockIdx.x * kRows;
  const int splats = max(0, min(kRows, n - r0));   // rows < N here
  const int nrows = min(kRows, n + 1 - r0);        // and the sentinel
  // 1. The block's SH run, read once in order, transposed as staged.
  const float* run = sh + static_cast<size_t>(r0) * kSh;
  const int nsh = splats * kSh;
  if ((reinterpret_cast<uintptr_t>(run) & 15) == 0) {
    const float4* run4 = reinterpret_cast<const float4*>(run);
    for (int v = threadIdx.x; v < nsh / 4; v += kRows) {
      const float4 q = __ldg(run4 + v);
      stage_sh(rows, 4 * v, q.x);
      stage_sh(rows, 4 * v + 1, q.y);
      stage_sh(rows, 4 * v + 2, q.z);
      stage_sh(rows, 4 * v + 3, q.w);
    }
    for (int f = nsh / 4 * 4 + threadIdx.x; f < nsh; f += kRows)
      stage_sh(rows, f, __ldg(run + f));
  } else {
    for (int f = threadIdx.x; f < nsh; f += kRows)
      stage_sh(rows, f, __ldg(run + f));
  }
  // 2. Each thread's row: a splat's lanes, or the sentinel's.
  const int r = threadIdx.x, i = r0 + r;
  float* row = rows + r * kStride;
  if (i < n) {
    const float pos[3] = {__ldg(position), __ldg(position + 1),
                          __ldg(position + 2)};
    c0_out[i] = splat_lanes(means, quats, scales, colors, opacities, pos, i,
                            row);
  } else if (i == n) {
    // Identity m6, zero Me, c0 1e30 in the table (finite: Δ < 0 there with
    // no inf arithmetic) and inf in c0, zero opacity, color and SH.
    const float m6[6] = {1.0f, 0.0f, 0.0f, 1.0f, 0.0f, 1.0f};
#pragma unroll
    for (int l = 0; l < 6; ++l) row[l] = m6[l];
    for (int l = 6; l < 59; ++l) row[l] = 0.0f;
    row[9] = 1e30f;
    c0_out[n] = INFINITY;
  }
  if (i <= n) {
#pragma unroll
    for (int l = 59; l < kLanes; ++l) row[l] = 0.0f;
  }
  __syncthreads();
  // 3. The block's rows, contiguous in the table, in 16-byte words.
  float4* dst = reinterpret_cast<float4*>(table + static_cast<size_t>(r0) *
                                                      kLanes);
  for (int v = threadIdx.x; v < nrows * (kLanes / 4); v += kRows) {
    const float* s = rows + (v >> 4) * kStride + (v & 15) * 4;
    dst[v] = make_float4(s[0], s[1], s[2], s[3]);
  }
}

struct PixelGrid {
  int w, h, tw, th, nty, total;
  float ox, oy;
};

// One pixel's 24 lanes: pixel_table_torch, direction_features, sh_basis.
__device__ __forceinline__ void pixel_lanes(const PixelGrid& g,
                                            const float c[3][3], float fx,
                                            float fy, int idx, float* out) {
  const int p_tile = g.tw * g.th;
  const int t = idx / p_tile, p = idx - t * p_tile;
  const int tx = t / g.nty, ty = t - tx * g.nty;
  const int lx = p / g.th, ly = p - lx * g.th;
  const float fw = static_cast<float>(g.w), fh = static_cast<float>(g.h);
  const float u = __fdiv_rn(
      add(add(static_cast<float>(tx * g.tw + lx), 0.5f), g.ox), fw);
  const float v = __fdiv_rn(
      add(add(static_cast<float>(ty * g.th + ly), 0.5f), g.oy), fh);
  const float px = __fdiv_rn(sub(mul(fw, u), mul(0.5f, fw)), fx);
  const float py = __fdiv_rn(sub(mul(fh, v), mul(0.5f, fh)), fy);
  const float norm = __fsqrt_rn(add(add(mul(px, px), mul(py, py)), 1.0f));
  const float d[3] = {__fdiv_rn(px, norm), __fdiv_rn(py, norm),
                      __fdiv_rn(-1.0f, norm)};
  float dir[3];
#pragma unroll
  for (int k = 0; k < 3; ++k)
    dir[k] = add(add(mul(d[0], c[0][k]), mul(d[1], c[1][k])),
                 mul(d[2], c[2][k]));
  const float x = dir[0], y = dir[1], z = dir[2];
  out[0] = x, out[1] = y, out[2] = z;
  out[3] = mul(x, x);
  out[4] = mul(mul(2.0f, x), y);
  out[5] = mul(mul(2.0f, x), z);
  out[6] = mul(y, y);
  out[7] = mul(mul(2.0f, y), z);
  out[8] = mul(z, z);
  const float xx = mul(x, x), yy = mul(y, y), zz = mul(z, z);
  const float x2_y2 = sub(xx, yy);
  const float z5_1 = sub(mul(5.0f, zz), 1.0f);
  const float h0 = static_cast<float>(0.5 * kC0);
  const float h1 = static_cast<float>(0.5 * kC1);
  const float h4 = static_cast<float>(0.5 * kC4);
  const float q1 = static_cast<float>(0.25 * kC1);
  const float q2 = static_cast<float>(0.25 * kC2);
  const float q3 = static_cast<float>(0.25 * kC3);
  const float q4 = static_cast<float>(0.25 * kC4);
  const float q5 = static_cast<float>(0.25 * kC5);
  const float q6 = static_cast<float>(0.25 * kC6);
  float* ysh = out + 9;
  ysh[0] = mul(h0, y);
  ysh[1] = mul(h0, z);
  ysh[2] = mul(h0, x);
  ysh[3] = mul(mul(h1, x), y);
  ysh[4] = mul(mul(h1, y), z);
  ysh[5] = mul(q2, sub(mul(3.0f, zz), 1.0f));
  ysh[6] = mul(mul(h1, x), z);
  ysh[7] = mul(q1, x2_y2);
  ysh[8] = mul(mul(q3, y), sub(mul(3.0f, xx), yy));
  ysh[9] = mul(mul(mul(h4, x), y), z);
  ysh[10] = mul(mul(q5, y), z5_1);
  ysh[11] = mul(q6, sub(mul(5.0f, zz), mul(3.0f, z)));
  ysh[12] = mul(mul(q5, x), z5_1);
  ysh[13] = mul(mul(q4, x2_y2), z);
  ysh[14] = mul(mul(q3, x), sub(xx, mul(3.0f, yy)));
}

__global__ void __launch_bounds__(kPix) pixel_kernel(
    const float* __restrict__ rotation, const float* __restrict__ focal,
    PixelGrid g, float* __restrict__ pix) {
  __shared__ float4 staged[kPix * kPixLanes / 4];
  float c[3][3];
  rotation_columns(__ldg(rotation), __ldg(rotation + 1),
                   __ldg(rotation + 2), __ldg(rotation + 3), c);
  const int first = blockIdx.x * kPix;
  const int idx = first + threadIdx.x;
  if (idx < g.total) {
    float out[kPixLanes];
    pixel_lanes(g, c, __ldg(focal), __ldg(focal + 1), idx, out);
    float4* mine = staged + threadIdx.x * (kPixLanes / 4);
#pragma unroll
    for (int l = 0; l < kPixLanes / 4; ++l)
      mine[l] = make_float4(out[4 * l], out[4 * l + 1], out[4 * l + 2],
                            out[4 * l + 3]);
  }
  __syncthreads();
  const int count = min(kPix, g.total - first) * (kPixLanes / 4);
  float4* dst = reinterpret_cast<float4*>(pix) +
                static_cast<size_t>(first) * (kPixLanes / 4);
  for (int v = threadIdx.x; v < count; v += kPix) dst[v] = staged[v];
}

}  // namespace

// The (N+1, 64) table and the (N+1,) c0 of N splats; every pointer a
// contiguous f32 CUDA buffer (table 16-byte aligned).
extern "C" int rtgs_features_table(const float* means, const float* quats,
                                   const float* scales, const float* colors,
                                   const float* opacities, const float* sh,
                                   const float* position, float* table,
                                   float* c0, int n, int device,
                                   void* stream) {
  const cudaError_t err = use_device(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n < 0) return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = n / kRows + 1;   // rows 0 .. N
  table_kernel<<<blocks, kRows, 0, static_cast<cudaStream_t>(stream)>>>(
      means, quats, scales, colors, opacities, sh, position, table, c0, n);
  return static_cast<int>(cudaGetLastError());
}

// The (T, P, 24) pixel table of a w x h image in tw x th tiles (nty tile
// rows), T·P = total rows, with the sub-pixel offset (ox, oy).
extern "C" int rtgs_features_pixels(const float* rotation, const float* focal,
                                    float* pix, int w, int h, int tw, int th,
                                    int nty, int total, float ox, float oy,
                                    int device, void* stream) {
  const cudaError_t err = use_device(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (w < 1 || h < 1 || tw < 1 || th < 1 || nty < 1 || total < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (total == 0) return static_cast<int>(cudaSuccess);
  const PixelGrid g{w, h, tw, th, nty, total, ox, oy};
  pixel_kernel<<<(total + kPix - 1) / kPix, kPix, 0,
                 static_cast<cudaStream_t>(stream)>>>(rotation, focal, g,
                                                      pix);
  return static_cast<int>(cudaGetLastError());
}

// Sky finalize: record -> final rgb with the procedural sky, on record
// rows (8, N) -> rgb rows (3, N), or on an interleaved record (N, 8) ->
// (N, 3).
//
// Replaces: the Pallas TPU kernels bhx/kernels/shade_pallas.py:
// _sky_rows_kernel (launched by _sky_rows_pallas) and _sky_kernel
// (launched by _sky_finalize_pallas), with the equirect mapping of
// _sky_channels_from_dir (:585-592).  Computes the same functions as
// their plain versions bhx_torch/kernels/sky.py:sky_rows_torch and
// sky_finalize_torch.
//
// What bounds it on the card: compute.  Every pixel that sees sky (weight
// amount > 0.001) evaluates two atan2, two Perlin octaves of nebula and a
// 3x3 neighbourhood of star cells with five hashes each; the 7 loads and
// 3 stores per pixel are streaming traffic.
//
// What the design does about it: one thread per pixel with a per-thread
// branch on the sky weight (fully absorbed pixels skip the sky, the
// counterpart of the TPU kernel's tile-wide pl.when), and the star cells
// that hold no star, or whose splat misses the pixel, skip the tint.
// The floor mod of the uv mapping is x - floorf(x), never fmodf.  The two
// layouts are one template that differs only in its addressing: the
// interleaved one reads a pixel's 8 channels from one 32-byte record.

#include <cuda_runtime.h>

#include <cstdint>

#include "procedural.cuh"

namespace {

// kRecord: rows is an (N, 8) record and out (N, 3); otherwise rows is
// (8, N) and out (3, N).
template <bool kRecord>
__global__ void __launch_bounds__(128) sky_kernel(
    const float* __restrict__ rows, const float* __restrict__ coeffs,
    float* __restrict__ out, int64_t n, int show_sky) {
  const int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
  if (i >= n) return;
  const int64_t in_c = kRecord ? 1 : n, in_i = kRecord ? 8 * i : i;
  const int64_t out_c = kRecord ? 1 : n, out_i = kRecord ? 3 * i : i;

  // Record channels: cr cg cb alpha amount dx dy dz.
  float cr = rows[0 * in_c + in_i], cg = rows[1 * in_c + in_i];
  float cb = rows[2 * in_c + in_i];
  const float amount = rows[4 * in_c + in_i];
  const float w = amount > 0.001f ? amount : 0.0f;
  if (show_sky && w > 0.0f) {
    const float dx = rows[5 * in_c + in_i], dy = rows[6 * in_c + in_i];
    const float dz = rows[7 * in_c + in_i];
    const float pi = bhx::kPi;
    const float theta = atan2f(sqrtf(dx * dx + dz * dz), dy);
    const float phi = atan2f(dz, dx);
    float u = (phi + static_cast<float>(2.6 * 3.1415926)) /
              static_cast<float>(2.0 * 3.1415926);
    u = u - floorf(u);
    float v = (pi - theta) / pi;
    v = v - floorf(v);
    float sr, sg, sb;
    bhx::sky_radiance(u, v, coeffs, &sr, &sg, &sb);
    cr = cr + w * sr;
    cg = cg + w * sg;
    cb = cb + w * sb;
  }
  out[0 * out_c + out_i] = cr;
  out[1 * out_c + out_i] = cg;
  out[2 * out_c + out_i] = cb;
}

}  // namespace

extern "C" int bhx_sky(const float* rows, const float* coeffs, float* out,
                       int64_t n, int show_sky, cudaStream_t stream) {
  constexpr int kBlock = 128;
  const unsigned grid = static_cast<unsigned>((n + kBlock - 1) / kBlock);
  sky_kernel<false><<<grid, kBlock, 0, stream>>>(rows, coeffs, out, n, show_sky);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int bhx_sky_finalize(const float* record, const float* coeffs,
                                float* out, int64_t n, int show_sky,
                                cudaStream_t stream) {
  constexpr int kBlock = 128;
  const unsigned grid = static_cast<unsigned>((n + kBlock - 1) / kBlock);
  sky_kernel<true><<<grid, kBlock, 0, stream>>>(record, coeffs, out, n, show_sky);
  return static_cast<int>(cudaGetLastError());
}

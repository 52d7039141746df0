// Sky finalize: record rows -> final rgb rows with the procedural sky.
//
// Replaces: the Pallas TPU kernel bhx/kernels/shade_pallas.py:
// _sky_rows_kernel (launched by _sky_rows_pallas), with the equirect
// mapping of _sky_channels_from_dir (:585-592).  Computes the same function
// as its plain version bhx_torch/kernels/sky.py:sky_rows_torch.
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
// The floor mod of the uv mapping is x - floorf(x), never fmodf.

#include <cuda_runtime.h>

#include <cstdint>

#include "procedural.cuh"

namespace {

__global__ void __launch_bounds__(128) sky_kernel(
    const float* __restrict__ rows, const float* __restrict__ coeffs,
    float* __restrict__ out, int64_t n, int show_sky) {
  const int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
  if (i >= n) return;

  // Record rows: cr cg cb alpha amount dx dy dz.
  float cr = rows[0 * n + i], cg = rows[1 * n + i], cb = rows[2 * n + i];
  const float amount = rows[4 * n + i];
  const float w = amount > 0.001f ? amount : 0.0f;
  if (show_sky && w > 0.0f) {
    const float dx = rows[5 * n + i], dy = rows[6 * n + i], dz = rows[7 * n + i];
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
  out[0 * n + i] = cr;
  out[1 * n + i] = cg;
  out[2 * n + i] = cb;
}

}  // namespace

extern "C" int bhx_sky(const float* rows, const float* coeffs, float* out,
                       int64_t n, int show_sky, cudaStream_t stream) {
  constexpr int kBlock = 128;
  const unsigned grid = static_cast<unsigned>((n + kBlock - 1) / kBlock);
  sky_kernel<<<grid, kBlock, 0, stream>>>(rows, coeffs, out, n, show_sky);
  return static_cast<int>(cudaGetLastError());
}

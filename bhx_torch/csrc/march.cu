// Geodesic march kernel (Euler, pseudo-Newtonian force, disk branch).
//
// Replaces: the Pallas TPU kernel bhx/kernels/march_pallas.py:_kernel
// (launched by march_pallas), which inlines the substep of
// bhx/kernels/march_substep.py:78-340.  Computes the same function as its
// plain version bhx_torch/kernels/march.py:march_torch.
//
// What bounds it on the card: compute and warp divergence.  A ray runs up
// to max_iterations (2000) substeps of about 60 flops and two reciprocal
// square roots each, and rays in one warp finish after very different
// step counts (escapes after a few hundred steps, photon-sphere orbiters
// at the budget).  Memory traffic is 10 input + 41 output floats per ray,
// negligible next to that.
//
// What the design does about it: one thread per ray, with the whole ray
// state in registers and a per-thread loop that stops the moment that ray
// is done -- no tile-wide vote as on the TPU; a warp retires when its last
// ray does.  Rows are structure-of-arrays, so loads and stores coalesce.
// The rare disk crossings are written straight to their output slot when
// they happen; slot rows are zeroed first.  Lanes that enter inactive skip
// the loop and write their inputs back unchanged.  The 21 scalars come
// from a device pointer (no host sync).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kOutFixed = 13;
constexpr int kCrossFields = 7;
constexpr int kMaxCrossings = 4;

// Parameter vector layout (bhx_torch/kernels/march.py:_P).
enum Param {
  kBhX = 0, kBhY, kBhZ, kMass, kHorizonR, kRelR, kDiskNx, kDiskNy, kDiskNz,
  kDiskInner, kDiskOuter, kStepSize, kCutoff, kRtol, kSafety, kMinF, kMaxF,
  kHMin, kHMax, kBudget, kSpin
};

// Output row layout (bhx_torch/kernels/march.py:_OUT_FIXED).
enum OutRow {
  kOPx = 0, kOPy, kOPz, kODx, kODy, kODz, kOSteps, kOClosest, kOHorizon,
  kOExited, kOH, kOAmount, kOCount
};

__global__ void __launch_bounds__(128) march_kernel(
    const float* __restrict__ rays, const float* __restrict__ params,
    float* __restrict__ out, int64_t n, int max_iterations,
    float tex_opacity_min, int show_disk) {
  const int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
  if (i >= n) return;

  const float bx = params[kBhX], by = params[kBhY], bz = params[kBhZ];
  const float mass = params[kMass];
  const float horizon_r2 = params[kHorizonR] * params[kHorizonR];
  const float rel_r2 = params[kRelR] * params[kRelR];
  const float nx = params[kDiskNx], ny = params[kDiskNy], nz = params[kDiskNz];
  const float d_in = params[kDiskInner], d_out = params[kDiskOuter];
  const float d_in2 = d_in * d_in, d_out2 = d_out * d_out;
  const float inv_d_out = 1.0f / d_out;
  const float cutoff = params[kCutoff];
  const float budget = params[kBudget];
  const float m3 = -3.0f * mass;

  float px = rays[0 * n + i], py = rays[1 * n + i], pz = rays[2 * n + i];
  float dx = rays[3 * n + i], dy = rays[4 * n + i], dz = rays[5 * n + i];
  const float h = rays[6 * n + i];
  const float steps0 = rays[9 * n + i];
  float amount_ub = rays[8 * n + i];
  bool act = rays[7 * n + i] > 0.5f && steps0 < budget;

  for (int f = 0; f < kMaxCrossings * kCrossFields; ++f)
    out[(kOutFixed + f) * n + i] = 0.0f;

  float ox = px - bx, oy = py - by, oz = pz - bz;
  float closest2 = ox * ox + oy * oy + oz * oz;
  float steps = 0.0f, count = 0.0f, horizon = 0.0f, exited = 0.0f;

  for (int it = 0; act && it < max_iterations; ++it) {
    const float rx = px - bx, ry = py - by, rz = pz - bz;
    const float cxv = ry * dz - rz * dy;
    const float cyv = rz * dx - rx * dz;
    const float czv = rx * dy - ry * dx;
    const float h2 = cxv * cxv + cyv * cyv + czv * czv;

    // Euler: dir += f h; normalize; pos += dir h, with the bending force
    // -1.5 h^2 r / |r|^5 (ray.wgsl:401-403, 467-480).
    const float r2 = rx * rx + ry * ry + rz * rz;
    const float ir = rsqrtf(r2 + 1e-12f);
    const float ir2 = ir * ir;
    const float a_s = m3 * h2 * (ir2 * ir2 * ir);
    const float vx = dx + a_s * rx * h;
    const float vy = dy + a_s * ry * h;
    const float vz = dz + a_s * rz * h;
    const float inv = rsqrtf(vx * vx + vy * vy + vz * vz + 1e-20f);
    const float ndx = vx * inv, ndy = vy * inv, ndz = vz * inv;

    // Horizon sphere against [pos, pos + ndir * h].
    const float half_b = rx * ndx + ry * ndy + rz * ndz;
    const float disc4 = half_b * half_b - (r2 - horizon_r2);
    const float sq = sqrtf(fmaxf(disc4, 0.0f));
    const float t1 = -half_b - sq, t2 = -half_b + sq;
    const bool v1 = disc4 > 0.0f && t1 > 1e-8f && t1 < h;
    const bool v2 = disc4 > 0.0f && t2 > 1e-8f && t2 < h;
    const float t_h = v1 ? t1 : (v2 ? t2 : 1e9f);
    bool horizon_first = v1 || v2;

    if (show_disk) {
      // Disk annulus plane hit (reference hit_torus2d, ray.wgsl:668-701).
      float denom = nx * ndx + ny * ndy + nz * ndz;
      if (fabsf(denom) < 1e-12f) denom = 1e-12f;
      const float t_d = ((bx - px) * nx + (by - py) * ny + (bz - pz) * nz) / denom;
      const float hx = px + ndx * t_d, hy = py + ndy * t_d, hz = pz + ndz * t_d;
      const float ex = hx - bx, ey = hy - by, ez = hz - bz;
      const float rr2 = ex * ex + ey * ey + ez * ez;
      const bool hit_d = t_d > 1e-8f && t_d < h && rr2 >= d_in2 && rr2 <= d_out2;
      horizon_first = horizon_first && t_h <= t_d;
      if (hit_d && !horizon_first) {
        // Record the crossing in the next free slot (crossings past the
        // K-th are counted, not recorded).
        if (count < static_cast<float>(kMaxCrossings)) {
          float* slot = out + (kOutFixed + static_cast<int>(count) * kCrossFields) * n + i;
          slot[0 * n] = hx;
          slot[1 * n] = hy;
          slot[2 * n] = hz;
          slot[3 * n] = ndx;
          slot[4 * n] = ndy;
          slot[5 * n] = ndz;
          slot[6 * n] = 1.0f;
        }
        count += 1.0f;
        // Early-exit transmission bound: pow-free minorant
        // x^1.3 >= min(x, x^2) of the optical depth (30*dens)^1.3.
        const float irr = rsqrtf(rr2 + 1e-20f);
        const float rr = rr2 * irr;
        float dens = 1.0f - rr * inv_d_out;
        const float tt = fminf(fmaxf(rr - d_in, 0.0f), 1.0f);
        dens = dens * (tt * tt * (3.0f - 2.0f * tt));
        dens = fmaxf(dens * sqrtf(irr), 0.0f);
        const float x = 30.0f * dens;
        const float od_lb = x < 1.0f ? x * x : x;
        const float op_lb = fminf(fmaxf(od_lb * 0.2f, 0.0f), 1.0f) * tex_opacity_min;
        amount_ub = amount_ub * (1.0f - op_lb);
      }
    }

    px = px + ndx * h;
    py = py + ndy * h;
    pz = pz + ndz * h;
    dx = ndx;
    dy = ndy;
    dz = ndz;
    const float qx = px - bx, qy = py - by, qz = pz - bz;
    const float dist2 = qx * qx + qy * qy + qz * qz;
    closest2 = fminf(closest2, dist2);
    const bool exited_now = dist2 > rel_r2;
    const bool absorbed = horizon_first || amount_ub < cutoff;
    if (horizon_first) horizon = 1.0f;
    if (exited_now) exited = 1.0f;
    steps += 1.0f;
    act = steps0 + steps < budget && !(exited_now || absorbed);
  }

  out[kOPx * n + i] = px;
  out[kOPy * n + i] = py;
  out[kOPz * n + i] = pz;
  out[kODx * n + i] = dx;
  out[kODy * n + i] = dy;
  out[kODz * n + i] = dz;
  out[kOSteps * n + i] = steps;
  out[kOClosest * n + i] = sqrtf(closest2);
  out[kOHorizon * n + i] = horizon;
  out[kOExited * n + i] = exited;
  out[kOH * n + i] = h;
  out[kOAmount * n + i] = amount_ub;
  out[kOCount * n + i] = count;
}

}  // namespace

extern "C" int bhx_march(const float* rays, const float* params, float* out,
                         int64_t n, int max_iterations, float tex_opacity_min,
                         int show_disk, cudaStream_t stream) {
  constexpr int kBlock = 128;
  const unsigned grid = static_cast<unsigned>((n + kBlock - 1) / kBlock);
  march_kernel<<<grid, kBlock, 0, stream>>>(rays, params, out, n, max_iterations,
                                           tex_opacity_min, show_disk);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* bhx_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Geodesic march kernel: Euler and Cash-Karp RK45 under the
// pseudo-Newtonian force, and exact-Kerr Hamiltonian RK4, each with the
// disk branch.
//
// Replaces: the Pallas TPU kernel bhx/kernels/march_pallas.py:_kernel
// (launched by march_pallas), which inlines the substep of
// bhx/kernels/march_substep.py:78-340.  Computes the same function as its
// plain version bhx_torch/kernels/march.py:march_torch; the Kerr dH/dx is
// bhx_torch/kerr.py:_dh_component, written out by hand where the Pallas
// kernel takes it with jax.vjp.
//
// What bounds it on the card: compute and warp divergence.  A ray runs up
// to max_iterations (2000) substeps -- Euler about 60 flops and two
// reciprocal square roots, RK45 six force evaluations, Kerr four
// Hamiltonian right-hand sides of about 150 flops with six divisions and
// two square roots each -- and rays in one warp finish after very
// different step counts (escapes after a few dozen or hundred steps,
// photon-sphere orbiters at the budget).  Memory traffic is 10 (13 for
// Kerr) input + 41 (44) output floats per ray, negligible next to that.
//
// What the design does about it: one thread per ray, with the whole ray
// state in registers and a per-thread loop that stops the moment that ray
// is done -- no tile-wide vote as on the TPU; a warp retires when its last
// ray does.  The branch is a template parameter, so each instantiation
// carries only its own state (the Euler one keeps its 48 registers).  The
// RK4 sum is accumulated stage by stage in the order the plain version
// adds it, so only one stage's derivatives are live at a time.  Rows are structure-of-arrays, so loads and stores
// coalesce.  The rare disk crossings are written straight to their output
// slot when they happen; slot rows are zeroed first.  Lanes that enter
// inactive skip the loop and write their inputs back unchanged.  The 21
// scalars come from a device pointer (no host sync).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kOutFixed = 13;
constexpr int kCrossFields = 7;
constexpr int kMaxCrossings = 4;
constexpr int kInFields = 10;

// The kernel's branches (bhx_torch/kernels/march.py:KERNEL_NAMES).
constexpr int kEuler = 0;
constexpr int kRk45 = 1;
constexpr int kKerr = 2;

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

// Cash-Karp tableau (bhx_torch/integrate.py): each entry the double
// quotient (or difference of quotients) rounded once to float, as torch
// rounds the Python float when it multiplies a float32 row by it.
constexpr float kA21 = static_cast<float>(1.0 / 5.0);
constexpr float kA31 = static_cast<float>(3.0 / 40.0);
constexpr float kA32 = static_cast<float>(9.0 / 40.0);
constexpr float kA41 = static_cast<float>(3.0 / 10.0);
constexpr float kA42 = static_cast<float>(-9.0 / 10.0);
constexpr float kA43 = static_cast<float>(6.0 / 5.0);
constexpr float kA51 = static_cast<float>(-11.0 / 54.0);
constexpr float kA52 = static_cast<float>(5.0 / 2.0);
constexpr float kA53 = static_cast<float>(-70.0 / 27.0);
constexpr float kA54 = static_cast<float>(35.0 / 27.0);
constexpr float kA61 = static_cast<float>(1631.0 / 55296.0);
constexpr float kA62 = static_cast<float>(175.0 / 512.0);
constexpr float kA63 = static_cast<float>(575.0 / 13824.0);
constexpr float kA64 = static_cast<float>(44275.0 / 110592.0);
constexpr float kA65 = static_cast<float>(253.0 / 4096.0);
constexpr float kB1 = static_cast<float>(37.0 / 378.0);
constexpr float kB3 = static_cast<float>(250.0 / 621.0);
constexpr float kB4 = static_cast<float>(125.0 / 594.0);
constexpr float kB6 = static_cast<float>(512.0 / 1771.0);
constexpr float kE1 = static_cast<float>(37.0 / 378.0 - 2825.0 / 27648.0);
constexpr float kE3 = static_cast<float>(250.0 / 621.0 - 18575.0 / 48384.0);
constexpr float kE4 = static_cast<float>(125.0 / 594.0 - 13525.0 / 55296.0);
constexpr float kE5 = static_cast<float>(0.0 - 277.0 / 14336.0);
constexpr float kE6 = static_cast<float>(512.0 / 1771.0 - 1.0 / 4.0);

// Pseudo-Newtonian bending force -1.5 h^2 r / |r|^5 at a position
// (ray.wgsl:401-403), r^-5 as rsqrt^5; m3 = -3 mass.
__device__ __forceinline__ void accel(float qx, float qy, float qz, float bx,
                                      float by, float bz, float m3, float h2,
                                      float* ax, float* ay, float* az) {
  const float arx = qx - bx, ary = qy - by, arz = qz - bz;
  const float r2 = arx * arx + ary * ary + arz * arz;
  const float ir = rsqrtf(r2 + 1e-12f);
  const float ir2 = ir * ir;
  const float a_s = m3 * h2 * (ir2 * ir2 * ir);
  *ax = a_s * arx;
  *ay = a_s * ary;
  *az = a_s * arz;
}

// Kerr constants of one hole: a = spin * mass and its products, as the
// plain version forms them from 0-d tensors.
struct KerrConsts {
  float a, a2, a2x4, a2x2, mass2;
};

// Kerr-Schild radius, potential and null vector (bhx_torch/kerr.py:
// _scalars), with the intermediates dH/dx reuses.
struct KerrScalars {
  float b, d, r2, r, q, f, den, lx, ly, lz;
  bool free;
};

__device__ __forceinline__ KerrScalars kerr_scalars(float rx, float ry, float rz,
                                                    const KerrConsts& c) {
  KerrScalars s;
  const float rho2 = rx * rx + ry * ry + rz * rz;
  s.b = rho2 - c.a2;
  s.d = sqrtf(s.b * s.b + c.a2x4 * rz * rz + 1e-20f);
  const float r2_raw = 0.5f * (s.b + s.d);
  s.free = r2_raw > 1e-12f;
  s.r2 = fmaxf(r2_raw, 1e-12f);
  s.r = sqrtf(s.r2);
  s.q = s.r2 * s.r2 + c.a2 * rz * rz + 1e-20f;
  s.f = c.mass2 * s.r2 * s.r / s.q;
  s.den = s.r2 + c.a2;
  s.lx = (s.r * rx + c.a * ry) / s.den;
  s.ly = (s.r * ry - c.a * rx) / s.den;
  s.lz = rz / s.r;
  return s;
}

// dh/dx_i of h = -0.5 f lp^2 by the chain rule (bhx_torch/kerr.py:
// _dh_component, the same operations in the same order).
__device__ __forceinline__ float kerr_dh(float xi, float g_extra, float q_extra,
                                         float ex, float ey, float ez, float rx,
                                         float ry, float qx, float qy, float qz,
                                         float lp, const KerrScalars& s,
                                         const KerrConsts& c) {
  float dr2 = 0.5f * (2.0f * xi + (2.0f * s.b * xi + g_extra) / s.d);
  dr2 = s.free ? dr2 : 0.0f;
  const float dr = dr2 / (2.0f * s.r);
  const float dq = 2.0f * s.r2 * dr2 + q_extra;
  const float df = c.mass2 * (dr2 * s.r + s.r2 * dr) / s.q - s.f * dq / s.q;
  const float dlx = (dr * rx + ex) / s.den - s.lx * dr2 / s.den;
  const float dly = (dr * ry + ey) / s.den - s.ly * dr2 / s.den;
  const float dlz = ez / s.r - s.lz * dr / s.r;
  const float dlp = dlx * qx + dly * qy + dlz * qz;
  return -0.5f * df * lp * lp - s.f * lp * dlp;
}

// Hamilton's equations (bhx_torch/kerr.py:rhs_rows): dx = q - f lp l,
// dq = -dh/dx.  Returns r.
__device__ __forceinline__ float kerr_rhs(const float x[6], const KerrConsts& c,
                                          float k[6]) {
  const float rx = x[0], ry = x[1], rz = x[2], qx = x[3], qy = x[4], qz = x[5];
  const KerrScalars s = kerr_scalars(rx, ry, rz, c);
  const float lp = 1.0f + s.lx * qx + s.ly * qy + s.lz * qz;
  const float flp = s.f * lp;
  k[0] = qx - flp * s.lx;
  k[1] = qy - flp * s.ly;
  k[2] = qz - flp * s.lz;
  k[3] = -kerr_dh(rx, 0.0f, 0.0f, s.r, -c.a, 0.0f, rx, ry, qx, qy, qz, lp, s, c);
  k[4] = -kerr_dh(ry, 0.0f, 0.0f, c.a, s.r, 0.0f, rx, ry, qx, qy, qz, lp, s, c);
  k[5] = -kerr_dh(rz, c.a2x4 * rz, c.a2x2 * rz, 0.0f, 0.0f, 1.0f, rx, ry, qx, qy,
                  qz, lp, s, c);
  return s.r;
}

template <int kMode>
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
  float h = rays[6 * n + i];
  const float steps0 = rays[9 * n + i];
  float amount_ub = rays[8 * n + i];
  bool act = rays[7 * n + i] > 0.5f && steps0 < budget;

  // Kerr: the conjugate momentum and the hole's constants.
  float qx = 0.0f, qy = 0.0f, qz = 0.0f;
  KerrConsts kc{};
  float r_plus = 0.0f, inv_3m = 0.0f;
  if constexpr (kMode == kKerr) {
    qx = rays[(kInFields + 0) * n + i];
    qy = rays[(kInFields + 1) * n + i];
    qz = rays[(kInFields + 2) * n + i];
    const float spin = params[kSpin];
    kc.a = spin * mass;
    kc.a2 = kc.a * kc.a;
    kc.a2x4 = 4.0f * kc.a2;
    kc.a2x2 = 2.0f * kc.a2;
    kc.mass2 = 2.0f * mass;
    r_plus = mass * (1.0f + sqrtf(fminf(fmaxf(1.0f - spin * spin, 0.0f), 1.0f)));
    inv_3m = 1.0f / (3.0f * mass);
  }

  for (int f = 0; f < kMaxCrossings * kCrossFields; ++f)
    out[(kOutFixed + f) * n + i] = 0.0f;

  float ox = px - bx, oy = py - by, oz = pz - bz;
  float closest2 = ox * ox + oy * oy + oz * oz;
  float steps = 0.0f, count = 0.0f, horizon = 0.0f, exited = 0.0f;

  for (int it = 0; act && it < max_iterations; ++it) {
    const float rx = px - bx, ry = py - by, rz = pz - bz;
    float ndx, ndy, ndz, npx, npy, npz, h_used = h, h_next = h;
    float nqx = 0.0f, nqy = 0.0f, nqz = 0.0f;
    // The reference's ``applied``: the lanes whose proposal is taken.
    bool applied = true;
    bool hit_h;
    float t_h;

    if constexpr (kMode == kKerr) {
      // Hamiltonian RK4 with a field-strength-scaled step; the hit-test
      // direction is the chord of the step.
      const float x0[6] = {rx, ry, rz, qx, qy, qz};
      float k[6], xs[6], acc[6];
      const float r0 = kerr_rhs(x0, kc, k);
      const float t = r0 * inv_3m;
      const float hk = fminf(fmaxf(params[kStepSize] * t * sqrtf(t), 2e-3f), 1.0f);
      const float half = 0.5f * hk;
#pragma unroll
      for (int c = 0; c < 6; ++c) {
        acc[c] = k[c];
        xs[c] = x0[c] + half * k[c];
      }
      kerr_rhs(xs, kc, k);
#pragma unroll
      for (int c = 0; c < 6; ++c) {
        acc[c] = acc[c] + 2.0f * k[c];
        xs[c] = x0[c] + half * k[c];
      }
      kerr_rhs(xs, kc, k);
#pragma unroll
      for (int c = 0; c < 6; ++c) {
        acc[c] = acc[c] + 2.0f * k[c];
        xs[c] = x0[c] + hk * k[c];
      }
      kerr_rhs(xs, kc, k);
      const float sixth = hk * static_cast<float>(1.0 / 6.0);
#pragma unroll
      for (int c = 0; c < 6; ++c) xs[c] = x0[c] + sixth * (acc[c] + k[c]);
      const float sgx = xs[0] - rx, sgy = xs[1] - ry, sgz = xs[2] - rz;
      const float seg_len = sqrtf(sgx * sgx + sgy * sgy + sgz * sgz + 1e-24f);
      const float inv_seg = 1.0f / seg_len;
      ndx = sgx * inv_seg;
      ndy = sgy * inv_seg;
      ndz = sgz * inv_seg;
      npx = xs[0] + bx;
      npy = xs[1] + by;
      npz = xs[2] + bz;
      nqx = xs[3];
      nqy = xs[4];
      nqz = xs[5];
      h_used = seg_len;
      // Capture inside the outer horizon: a terminal hit at t = 0.
      hit_h = kerr_scalars(xs[0], xs[1], xs[2], kc).r <= r_plus;
      t_h = hit_h ? 0.0f : 1e9f;
    } else {
      const float cxv = ry * dz - rz * dy;
      const float cyv = rz * dx - rx * dz;
      const float czv = rx * dy - ry * dx;
      const float h2 = cxv * cxv + cyv * cyv + czv * czv;
      const float r2 = rx * rx + ry * ry + rz * rz;

      if constexpr (kMode == kEuler) {
        // Euler: dir += f h; normalize; pos += dir h, with the bending force
        // -1.5 h^2 r / |r|^5 (ray.wgsl:401-403, 467-480).
        const float ir = rsqrtf(r2 + 1e-12f);
        const float ir2 = ir * ir;
        const float a_s = m3 * h2 * (ir2 * ir2 * ir);
        const float vx = dx + a_s * rx * h;
        const float vy = dy + a_s * ry * h;
        const float vz = dz + a_s * rz * h;
        const float inv = rsqrtf(vx * vx + vy * vy + vz * vz + 1e-20f);
        ndx = vx * inv;
        ndy = vy * inv;
        ndz = vz * inv;
        npx = px + ndx * h;
        npy = py + ndy * h;
        npz = pz + ndz * h;
      } else {
        // Cash-Karp RK45 on the direction with a per-lane controller; a
        // rejected lane keeps its state and retries with h_next.
        float k1x, k1y, k1z, k2x, k2y, k2z, k3x, k3y, k3z;
        float k4x, k4y, k4z, k5x, k5y, k5z, k6x, k6y, k6z;
        accel(px, py, pz, bx, by, bz, m3, h2, &k1x, &k1y, &k1z);
        accel(px + (kA21 * k1x) * h, py + (kA21 * k1y) * h, pz + (kA21 * k1z) * h,
              bx, by, bz, m3, h2, &k2x, &k2y, &k2z);
        accel(px + (kA31 * k1x + kA32 * k2x) * h, py + (kA31 * k1y + kA32 * k2y) * h,
              pz + (kA31 * k1z + kA32 * k2z) * h, bx, by, bz, m3, h2, &k3x, &k3y,
              &k3z);
        accel(px + (kA41 * k1x + kA42 * k2x + kA43 * k3x) * h,
              py + (kA41 * k1y + kA42 * k2y + kA43 * k3y) * h,
              pz + (kA41 * k1z + kA42 * k2z + kA43 * k3z) * h, bx, by, bz, m3, h2,
              &k4x, &k4y, &k4z);
        accel(px + (kA51 * k1x + kA52 * k2x + kA53 * k3x + kA54 * k4x) * h,
              py + (kA51 * k1y + kA52 * k2y + kA53 * k3y + kA54 * k4y) * h,
              pz + (kA51 * k1z + kA52 * k2z + kA53 * k3z + kA54 * k4z) * h, bx, by,
              bz, m3, h2, &k5x, &k5y, &k5z);
        accel(px + (kA61 * k1x + kA62 * k2x + kA63 * k3x + kA64 * k4x + kA65 * k5x) * h,
              py + (kA61 * k1y + kA62 * k2y + kA63 * k3y + kA64 * k4y + kA65 * k5y) * h,
              pz + (kA61 * k1z + kA62 * k2z + kA63 * k3z + kA64 * k4z + kA65 * k5z) * h,
              bx, by, bz, m3, h2, &k6x, &k6y, &k6z);
        const float ix = kB1 * k1x + kB3 * k3x + kB4 * k4x + kB6 * k6x;
        const float iy = kB1 * k1y + kB3 * k3y + kB4 * k4y + kB6 * k6y;
        const float iz = kB1 * k1z + kB3 * k3z + kB4 * k4z + kB6 * k6z;
        const float ex = h * (kE1 * k1x + kE3 * k3x + kE4 * k4x + kE5 * k5x + kE6 * k6x);
        const float ey = h * (kE1 * k1y + kE3 * k3y + kE4 * k4y + kE5 * k5y + kE6 * k6y);
        const float ez = h * (kE1 * k1z + kE3 * k3z + kE4 * k4z + kE5 * k5z + kE6 * k6z);
        const float err = fmaxf(fabsf(ex), fmaxf(fabsf(ey), fabsf(ez)));
        const float ratio = err / params[kRtol];
        const bool accept = ratio <= 1.0f;
        // Controller without pow: ratio^-0.25 = rsqrt(rsqrt(ratio)).
        const float sr4 = params[kSafety] * rsqrtf(rsqrtf(ratio + 1e-12f));
        const float grow = fminf(fmaxf(sr4, 1.0f), params[kMaxF]);
        const float shrink = fminf(fmaxf(sr4, params[kMinF]), 1.0f);
        h_next = fminf(fmaxf(h * (accept ? grow : shrink), params[kHMin]), params[kHMax]);
        const float vx = dx + h * ix, vy = dy + h * iy, vz = dz + h * iz;
        const float inv = rsqrtf(vx * vx + vy * vy + vz * vz + 1e-20f);
        ndx = vx * inv;
        ndy = vy * inv;
        ndz = vz * inv;
        // The position advances along the old direction (reference parity).
        npx = px + dx * h;
        npy = py + dy * h;
        npz = pz + dz * h;
        applied = accept;
      }

      // Horizon sphere against [pos, pos + ndir * h].
      const float half_b = rx * ndx + ry * ndy + rz * ndz;
      const float disc4 = half_b * half_b - (r2 - horizon_r2);
      const float sq = sqrtf(fmaxf(disc4, 0.0f));
      const float t1 = -half_b - sq, t2 = -half_b + sq;
      const bool v1 = disc4 > 0.0f && t1 > 1e-8f && t1 < h_used;
      const bool v2 = disc4 > 0.0f && t2 > 1e-8f && t2 < h_used;
      t_h = v1 ? t1 : (v2 ? t2 : 1e9f);
      hit_h = v1 || v2;
    }
    bool horizon_first = hit_h;

    if (show_disk) {
      // Disk annulus plane hit (reference hit_torus2d, ray.wgsl:668-701).
      float denom = nx * ndx + ny * ndy + nz * ndz;
      if (fabsf(denom) < 1e-12f) denom = 1e-12f;
      const float t_d = ((bx - px) * nx + (by - py) * ny + (bz - pz) * nz) / denom;
      const float hx = px + ndx * t_d, hy = py + ndy * t_d, hz = pz + ndz * t_d;
      const float ex = hx - bx, ey = hy - by, ez = hz - bz;
      const float rr2 = ex * ex + ey * ey + ez * ez;
      const bool hit_d = t_d > 1e-8f && t_d < h_used && rr2 >= d_in2 && rr2 <= d_out2;
      // As the reference has it: a Kerr capture with the disk plane behind
      // the chord (t_d < 0) is not a horizon hit.
      horizon_first = horizon_first && t_h <= t_d;
      if (applied && hit_d && !horizon_first) {
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

    bool exited_now = false;
    if (applied) {
      px = npx;
      py = npy;
      pz = npz;
      dx = ndx;
      dy = ndy;
      dz = ndz;
      if constexpr (kMode == kKerr) {
        qx = nqx;
        qy = nqy;
        qz = nqz;
      }
      const float qx_ = px - bx, qy_ = py - by, qz_ = pz - bz;
      const float dist2 = qx_ * qx_ + qy_ * qy_ + qz_ * qz_;
      closest2 = fminf(closest2, dist2);
      exited_now = dist2 > rel_r2;
    }
    const bool hit_horizon = applied && horizon_first;
    const bool absorbed = hit_horizon || amount_ub < cutoff;
    if (hit_horizon) horizon = 1.0f;
    if (exited_now) exited = 1.0f;
    // Every active pass counts toward the budget, rejected ones included.
    steps += 1.0f;
    h = h_next;
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
  if constexpr (kMode == kKerr) {
    // The final momentum after the slot rows: a later round resumes from it.
    float* q = out + (kOutFixed + kMaxCrossings * kCrossFields) * n + i;
    q[0 * n] = qx;
    q[1 * n] = qy;
    q[2 * n] = qz;
  }
}

}  // namespace

extern "C" int bhx_march(const float* rays, const float* params, float* out,
                         int64_t n, int max_iterations, float tex_opacity_min,
                         int show_disk, int mode, cudaStream_t stream) {
  constexpr int kBlock = 128;
  const unsigned grid = static_cast<unsigned>((n + kBlock - 1) / kBlock);
  switch (mode) {
    case kEuler:
      march_kernel<kEuler><<<grid, kBlock, 0, stream>>>(
          rays, params, out, n, max_iterations, tex_opacity_min, show_disk);
      break;
    case kRk45:
      march_kernel<kRk45><<<grid, kBlock, 0, stream>>>(
          rays, params, out, n, max_iterations, tex_opacity_min, show_disk);
      break;
    case kKerr:
      march_kernel<kKerr><<<grid, kBlock, 0, stream>>>(
          rays, params, out, n, max_iterations, tex_opacity_min, show_disk);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* bhx_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

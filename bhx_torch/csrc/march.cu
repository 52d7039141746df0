// Geodesic march kernel: Euler and Cash-Karp RK45 under the
// pseudo-Newtonian force, and exact-Kerr Hamiltonian RK4, each with the
// disk branch.
//
// Replaces: the Pallas TPU kernel bhx/kernels/march_pallas.py:_kernel
// (launched by march_pallas), which inlines the substep of
// bhx/kernels/march_substep.py:78-340.  Computes the same function as its
// plain version bhx_torch/kernels/march.py:march_torch, bit for bit; the
// Kerr dH/dx is bhx_torch/kerr.py:_dh_component, written out by hand where
// the Pallas kernel takes it with jax.vjp.
//
// What bounds it on the card (the default frame's last ladder level, an
// NVIDIA H100, PERF.md section 6): a launch holds 2.07M lanes, ~15% of
// them live, clustered where the ladder re-traces.  A live ray runs up to
// max_iterations (2000) substeps of ~106 float operations (Euler), ~377
// (RK45) or ~922, 150 of them on the special-function unit (Kerr), each
// add and multiply issued alone (--fmad=false), so at half the fused
// rate.  The bound is the largest of those operations at that rate, the
// special-function ones at 16 a clock an SM, and the 51 (Kerr 57) rows
// in and out of every lane at the memory rate: Euler ~0.24 ms and RK45
// ~1.07 ms (operations), Kerr ~0.47 ms (special-function operations).
// The serial floor (the longest ray's substeps one after another, ~0.11 /
// 1.2 / 1.0 ms) lies below Euler's bound and above the others'; under
// RK45 the budget-capped rays inside the shadow (3.6% of them) run 2000
// substeps each.  A dead lane's pass-through output is ~0.22 ms of
// streaming writes.  One thread per lane in pixel order lost its issue
// slots to the lanes of a warp that idle until its longest ray is done,
// and started the longest rays late.
//
// What the design does about it: three kernels, no host sync.  The queue
// pass (march_queue_kernel) reads every lane's active and steps rows and
// appends the live lanes' indices to a queue in device memory, a block's
// in pixel order, with one atomicAdd a block: first the rays inside the
// shadow (impact parameter |r x d| under kNearHi x 3 sqrt(3) M) where they
// run longest, then the others -- longest first.  The march
// (march_kernel) is a grid of persistent warps, as many as the card holds,
// that drain the queue ("while-while" with replacement, Aila & Laine, HPG
// 2009): each lane marches one ray in registers; every kCheck substeps the
// warp counts its idle lanes with a ballot, and once kRefill of them are
// idle it fetches that many rays with one atomicAdd.  A retiring lane
// writes its output at its own index and zeroes only the slots it did not
// record.  The copy pass (march_copy_kernel) writes the dead lanes'
// pass-through output, one lane a thread; it runs on the caller's stream
// beside the queue pass and the march, which run on a stream of the
// highest priority, so the block scheduler seats the march first and the
// copy streams its bytes in the room and time the march leaves; the
// stream, the fork and join events and the grid size are made once per
// device.  What it leaves open: a launch with no live lane (the re-entry
// round of every ladder level) still pays for the queue pass and the
// fork beside the copy, and reads slower than one dense pass.  The
// substep is one __device__ function for the three branches (a template
// parameter, so each instantiation carries only its own state); its
// operations, their order and --fmad=false keep it bit-identical to the
// plain version, and a lane's output is a function of its own input row
// whatever thread marches it.  Rows are structure-of-arrays; the 21
// scalars come from a device pointer.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>
#include <mutex>

namespace {

constexpr int kOutFixed = 13;
constexpr int kCrossFields = 7;
constexpr int kMaxCrossings = 4;
constexpr int kInFields = 10;

// The kernel's branches (bhx_torch/kernels/march.py:KERNEL_NAMES).
constexpr int kEuler = 0;
constexpr int kRk45 = 1;
constexpr int kKerr = 2;

// Threads of a block of each kernel.
constexpr int kQueueBlock = 256;
constexpr int kCopyBlock = 128;
constexpr int kBlock = 128;
// Per branch (Euler, RK45, Kerr), tuned on the card (PERF.md section 6):
// the blocks of the march per SM that __launch_bounds__ asks the compiler
// to fit (its register cap), and that the march is launched with
// (copy-pass blocks, 128 threads of at most 32 registers, run beside it
// where its registers leave room, else in its tail); the substeps between
// two retirement checks of a warp.
constexpr int kMinBlocksEuler = 7;
constexpr int kMinBlocksRk45 = 7;
constexpr int kMinBlocksKerr = 5;
constexpr int kCheckEuler = 16;
constexpr int kCheckRk45 = 8;
constexpr int kCheckKerr = 4;
// The idle lanes at which a warp refills, in every branch.
constexpr int kRefill = 8;
// Longest first: the queue pass queues ahead of the others the live rays
// whose impact parameter |r x d| is at most kNearHi x 3 sqrt(3) M (0: no
// such bucket), the rays inside the shadow.  Under RK45 they run the
// longest, their controller shrinking the step toward the horizon up to
// the 2000-step budget; under Kerr too; Euler's rays all run about as
// long.
constexpr float kNearHiEuler = 0.0f;
constexpr float kNearHiRk45 = 1.05f;
constexpr float kNearHiKerr = 1.05f;

template <int kMode>
struct Tuning {
  static constexpr int min_blocks =
      kMode == kEuler ? kMinBlocksEuler : (kMode == kRk45 ? kMinBlocksRk45 : kMinBlocksKerr);
  static constexpr int check =
      kMode == kEuler ? kCheckEuler : (kMode == kRk45 ? kCheckRk45 : kCheckKerr);
  static constexpr float near_hi =
      kMode == kEuler ? kNearHiEuler : (kMode == kRk45 ? kNearHiRk45 : kNearHiKerr);
};

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

// The scalars of one launch, derived from the parameter vector once per
// thread as the first port derived them.
struct Consts {
  const float* params;
  float bx, by, bz, mass, horizon_r2, rel_r2, nx, ny, nz, d_in, d_out, d_in2,
      d_out2, inv_d_out, cutoff, budget, m3, tex_opacity_min;
  KerrConsts kc;
  float r_plus, inv_3m;
  int max_iterations, show_disk;
};

template <int kMode>
__device__ __forceinline__ Consts load_consts(const float* __restrict__ params,
                                              int max_iterations,
                                              float tex_opacity_min, int show_disk) {
  Consts c;
  c.params = params;
  c.bx = params[kBhX];
  c.by = params[kBhY];
  c.bz = params[kBhZ];
  c.mass = params[kMass];
  c.horizon_r2 = params[kHorizonR] * params[kHorizonR];
  c.rel_r2 = params[kRelR] * params[kRelR];
  c.nx = params[kDiskNx];
  c.ny = params[kDiskNy];
  c.nz = params[kDiskNz];
  c.d_in = params[kDiskInner];
  c.d_out = params[kDiskOuter];
  c.d_in2 = c.d_in * c.d_in;
  c.d_out2 = c.d_out * c.d_out;
  c.inv_d_out = 1.0f / c.d_out;
  c.cutoff = params[kCutoff];
  c.budget = params[kBudget];
  c.m3 = -3.0f * c.mass;
  c.tex_opacity_min = tex_opacity_min;
  c.kc = KerrConsts{};
  c.r_plus = 0.0f;
  c.inv_3m = 0.0f;
  if constexpr (kMode == kKerr) {
    const float spin = params[kSpin];
    c.kc.a = spin * c.mass;
    c.kc.a2 = c.kc.a * c.kc.a;
    c.kc.a2x4 = 4.0f * c.kc.a2;
    c.kc.a2x2 = 2.0f * c.kc.a2;
    c.kc.mass2 = 2.0f * c.mass;
    c.r_plus = c.mass * (1.0f + sqrtf(fminf(fmaxf(1.0f - spin * spin, 0.0f), 1.0f)));
    c.inv_3m = 1.0f / (3.0f * c.mass);
  }
  c.max_iterations = max_iterations;
  c.show_disk = show_disk;
  return c;
}

// One ray's march state; qx qy qz only under Kerr.
struct Ray {
  float px, py, pz, dx, dy, dz, h, amount_ub, steps0;
  float qx, qy, qz;
  float closest2, steps, count, horizon, exited;
};

// A lane's inputs, as the march starts from them.
template <int kMode>
__device__ __forceinline__ Ray load_ray(const float* __restrict__ rays, int64_t n,
                                        int64_t i, const Consts& c) {
  Ray s;
  s.px = rays[0 * n + i];
  s.py = rays[1 * n + i];
  s.pz = rays[2 * n + i];
  s.dx = rays[3 * n + i];
  s.dy = rays[4 * n + i];
  s.dz = rays[5 * n + i];
  s.h = rays[6 * n + i];
  s.amount_ub = rays[8 * n + i];
  s.steps0 = rays[9 * n + i];
  s.qx = s.qy = s.qz = 0.0f;
  if constexpr (kMode == kKerr) {
    s.qx = rays[(kInFields + 0) * n + i];
    s.qy = rays[(kInFields + 1) * n + i];
    s.qz = rays[(kInFields + 2) * n + i];
  }
  const float ox = s.px - c.bx, oy = s.py - c.by, oz = s.pz - c.bz;
  s.closest2 = ox * ox + oy * oy + oz * oz;
  s.steps = s.count = s.horizon = s.exited = 0.0f;
  return s;
}

// A lane's output: the fixed rows, zeros in the slots from ``first_zero``
// on (the ones it did not record), and under Kerr the final momentum after
// the slot rows (a later round resumes from it).
template <int kMode>
__device__ __forceinline__ void store_ray(const Ray& s, float* __restrict__ out,
                                          int64_t n, int64_t i, int first_zero) {
  out[kOPx * n + i] = s.px;
  out[kOPy * n + i] = s.py;
  out[kOPz * n + i] = s.pz;
  out[kODx * n + i] = s.dx;
  out[kODy * n + i] = s.dy;
  out[kODz * n + i] = s.dz;
  out[kOSteps * n + i] = s.steps;
  out[kOClosest * n + i] = sqrtf(s.closest2);
  out[kOHorizon * n + i] = s.horizon;
  out[kOExited * n + i] = s.exited;
  out[kOH * n + i] = s.h;
  out[kOAmount * n + i] = s.amount_ub;
  out[kOCount * n + i] = s.count;
  for (int f = first_zero * kCrossFields; f < kMaxCrossings * kCrossFields; ++f)
    out[(kOutFixed + f) * n + i] = 0.0f;
  if constexpr (kMode == kKerr) {
    float* q = out + (kOutFixed + kMaxCrossings * kCrossFields) * n + i;
    q[0 * n] = s.qx;
    q[1 * n] = s.qy;
    q[2 * n] = s.qz;
  }
}

// One substep of a live ray; a disk crossing is written to its slot of
// lane i at once.  Returns whether the ray marches on.
template <int kMode>
__device__ __forceinline__ bool substep(Ray& s, const Consts& c,
                                        float* __restrict__ out, int64_t n,
                                        int64_t i) {
  const float* __restrict__ params = c.params;
  const float bx = c.bx, by = c.by, bz = c.bz;
  const float px = s.px, py = s.py, pz = s.pz;
  const float dx = s.dx, dy = s.dy, dz = s.dz;
  const float h = s.h;
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
    const float x0[6] = {rx, ry, rz, s.qx, s.qy, s.qz};
    float k[6], xs[6], acc[6];
    const float r0 = kerr_rhs(x0, c.kc, k);
    const float t = r0 * c.inv_3m;
    const float hk = fminf(fmaxf(params[kStepSize] * t * sqrtf(t), 2e-3f), 1.0f);
    const float half = 0.5f * hk;
#pragma unroll
    for (int j = 0; j < 6; ++j) {
      acc[j] = k[j];
      xs[j] = x0[j] + half * k[j];
    }
    kerr_rhs(xs, c.kc, k);
#pragma unroll
    for (int j = 0; j < 6; ++j) {
      acc[j] = acc[j] + 2.0f * k[j];
      xs[j] = x0[j] + half * k[j];
    }
    kerr_rhs(xs, c.kc, k);
#pragma unroll
    for (int j = 0; j < 6; ++j) {
      acc[j] = acc[j] + 2.0f * k[j];
      xs[j] = x0[j] + hk * k[j];
    }
    kerr_rhs(xs, c.kc, k);
    const float sixth = hk * static_cast<float>(1.0 / 6.0);
#pragma unroll
    for (int j = 0; j < 6; ++j) xs[j] = x0[j] + sixth * (acc[j] + k[j]);
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
    hit_h = kerr_scalars(xs[0], xs[1], xs[2], c.kc).r <= c.r_plus;
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
      const float a_s = c.m3 * h2 * (ir2 * ir2 * ir);
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
      const float m3 = c.m3;
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
    const float disc4 = half_b * half_b - (r2 - c.horizon_r2);
    const float sq = sqrtf(fmaxf(disc4, 0.0f));
    const float t1 = -half_b - sq, t2 = -half_b + sq;
    const bool v1 = disc4 > 0.0f && t1 > 1e-8f && t1 < h_used;
    const bool v2 = disc4 > 0.0f && t2 > 1e-8f && t2 < h_used;
    t_h = v1 ? t1 : (v2 ? t2 : 1e9f);
    hit_h = v1 || v2;
  }
  bool horizon_first = hit_h;

  if (c.show_disk) {
    // Disk annulus plane hit (reference hit_torus2d, ray.wgsl:668-701).
    float denom = c.nx * ndx + c.ny * ndy + c.nz * ndz;
    if (fabsf(denom) < 1e-12f) denom = 1e-12f;
    const float t_d = ((bx - px) * c.nx + (by - py) * c.ny + (bz - pz) * c.nz) / denom;
    const float hx = px + ndx * t_d, hy = py + ndy * t_d, hz = pz + ndz * t_d;
    const float ex = hx - bx, ey = hy - by, ez = hz - bz;
    const float rr2 = ex * ex + ey * ey + ez * ez;
    const bool hit_d =
        t_d > 1e-8f && t_d < h_used && rr2 >= c.d_in2 && rr2 <= c.d_out2;
    // As the reference has it: a Kerr capture with the disk plane behind
    // the chord (t_d < 0) is not a horizon hit.
    horizon_first = horizon_first && t_h <= t_d;
    if (applied && hit_d && !horizon_first) {
      // Record the crossing in the next free slot (crossings past the
      // K-th are counted, not recorded).
      if (s.count < static_cast<float>(kMaxCrossings)) {
        float* slot = out + (kOutFixed + static_cast<int>(s.count) * kCrossFields) * n + i;
        slot[0 * n] = hx;
        slot[1 * n] = hy;
        slot[2 * n] = hz;
        slot[3 * n] = ndx;
        slot[4 * n] = ndy;
        slot[5 * n] = ndz;
        slot[6 * n] = 1.0f;
      }
      s.count += 1.0f;
      // Early-exit transmission bound: pow-free minorant
      // x^1.3 >= min(x, x^2) of the optical depth (30*dens)^1.3.
      const float irr = rsqrtf(rr2 + 1e-20f);
      const float rr = rr2 * irr;
      float dens = 1.0f - rr * c.inv_d_out;
      const float tt = fminf(fmaxf(rr - c.d_in, 0.0f), 1.0f);
      dens = dens * (tt * tt * (3.0f - 2.0f * tt));
      dens = fmaxf(dens * sqrtf(irr), 0.0f);
      const float x = 30.0f * dens;
      const float od_lb = x < 1.0f ? x * x : x;
      const float op_lb = fminf(fmaxf(od_lb * 0.2f, 0.0f), 1.0f) * c.tex_opacity_min;
      s.amount_ub = s.amount_ub * (1.0f - op_lb);
    }
  }

  bool exited_now = false;
  if (applied) {
    s.px = npx;
    s.py = npy;
    s.pz = npz;
    s.dx = ndx;
    s.dy = ndy;
    s.dz = ndz;
    if constexpr (kMode == kKerr) {
      s.qx = nqx;
      s.qy = nqy;
      s.qz = nqz;
    }
    const float qx_ = s.px - bx, qy_ = s.py - by, qz_ = s.pz - bz;
    const float dist2 = qx_ * qx_ + qy_ * qy_ + qz_ * qz_;
    s.closest2 = fminf(s.closest2, dist2);
    exited_now = dist2 > c.rel_r2;
  }
  const bool hit_horizon = applied && horizon_first;
  const bool absorbed = hit_horizon || s.amount_ub < c.cutoff;
  if (hit_horizon) s.horizon = 1.0f;
  if (exited_now) s.exited = 1.0f;
  // Every active pass counts toward the budget, rejected ones included.
  s.steps += 1.0f;
  s.h = h_next;
  // A live ray's steps count its passes, so they bound the loop as the
  // first port's pass counter did.
  return s.steps0 + s.steps < c.budget && !(exited_now || absorbed) &&
         s.steps < static_cast<float>(c.max_iterations);
}

constexpr unsigned kAllLanes = 0xffffffffu;

// The recorded slots of a ray: its crossings, at most K.
__device__ __forceinline__ int recorded(const Ray& s) {
  return static_cast<int>(fminf(s.count, static_cast<float>(kMaxCrossings)));
}

__device__ __forceinline__ bool is_live(const float* __restrict__ rays,
                                        const float* __restrict__ params, int64_t n,
                                        int64_t i, int max_iterations) {
  return rays[7 * n + i] > 0.5f && rays[9 * n + i] < params[kBudget] &&
         max_iterations > 0;
}

// Queue pass: the live lanes' indices, a block's in pixel order, one
// atomicAdd a block and bucket: the near-critical ones from the front of
// the queue (counters[0] counts them), the others from its back
// (counters[2]).
template <int kMode>
__global__ void __launch_bounds__(kQueueBlock) march_queue_kernel(
    const float* __restrict__ rays, const float* __restrict__ params,
    int* __restrict__ queue, int* __restrict__ counters, int64_t n,
    int max_iterations) {
  __shared__ int warp_base[2][kQueueBlock / 32];
  __shared__ int block_base[2];
  const int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const bool live = i < n && is_live(rays, params, n, i, max_iterations);
  bool near = false;
  if (Tuning<kMode>::near_hi > 0.0f && live) {
    // |r x d|^2 against (near_hi x 3 sqrt(3) M)^2.
    const float rx = rays[0 * n + i] - params[kBhX];
    const float ry = rays[1 * n + i] - params[kBhY];
    const float rz = rays[2 * n + i] - params[kBhZ];
    const float dx = rays[3 * n + i], dy = rays[4 * n + i], dz = rays[5 * n + i];
    const float cx = ry * dz - rz * dy, cy = rz * dx - rx * dz, cz = rx * dy - ry * dx;
    const float m = params[kMass] * Tuning<kMode>::near_hi;
    near = cx * cx + cy * cy + cz * cz <= 27.0f * m * m;
  }
  const unsigned masks[2] = {__ballot_sync(kAllLanes, live && near),
                             __ballot_sync(kAllLanes, live && !near)};
  if (lane == 0) {
    warp_base[0][warp] = __popc(masks[0]);
    warp_base[1][warp] = __popc(masks[1]);
  }
  __syncthreads();
  if (threadIdx.x < 2) {
    const int b = threadIdx.x;
    int total = 0;
    for (int w = 0; w < kQueueBlock / 32; ++w) {
      const int count = warp_base[b][w];
      warp_base[b][w] = total;
      total += count;
    }
    block_base[b] = total ? atomicAdd(&counters[b == 0 ? 0 : 2], total) : 0;
  }
  __syncthreads();
  if (live) {
    const int b = near ? 0 : 1;
    const int at =
        block_base[b] + warp_base[b][warp] + __popc(masks[b] & ((1u << lane) - 1u));
    queue[b == 0 ? at : static_cast<int>(n) - 1 - at] = static_cast<int>(i);
  }
}

// Entry ``at`` of the queue: the near bucket's first, then the others'.
__device__ __forceinline__ int queued_ray(const int* __restrict__ queue, int64_t n,
                                          int near, int at) {
  return queue[at < near ? at : static_cast<int>(n) - 1 - (at - near)];
}

// Copy pass: every dead lane's pass-through output, one lane a thread.
template <int kMode>
__global__ void __launch_bounds__(kCopyBlock, 2048 / kCopyBlock) march_copy_kernel(
    const float* __restrict__ rays, const float* __restrict__ params,
    float* __restrict__ out, int64_t n, int max_iterations) {
  const int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
  if (i >= n) return;
  if (is_live(rays, params, n, i, max_iterations)) return;
  const Consts c = load_consts<kMode>(params, max_iterations, 0.0f, 0);
  store_ray<kMode>(load_ray<kMode>(rays, n, i, c), out, n, i, 0);
}

// The march: persistent warps drain the queue.  Warp w first takes
// entries [32 w, 32 w + 32); later fetches come after all the first ones,
// from the head counters[1].  A lane marches its ray until it retires,
// writes its output, and idles until the warp refills.
template <int kMode>
__global__ void __launch_bounds__(kBlock, Tuning<kMode>::min_blocks) march_kernel(
    const float* __restrict__ rays, const float* __restrict__ params,
    float* __restrict__ out, const int* __restrict__ queue,
    int* __restrict__ counters, int64_t n, int max_iterations,
    float tex_opacity_min, int show_disk) {
  const int lane = threadIdx.x & 31;
  const unsigned lanes_before = (1u << lane) - 1u;
  const int near = counters[0];
  const int queued = near + counters[2];
  const int first = gridDim.x * (kBlock / 32) * 32;  // entries of the first fetches
  const Consts c = load_consts<kMode>(params, max_iterations, tex_opacity_min, show_disk);
  Ray s;
  int i = -1;  // this lane's ray, -1 while idle
  {
    const int at = (blockIdx.x * (kBlock / 32) + (threadIdx.x >> 5)) * 32 + lane;
    if (at < queued) {
      i = queued_ray(queue, n, near, at);
      s = load_ray<kMode>(rays, n, i, c);
    }
  }
  bool drained = first >= queued;  // the queue is empty (warp-uniform)
  for (;;) {
    unsigned idle = __ballot_sync(kAllLanes, i < 0);
    if (!drained && __popc(idle) >= kRefill) {
      const int want = __popc(idle);
      int base = 0;
      if (lane == 0) {
        // A plain read first: once the queue is empty, no more atomics.
        base = first + *static_cast<volatile int*>(&counters[1]);
        if (base < queued) base = first + atomicAdd(&counters[1], want);
      }
      base = __shfl_sync(kAllLanes, base, 0);
      drained = base + want >= queued;
      if (i < 0) {
        const int at = base + __popc(idle & lanes_before);
        if (at < queued) {
          i = queued_ray(queue, n, near, at);
          s = load_ray<kMode>(rays, n, i, c);
        }
      }
      idle = __ballot_sync(kAllLanes, i < 0);
    }
    // Idle with the queue empty: the warp is done.
    if (idle == kAllLanes && drained) return;
#pragma unroll 1
    for (int k = 0; k < Tuning<kMode>::check; ++k) {
      if (i >= 0 && !substep<kMode>(s, c, out, n, i)) {
        store_ray<kMode>(s, out, n, i, recorded(s));
        i = -1;
      }
    }
  }
}

// What the launches on one device reuse, made at its first launch: the
// march's stream, at the highest priority so that the block scheduler
// places the march's blocks ahead of the copy pass's; the two events that
// fork it from the caller's stream and join it back; the SM count; and
// each branch's march blocks per SM (0 until its first launch).
struct DeviceState {
  cudaStream_t fast = nullptr;
  cudaEvent_t forked = nullptr, marched = nullptr;
  int sms = 0;
  int per_sm[3] = {0, 0, 0};
};

constexpr int kMaxDevices = 64;
// Guards the states, and holds one launch's fork and join together when
// host threads launch at once (the events are shared).
std::mutex g_device_mu;
DeviceState g_devices[kMaxDevices];

// The state of device ``dev``, made if it is not yet; the caller holds
// g_device_mu.
cudaError_t device_state(int dev, DeviceState** state) {
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  DeviceState& d = g_devices[dev];
  if (!d.fast) {
    int least = 0, greatest = 0, sms = 0;
    cudaError_t err;
    if ((err = cudaDeviceGetStreamPriorityRange(&least, &greatest)) != cudaSuccess ||
        (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) !=
            cudaSuccess)
      return err;
    cudaEvent_t forked = nullptr, marched = nullptr;
    cudaStream_t fast = nullptr;
    if ((err = cudaEventCreateWithFlags(&forked, cudaEventDisableTiming)) != cudaSuccess ||
        (err = cudaEventCreateWithFlags(&marched, cudaEventDisableTiming)) != cudaSuccess ||
        (err = cudaStreamCreateWithPriority(&fast, cudaStreamNonBlocking, greatest)) !=
            cudaSuccess) {
      if (forked) cudaEventDestroy(forked);
      if (marched) cudaEventDestroy(marched);
      return err;
    }
    d.forked = forked;
    d.marched = marched;
    d.sms = sms;
    d.fast = fast;
  }
  *state = &d;
  return cudaSuccess;
}

// The copy pass on ``stream``; the queue pass and the march beside it on
// the march's stream, forked from ``stream`` and joined back into it, so
// that work queued on ``stream`` afterwards sees every output.
template <int kMode>
cudaError_t launch(const float* rays, const float* params, float* out, int* queue,
                   int* counters, int64_t n, int max_iterations,
                   float tex_opacity_min, int show_disk, cudaStream_t stream) {
  int dev = 0;
  cudaError_t err;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  std::lock_guard<std::mutex> hold(g_device_mu);
  DeviceState* d = nullptr;
  if ((err = device_state(dev, &d)) != cudaSuccess) return err;
  if (!d->per_sm[kMode]) {
    int per_sm = 0;
    if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &per_sm, march_kernel<kMode>, kBlock, 0)) != cudaSuccess)
      return err;
    d->per_sm[kMode] =
        per_sm < Tuning<kMode>::min_blocks ? per_sm : Tuning<kMode>::min_blocks;
  }
  cudaEventRecord(d->forked, stream);
  cudaStreamWaitEvent(d->fast, d->forked, 0);
  march_queue_kernel<kMode><<<static_cast<unsigned>((n + kQueueBlock - 1) / kQueueBlock),
                              kQueueBlock, 0, d->fast>>>(rays, params, queue, counters, n,
                                                         max_iterations);
  march_kernel<kMode><<<d->sms * d->per_sm[kMode], kBlock, 0, d->fast>>>(
      rays, params, out, queue, counters, n, max_iterations, tex_opacity_min, show_disk);
  cudaEventRecord(d->marched, d->fast);
  march_copy_kernel<kMode>
      <<<static_cast<unsigned>((n + kCopyBlock - 1) / kCopyBlock), kCopyBlock, 0, stream>>>(
          rays, params, out, n, max_iterations);
  cudaStreamWaitEvent(stream, d->marched, 0);
  return cudaGetLastError();
}

}  // namespace

// queue: n int32 of scratch; counters: 3 int32, zero on entry (the
// lengths of the queue's near and far buckets, and its head).
extern "C" int bhx_march(const float* rays, const float* params, float* out,
                         int* queue, int* counters, int64_t n, int max_iterations,
                         float tex_opacity_min, int show_disk, int mode,
                         cudaStream_t stream) {
  if (n < 0 || n > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return static_cast<int>(cudaSuccess);
  switch (mode) {
    case kEuler:
      return static_cast<int>(launch<kEuler>(rays, params, out, queue, counters, n,
                                             max_iterations, tex_opacity_min,
                                             show_disk, stream));
    case kRk45:
      return static_cast<int>(launch<kRk45>(rays, params, out, queue, counters, n,
                                            max_iterations, tex_opacity_min,
                                            show_disk, stream));
    case kKerr:
      return static_cast<int>(launch<kKerr>(rays, params, out, queue, counters, n,
                                            max_iterations, tex_opacity_min,
                                            show_disk, stream));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* bhx_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

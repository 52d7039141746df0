// Fused deferred disk shade + front-to-back composite, and its variant
// that writes the per-slot shading ingredients instead.
//
// Replaces: the Pallas TPU kernels bhx/kernels/shade_pallas.py:
// _composite_kernel (launched by _composite_pallas), with the per-slot
// ingredients of _slot_ingredients (:83-160) and the gain sample of
// _gain_bilinear_hat (:359-404); and _shade_kernel (launched by
// _ingredients_pallas), the ingredients alone.  Computes the same
// functions as their plain versions bhx_torch/kernels/shade.py:
// composite_torch and ingredients_torch.
//
// What bounds it on the card: compute on the few rays that crossed the
// disk.  A valid slot costs four Perlin octaves (16 lattice hashes), an
// atan2, a sin/cos pair, an exp/log pair and the tint polynomial; most
// rays of a frame have no valid slot and cost only their 29 loads and 4
// stores, which is memory traffic at streaming rate.  The ingredients
// variant shades every slot, valid or not (as the reference's jnp mirror
// does), and writes 28 rows: it is bound by the same compute on every
// slot.
//
// What the design does about it: one thread per ray, looping over the
// K = 4 slots; the composite skips invalid ones, so rays with no crossing
// pay only the loads.  The disk_gain grid is sampled with a direct
// clamp-addressed 2x2 fetch (the TPU kernel swept all 256 hat-basis cells
// because Mosaic has no gathers).  The 33 tint coefficients are computed
// once per device on the host and read through the read-only cache.  The
// two variants are one template, so they share the slot math.

#include <cuda_runtime.h>

#include <cstdint>

#include "procedural.cuh"

namespace {

constexpr int kSlotFields = 7;
constexpr int kMaxCrossings = 4;

// Shade parameter layout (bhx_torch/kernels/shade.py:_SP).
enum ShadeParam {
  kBhX = 0, kBhY, kBhZ, kMass, kDiskInner, kDiskOuter,
  kR00, kR01, kR02, kR10, kR11, kR12, kR20, kR21, kR22, kSpun
};

__device__ __forceinline__ float clamp01(float x) {
  return fminf(fmaxf(x, 0.0f), 1.0f);
}

// Shading ingredients of one slot: od, m, tint r g b, u, v (the order of
// the reference's ING rows).  m, u, v are 0 without the texture, the tints
// 1 without the redshift.
__device__ __forceinline__ void slot_ingredients(
    float hx, float hy, float hz, float dx, float dz, float cam_dist,
    const float* __restrict__ params, const float* __restrict__ coeffs,
    int show_texture, int show_redshift, float ing[7]) {
  // Optical depth (reference hit_black_hole disk branch, ray.wgsl:612-662).
  const float rx = hx - params[kBhX];
  const float ry = hy - params[kBhY];
  const float rz = hz - params[kBhZ];
  const float dist2 = rx * rx + ry * ry + rz * rz;
  const float inv_dist = rsqrtf(dist2 + 1e-20f);
  const float dist = dist2 * inv_dist;
  // Reference quirk kept: the first density factor uses |hit_point|.
  const float abs2 = hx * hx + hy * hy + hz * hz;
  const float abs_dist = abs2 * rsqrtf(abs2 + 1e-20f);
  const float d_in = params[kDiskInner], d_out = params[kDiskOuter];
  float density = 1.0f - abs_dist / d_out;
  const float tt = clamp01(dist - d_in);
  density = density * (tt * tt * (3.0f - 2.0f * tt));
  density = fmaxf(density * sqrtf(inv_dist), 0.0f);
  const float x = 30.0f * density;
  ing[0] = x > 0.0f ? expf(1.3f * logf(fmaxf(x, 1e-20f))) : 0.0f;

  ing[1] = ing[5] = ing[6] = 0.0f;
  if (show_texture) {
    const float r_norm = (dist - d_in) / (d_out - d_in);
    const float inv_outer = 1.0f / d_out;
    const float sx = rx * inv_outer, sy = ry * inv_outer, sz = rz * inv_outer;
    const float rot_x = params[kR00] * sx + params[kR01] * sy + params[kR02] * sz;
    const float rot_z = params[kR20] * sx + params[kR21] * sy + params[kR22] * sz;
    const bool degen = rot_x * rot_x + rot_z * rot_z < 1e-24f;
    const float spun = -atan2f(rot_z, degen ? 1.0f : rot_x) + params[kSpun];
    ing[5] = (sinf(spun) * r_norm + 1.0f) * 0.5f;
    ing[6] = (cosf(spun) * r_norm + 1.0f) * 0.5f;
    ing[1] = bhx::disk_texel_m(ing[5], ing[6]);
  }
  ing[2] = ing[3] = ing[4] = 1.0f;
  if (show_redshift) {
    // Doppler x gravitational shift of the 15000 K emitter.
    const float rhx = rx * inv_dist, rhz = rz * inv_dist;
    const float velocity = 0.6f * (dx * rhz - dz * rhx);
    const float doppler = sqrtf(fmaxf((1.0f - velocity) / (1.0f + velocity), 0.0f));
    const float rs = 2.0f * params[kMass];
    const float grav = sqrtf(fmaxf(
        (1.0f - rs / fmaxf(dist, rs + 1e-3f)) /
            (1.0f - rs / fmaxf(cam_dist, rs + 1e-3f)),
        0.0f));
    float shift = clamp01(grav * doppler);
    shift = shift * shift;
    ing[2] = bhx::tint(coeffs, 0, shift);
    ing[3] = bhx::tint(coeffs, 1, shift);
    ing[4] = bhx::tint(coeffs, 2, shift);
  }
}

// kIngredients: write the 7 ingredient rows of every slot, (K*7, N), and
// skip the composite; otherwise composite the valid slots into r, g, b,
// transmission, (4, N).
template <bool kIngredients>
__global__ void __launch_bounds__(128) shade_kernel(
    const float* __restrict__ slots, const float* __restrict__ cam,
    const float* __restrict__ params, const float* __restrict__ gain, int gh,
    int gw, const float* __restrict__ coeffs, float* __restrict__ out,
    int64_t n, int show_texture, int show_redshift) {
  const int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
  if (i >= n) return;

  const float cam_dist = cam[i];
  float acc_r = 0.0f, acc_g = 0.0f, acc_b = 0.0f, trans = 1.0f;

  for (int k = 0; k < kMaxCrossings; ++k) {
    const float* s = slots + static_cast<int64_t>(k * kSlotFields) * n + i;
    if constexpr (!kIngredients) {
      if (!(s[6 * n] > 0.5f)) continue;
    }
    float ing[7];
    slot_ingredients(s[0], s[1 * n], s[2 * n], s[3 * n], s[5 * n], cam_dist, params,
                     coeffs, show_texture, show_redshift, ing);
    if constexpr (kIngredients) {
#pragma unroll
      for (int f = 0; f < 7; ++f) out[static_cast<int64_t>(k * 7 + f) * n + i] = ing[f];
      continue;
    }
    const float od = ing[0], m = ing[1], u = ing[5], v = ing[6];

    float opacity = clamp01(od * 0.2f);
    float r = od, g = od, b = od;
    if (show_texture) {
      // Clamp-addressed bilinear disk_gain sample, texel centers at
      // (i + 0.5) / size.
      const float gxf = fminf(fmaxf(u * gw - 0.5f, 0.0f), gw - 1.0f);
      const float gyf = fminf(fmaxf(v * gh - 0.5f, 0.0f), gh - 1.0f);
      const float x0 = floorf(gxf), y0 = floorf(gyf);
      const float fx = gxf - x0, fy = gyf - y0;
      const int ix0 = static_cast<int>(x0), iy0 = static_cast<int>(y0);
      const int ix1 = min(ix0 + 1, gw - 1), iy1 = min(iy0 + 1, gh - 1);
      const float* c00 = gain + (iy0 * gw + ix0) * 4;
      const float* c10 = gain + (iy0 * gw + ix1) * 4;
      const float* c01 = gain + (iy1 * gw + ix0) * 4;
      const float* c11 = gain + (iy1 * gw + ix1) * 4;
      float ga[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float top = __ldg(c00 + c) * (1.0f - fx) + __ldg(c10 + c) * fx;
        const float bot = __ldg(c01 + c) * (1.0f - fx) + __ldg(c11 + c) * fx;
        ga[c] = top * (1.0f - fy) + bot * fy;
      }
      const float tex_a = m * ga[3];
      r = r * m * ga[0] * tex_a;
      g = g * m * ga[1] * tex_a;
      b = b * m * ga[2] * tex_a;
      opacity = opacity * clamp01(0.7f + tex_a * 0.5f);
    }
    if (show_redshift) {
      r = r * ing[2];
      g = g * ing[3];
      b = b * ing[4];
    }
    const float w = trans * opacity;
    acc_r = acc_r + w * clamp01(r);
    acc_g = acc_g + w * clamp01(g);
    acc_b = acc_b + w * clamp01(b);
    trans = trans * (1.0f - opacity);
  }

  if constexpr (!kIngredients) {
    out[0 * n + i] = acc_r;
    out[1 * n + i] = acc_g;
    out[2 * n + i] = acc_b;
    out[3 * n + i] = trans;
  }
}

}  // namespace

extern "C" int bhx_composite(const float* slots, const float* cam,
                             const float* params, const float* gain, int gh,
                             int gw, const float* coeffs, float* out, int64_t n,
                             int show_texture, int show_redshift,
                             cudaStream_t stream) {
  constexpr int kBlock = 128;
  const unsigned grid = static_cast<unsigned>((n + kBlock - 1) / kBlock);
  shade_kernel<false><<<grid, kBlock, 0, stream>>>(slots, cam, params, gain, gh, gw,
                                                  coeffs, out, n, show_texture,
                                                  show_redshift);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int bhx_ingredients(const float* slots, const float* cam,
                               const float* params, const float* coeffs, float* out,
                               int64_t n, int show_texture, int show_redshift,
                               cudaStream_t stream) {
  constexpr int kBlock = 128;
  const unsigned grid = static_cast<unsigned>((n + kBlock - 1) / kBlock);
  shade_kernel<true><<<grid, kBlock, 0, stream>>>(slots, cam, params, nullptr, 0, 0,
                                                 coeffs, out, n, show_texture,
                                                 show_redshift);
  return static_cast<int>(cudaGetLastError());
}

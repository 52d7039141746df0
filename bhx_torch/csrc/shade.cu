// Fused deferred disk shade + front-to-back composite, and the per-slot
// shading ingredients.
//
// Replaces: the Pallas TPU kernels of bhx/kernels/shade_pallas.py:
// _composite_kernel (launched by _composite_pallas), with the per-slot
// ingredients of _slot_ingredients (:83-160) and the gain sample of
// _gain_bilinear_hat (:359-404), by shade_composite_kernel; and
// _shade_kernel (launched by _ingredients_pallas), the ingredients alone,
// by shade_ingredients_kernel.  Computes the same functions as their plain
// versions bhx_torch/kernels/shade.py: composite_torch and
// ingredients_torch, bit for bit.
//
// What bounds them on the card.  The composite is bound by bytes: every
// ray's four valid rows are read and its four output rows written, while
// only ~13% of a frame's rays hold a valid slot.  Its shading of those
// (four Perlin octaves, two atan2s, two sin/cos pairs, an exp/log pair,
// seven IEEE divisions and the tint polynomial) issues more than twice the
// instructions its ~1,000 float operations count, so on an H100 it takes
// nearly as long as the stream, and the two only partly overlap.  One
// thread per ray would already shade at ~0.8 SIMT efficiency, because the
// crossing rays lie in runs; what it loses is the stream, when each valid
// row is read behind the previous slot's branch, one load in flight a
// thread.  The ingredients variant shades every slot, valid or not (as
// the reference's jnp mirror does), and is bound by that compute.
//
// What the design does about it.  A composite block owns 256 consecutive
// rays.  (a) Each thread issues its ray's four valid loads at once; a
// block whose rays have no valid slot (most of a frame's) writes
// (0, 0, 0, 1) after one __syncthreads_or and leaves.  Otherwise the block
// lists its valid (ray, slot) pairs in shared memory, slot-major, by one
// ballot a warp and slot and a scan of the 32 warp counts.  (b) All
// threads walk that list, each entry loading its slot's five geometry
// rows and its ray's camera distance (read only for rays with a
// crossing), shading it, and leaving opacity and the clamped colour in
// shared memory: the shading runs packed, a ray's crossings side by side.
// (c) Each thread composites its own ray's valid slots front to back in
// slot order, with the plain version's operations in its order, and
// writes the four rows.  The ingredients kernel runs one thread per
// (slot, ray), slot in blockIdx.y, writing its 7 rows coalesced across
// rays: four times the threads of a thread per ray and a quarter of the
// chain each, so a 640x361 batch is ~4.6 waves instead of 1.14 and its
// tail is short.  Both kernels shade a slot with the one per-slot stage
// (slot_stage).  The disk_gain grid is sampled with a direct
// clamp-addressed 2x2 fetch (the TPU kernel swept all 256 hat-basis cells
// because Mosaic has no gathers).  The 33 tint coefficients are computed
// once per device on the host and read through the read-only cache.

#include <cuda_runtime.h>

#include <cstdint>

#include "procedural.cuh"

namespace {

constexpr int kSlotFields = 7;
constexpr int kMaxCrossings = 4;
constexpr int kBlockRays = 256;  // composite: rays a block
constexpr int kWarps = kBlockRays / 32;
constexpr int kIngredientsBlock = 128;
static_assert(kMaxCrossings * kWarps == 32, "one warp scans the block's counts");
static_assert(kBlockRays == 256, "a list entry is (slot << 8) | ray");

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
    // One reduction for the pair; the same bits as sinf and cosf.
    float sin_spun, cos_spun;
    sincosf(spun, &sin_spun, &cos_spun);
    ing[5] = (sin_spun * r_norm + 1.0f) * 0.5f;
    ing[6] = (cos_spun * r_norm + 1.0f) * 0.5f;
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

// The per-slot stage of both kernels: slot k of ray i, its five geometry
// rows and the ray's camera distance read, shaded into its ingredients.
__device__ __forceinline__ void slot_stage(
    const float* __restrict__ slots, const float* __restrict__ cam, int64_t n,
    int64_t i, int k, const float* __restrict__ params,
    const float* __restrict__ coeffs, int show_texture, int show_redshift,
    float ing[7]) {
  const float* s = slots + static_cast<int64_t>(k * kSlotFields) * n + i;
  slot_ingredients(s[0], s[n], s[2 * n], s[3 * n], s[5 * n], cam[i], params, coeffs,
                   show_texture, show_redshift, ing);
}

// A valid slot's contribution to the composite: its opacity and its
// clamped r, g, b (the disk_gain sample and the tint applied).
__device__ __forceinline__ void slot_blend(
    const float ing[7], const float* __restrict__ gain, int gh, int gw,
    int show_texture, int show_redshift, float blend[4]) {
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
  blend[0] = opacity;
  blend[1] = clamp01(r);
  blend[2] = clamp01(g);
  blend[3] = clamp01(b);
}

// The valid slots of a block of kBlockRays rays, composited into r, g, b,
// transmission, (4, N).
__global__ void __launch_bounds__(kBlockRays) shade_composite_kernel(
    const float* __restrict__ slots, const float* __restrict__ cam,
    const float* __restrict__ params, const float* __restrict__ gain, int gh,
    int gw, const float* __restrict__ coeffs, float* __restrict__ out,
    int64_t n, int show_texture, int show_redshift) {
  __shared__ float blended[4][kMaxCrossings][kBlockRays];
  __shared__ uint16_t entries[kMaxCrossings * kBlockRays];
  __shared__ int counts[kMaxCrossings * kWarps];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int64_t base = static_cast<int64_t>(blockIdx.x) * kBlockRays;
  const int64_t i = base + t;
  const bool in_range = i < n;

  // (a) The four valid rows, loaded together; the block's valid slots
  // listed slot-major, a warp's in lane order.
  float valid_row[kMaxCrossings];
#pragma unroll
  for (int k = 0; k < kMaxCrossings; ++k) {
    valid_row[k] = in_range ? slots[static_cast<int64_t>(k * kSlotFields + 6) * n + i] : 0.0f;
  }
  unsigned valid = 0;
#pragma unroll
  for (int k = 0; k < kMaxCrossings; ++k) {
    valid |= static_cast<unsigned>(valid_row[k] > 0.5f) << k;
  }
  // Most blocks of a frame have no valid slot: they write transmission 1
  // and leave.
  if (!__syncthreads_or(valid != 0u)) {
    if (in_range) {
      out[0 * n + i] = 0.0f;
      out[1 * n + i] = 0.0f;
      out[2 * n + i] = 0.0f;
      out[3 * n + i] = 1.0f;
    }
    return;
  }
  unsigned ballots[kMaxCrossings];
#pragma unroll
  for (int k = 0; k < kMaxCrossings; ++k) {
    ballots[k] = __ballot_sync(0xffffffffu, (valid >> k) & 1u);
  }
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < kMaxCrossings; ++k) counts[k * kWarps + warp] = __popc(ballots[k]);
  }
  __syncthreads();
  // Every warp scans the 32 counts itself: lane l holds the inclusive sum
  // up to count l, in slot-major order.
  const int count = counts[lane];
  int upto = count;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int x = __shfl_up_sync(0xffffffffu, upto, d);
    if (lane >= d) upto += x;
  }
  const int total = __shfl_sync(0xffffffffu, upto, 31);
  const unsigned lanes_below = (1u << lane) - 1u;
#pragma unroll
  for (int k = 0; k < kMaxCrossings; ++k) {
    const int start = __shfl_sync(0xffffffffu, upto - count, k * kWarps + warp);
    if ((valid >> k) & 1u) {
      entries[start + __popc(ballots[k] & lanes_below)] =
          static_cast<uint16_t>((k << 8) | t);
    }
  }
  __syncthreads();

  // (b) The listed slots shaded, packed across the block.
  for (int e = t; e < total; e += kBlockRays) {
    const int entry = entries[e];
    const int ray = entry & (kBlockRays - 1), k = entry >> 8;
    float ing[7], blend[4];
    slot_stage(slots, cam, n, base + ray, k, params, coeffs, show_texture, show_redshift, ing);
    slot_blend(ing, gain, gh, gw, show_texture, show_redshift, blend);
#pragma unroll
    for (int f = 0; f < 4; ++f) blended[f][k][ray] = blend[f];
  }
  __syncthreads();

  // (c) This ray's valid slots composited front to back.
  if (!in_range) return;
  float acc_r = 0.0f, acc_g = 0.0f, acc_b = 0.0f, trans = 1.0f;
#pragma unroll
  for (int k = 0; k < kMaxCrossings; ++k) {
    if (!((valid >> k) & 1u)) continue;
    const float opacity = blended[0][k][t];
    const float w = trans * opacity;
    acc_r = acc_r + w * blended[1][k][t];
    acc_g = acc_g + w * blended[2][k][t];
    acc_b = acc_b + w * blended[3][k][t];
    trans = trans * (1.0f - opacity);
  }
  out[0 * n + i] = acc_r;
  out[1 * n + i] = acc_g;
  out[2 * n + i] = acc_b;
  out[3 * n + i] = trans;
}

// The 7 ingredient rows of slot blockIdx.y of every ray, valid or not:
// rows k * 7 + f of a (K * 7, N) tensor.
__global__ void __launch_bounds__(kIngredientsBlock) shade_ingredients_kernel(
    const float* __restrict__ slots, const float* __restrict__ cam,
    const float* __restrict__ params, const float* __restrict__ coeffs,
    float* __restrict__ out, int64_t n, int show_texture, int show_redshift) {
  const int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
  if (i >= n) return;
  const int k = blockIdx.y;
  float ing[7];
  slot_stage(slots, cam, n, i, k, params, coeffs, show_texture, show_redshift, ing);
#pragma unroll
  for (int f = 0; f < 7; ++f) out[static_cast<int64_t>(k * 7 + f) * n + i] = ing[f];
}

}  // namespace

extern "C" int bhx_composite(const float* slots, const float* cam,
                             const float* params, const float* gain, int gh,
                             int gw, const float* coeffs, float* out, int64_t n,
                             int show_texture, int show_redshift,
                             cudaStream_t stream) {
  const unsigned grid = static_cast<unsigned>((n + kBlockRays - 1) / kBlockRays);
  shade_composite_kernel<<<grid, kBlockRays, 0, stream>>>(
      slots, cam, params, gain, gh, gw, coeffs, out, n, show_texture, show_redshift);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int bhx_ingredients(const float* slots, const float* cam,
                               const float* params, const float* coeffs, float* out,
                               int64_t n, int show_texture, int show_redshift,
                               cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>((n + kIngredientsBlock - 1) / kIngredientsBlock),
                  kMaxCrossings);
  shade_ingredients_kernel<<<grid, kIngredientsBlock, 0, stream>>>(
      slots, cam, params, coeffs, out, n, show_texture, show_redshift);
  return static_cast<int>(cudaGetLastError());
}

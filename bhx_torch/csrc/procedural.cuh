// Device math shared by shade.cu and sky.cu: the lattice hash, Perlin
// noise, the accretion-disk texel, the blackbody tint polynomial and the
// procedural sky radiance.  Operation for operation the plain torch
// versions in bhx_torch/procedural.py (themselves the counterparts of
// bhx/procedural.py), in float32, with libdevice atan2f/sinf/cosf.
#pragma once

#include <cstdint>

namespace bhx {

constexpr float kPi = 3.1415926f;  // reference constant (ray.wgsl:131)
constexpr int kTintDeg = 10;       // tint polynomial degree; 11 coeffs / channel

// 2x32-bit integer mix; signed lattice coordinates wrap as two's complement
// and every product wraps mod 2^32 in uint32_t.
static __device__ __forceinline__ uint32_t hash2(int ix, int iy) {
  uint32_t a = static_cast<uint32_t>(ix);
  uint32_t b = static_cast<uint32_t>(iy);
  a *= 0x9E3779B1u;
  b ^= (a << 16) | (a >> 16);
  b *= 0x85EBCA77u;
  a ^= (b << 16) | (b >> 16);
  a *= 0xC2B2AE3Du;
  return a;
}

// Uniform [0,1) from the top 24 bits (exact in float32).
static __device__ __forceinline__ float hash01(int ix, int iy) {
  return static_cast<float>(static_cast<int>(hash2(ix, iy) >> 8)) *
         (1.0f / 16777216.0f);
}

static __device__ __forceinline__ float fade(float t) {
  return ((t * 6.0f - 15.0f) * t + 10.0f) * t * t * t;
}

static __device__ __forceinline__ float grad_dot(int ix, int iy, float ox,
                                                 float oy) {
  const float scale = static_cast<float>(2.0 / 65535.0);
  uint32_t h = hash2(ix, iy);
  float gx = static_cast<float>(static_cast<int>(h & 0xFFFFu)) * scale - 1.0f;
  float gy = static_cast<float>(static_cast<int>(h >> 16)) * scale - 1.0f;
  float inv = rsqrtf(gx * gx + gy * gy + 1e-12f);
  return ox * (gx * inv) + oy * (gy * inv);
}

// Perlin noise in [0,1].
static __device__ __forceinline__ float perlin(float x, float y) {
  float x0 = floorf(x);
  float y0 = floorf(y);
  float sx = x - x0;
  float sy = y - y0;
  int xi = static_cast<int>(x0);
  int yi = static_cast<int>(y0);
  float n00 = grad_dot(xi, yi, sx, sy);
  float n10 = grad_dot(xi + 1, yi, sx - 1.0f, sy);
  float n01 = grad_dot(xi, yi + 1, sx, sy - 1.0f);
  float n11 = grad_dot(xi + 1, yi + 1, sx - 1.0f, sy - 1.0f);
  float u = fade(sx);
  float v = fade(sy);
  float nx0 = n00 + (n10 - n00) * u;
  float nx1 = n01 + (n11 - n01) * u;
  float val = nx0 + (nx1 - nx0) * v;
  return val * 0.5f + 0.5f;
}

// Texel value m of the procedural accretion texture at uv: polar, spiral
// unwarp theta += sqrt(r) * 2 pi, then the 50/50 cascade of 4 octaves.
static __device__ __forceinline__ float disk_texel_m(float u, float v) {
  float rx = u * 2.0f - 1.0f;
  float ry = v * 2.0f - 1.0f;
  float r2 = rx * rx + ry * ry;
  float r = sqrtf(r2 + 1e-20f);
  // Degenerate-center guard (atan2(0, 0) -> atan2(0, 1), same value).
  float theta = atan2f(ry, r2 < 1e-24f ? 1.0f : rx) +
                sqrtf(r) * static_cast<float>(3.141592653589793 * 2.0);
  float sin_t, cos_t;  // one reduction; the same bits as sinf and cosf
  sincosf(theta, &sin_t, &cos_t);
  float sx = r * cos_t * 0.5f + 0.5f;
  float sy = r * sin_t * 0.5f + 0.5f;
  float o0 = perlin(sx * 4.0f, sy * 4.0f);
  float o1 = perlin(sx * 20.0f + 31.0f, sy * 20.0f + 7.0f);
  float o2 = perlin(sx * 50.0f + 101.0f, sy * 50.0f + 53.0f);
  float o3 = perlin(sx * 100.0f + 211.0f, sy * 100.0f + 157.0f);
  float m = 0.5f * o3 + 0.5f * o2;
  m = 0.5f * m + 0.5f * o1;
  return 0.5f * m + 0.5f * o0;
}

// Blackbody tint of channel ch: Horner evaluation of the fit, clamped.
// coeffs: 3 x (kTintDeg + 1) floats, highest power first.
static __device__ __forceinline__ float tint(const float* __restrict__ coeffs,
                                             int ch, float shift) {
  float s = fminf(fmaxf(shift, 0.0f), 1.0f);
  const float* c = coeffs + ch * (kTintDeg + 1);
  float acc = __ldg(c);
#pragma unroll
  for (int k = 1; k <= kTintDeg; ++k) acc = acc * s + __ldg(c + k);
  return fminf(fmaxf(acc, 0.0f), 1.0f);
}

// HDR sky radiance at equirect uv: two-octave Perlin nebula plus a
// 256 x 128 hash cell grid of stars, 3x3 neighbourhood, quadratic splat.
static __device__ __forceinline__ void sky_radiance(
    float u, float v, const float* __restrict__ coeffs, float* r, float* g,
    float* b) {
  constexpr int kCellsX = 256;
  constexpr int kCellsY = 128;
  const float inv_r2 = static_cast<float>(1.0 / (0.0024 * 0.0024));
  const float pi = static_cast<float>(3.141592653589793);

  float neb = perlin(u * 6.0f, v * 3.0f) * 0.6f +
              perlin(u * 24.0f + 91.0f, v * 12.0f + 17.0f) * 0.4f;
  neb = fmaxf(neb - 0.35f, 0.0f) * 0.9f;
  float out_r = neb * 0.45f;
  float out_g = neb * 0.35f;
  float out_b = neb * 0.65f;

  float gx = u * static_cast<float>(kCellsX);
  float gy = v * static_cast<float>(kCellsY);
  int cx0 = static_cast<int>(floorf(gx));
  int cy0 = static_cast<int>(floorf(gy));
  for (int oy = -1; oy <= 1; ++oy) {
    for (int ox = -1; ox <= 1; ++ox) {
      int cx = cx0 + ox;
      int cy = cy0 + oy;
      int cxw = cx & (kCellsX - 1);
      bool row_ok = cy >= 0 && cy < kCellsY;
      float h0 = hash01(cxw * 3 + 1, cy * 7 + 11);
      float h1 = hash01(cxw * 5 + 29, cy * 3 + 41);
      float h2 = hash01(cxw * 7 + 97, cy * 11 + 61);
      float h3 = hash01(cxw * 11 + 13, cy * 13 + 17);
      float cell_v = (static_cast<float>(cy) + 0.5f) / static_cast<float>(kCellsY);
      float sin_t = sinf(pi * fminf(fmaxf(cell_v, 0.0f), 1.0f));
      bool present = (h0 < 0.22f * sin_t) && row_ok;
      if (!present) continue;
      float su = (static_cast<float>(cx) + h1) / static_cast<float>(kCellsX);
      float sv = (static_cast<float>(cy) + h2) / static_cast<float>(kCellsY);
      float du = u - su;
      float dv = v - sv;
      float d2 = du * du + dv * dv;
      float w = fmaxf(1.0f - d2 * inv_r2, 0.0f);
      w = w * w;
      if (w == 0.0f) continue;
      float h32 = h3 * h3;
      float h34 = h32 * h32;
      float amp = w * ((h34 * h34) * 3.0f + 0.3f);
      float s_shift = 0.2f + 0.6f * hash01(cxw * 17 + 23, cy * 19 + 5);
      out_r += amp * tint(coeffs, 0, s_shift);
      out_g += amp * tint(coeffs, 1, s_shift);
      out_b += amp * tint(coeffs, 2, s_shift);
    }
  }
  *r = out_r;
  *g = out_g;
  *b = out_b;
}

}  // namespace bhx

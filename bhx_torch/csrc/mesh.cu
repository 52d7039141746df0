// M1: a batch of rays against one triangle mesh -> the nearest hit's
// (t, hit, color rgb, geometric normal xyz), as (8, N) float32 rows.
//
// Replaces: bhx/geometry/traverse.py:_intersect_bvh (:143-234, the lockstep
// BVH traversal) and _intersect_brute (:98-140, chunked brute force), which
// the reference writes in jnp (no Pallas kernel: XLA runs the lockstep
// while_loop on the TPU).  Computes the same function as its plain version
// bhx_torch/geometry/traverse.py:intersect_mesh_torch, bit for bit: the
// triangle and box tests repeat bhx_torch/geometry/intersect.py's
// operations in their order (built with --fmad=false).
//
// What bounds it on the card: for a large mesh, the traversal's dependent
// loads (node, then its two child boxes, then a leaf's triangle indices,
// then their vertices) and its divergence: each ray walks its own path,
// and the lanes of a warp visit different numbers of nodes.  The work it
// must do (box and triangle tests) is small against the card's float rate;
// the rays in and hits out are the bytes.  For a small mesh, the triangle
// tests.
//
// What the design does about it: one thread per ray, sequential, with the
// per-ray stack (48 int32) in local memory, so a ray never waits for the
// others as the lockstep loop's lanes do, and no iteration touches a lane
// that is done; rays that are inactive, or miss the root box, write a miss
// and leave.  The ray is read once and the hit written once.  A mesh of at
// most 512 triangles (the brute-force branch) is staged world-positioned in
// shared memory (512 x 18 floats = 36 KB) by each block, and every thread
// scans it in index order; all lanes read the same triangle at once, a
// broadcast.  Not done yet: warp-coherent traversal, a wide BVH, ray
// sorting.
//
// Rules kept from the lockstep traversal: the near child first (d1 <= d2),
// the far child pushed only if d_far < best_t, the stack pointer clamped
// at its last entry, at most 4 triangles tested in a leaf, a hit taken
// only if strictly nearer, inv_dir guarded at 1e-12, and the root-box
// early out.  In brute force the first index of the least t wins, as the
// reference's chunked argmin.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr float kMissT = 1e8f;
constexpr float kTMin = 1e-8f;
constexpr float kTMax = 1e5f;
constexpr int kStackDepth = 48;
constexpr int kLeafTests = 4;
constexpr int kBruteMax = 512;
constexpr int kTriFloats = 18;  // p1 p2 p3 n1 n2 n3
constexpr int kBlock = 128;

struct Ray {
  float ox, oy, oz, dx, dy, dz;
};

struct Best {
  float t, cr, cg, cb, nx, ny, nz;
};

struct MeshArgs {
  const float* points;
  const float* normals;
  const int* tri_points;
  const int* tri_normals;
  const float* node_min;
  const float* node_max;
  const int* node_left;
  const int* node_count;
  const int* lookup;
  const float* position;
};

// a . (b x c), summed x + y + z (intersect.py:_det3).
__device__ __forceinline__ float det3(float ax, float ay, float az, float bx,
                                      float by, float bz, float cx, float cy,
                                      float cz) {
  return (ax * (by * cz - bz * cy) + ay * (bz * cx - bx * cz)) +
         az * (bx * cy - by * cx);
}

// hit_triangles on one world-positioned triangle `tri`; takes the hit into
// `best` if it is strictly nearer.
__device__ __forceinline__ void test_triangle(const Ray& r, const float* tri,
                                              Best* best) {
  const float ax = tri[0], ay = tri[1], az = tri[2];
  const float bx = tri[3], by = tri[4], bz = tri[5];
  const float cx = tri[6], cy = tri[7], cz = tri[8];
  const float abx = bx - ax, aby = by - ay, abz = bz - az;
  const float acx = cx - ax, acy = cy - ay, acz = cz - az;
  float gx = aby * acz - abz * acy;
  float gy = abz * acx - abx * acz;
  float gz = abx * acy - aby * acx;
  const float inv = 1.0f / (sqrtf((gx * gx + gy * gy) + gz * gz) + 1e-20f);
  gx = gx * inv;
  gy = gy * inv;
  gz = gz * inv;
  const float ray_dot = (r.dx * gx + r.dy * gy) + r.dz * gz;
  const float mbx = ax - bx, mby = ay - by, mbz = az - bz;
  const float mcx = ax - cx, mcy = ay - cy, mcz = az - cz;
  const float mox = ax - r.ox, moy = ay - r.oy, moz = az - r.oz;
  const float denom = det3(r.dx, r.dy, r.dz, mbx, mby, mbz, mcx, mcy, mcz);
  const float safe = fabsf(denom) < 1e-12f ? 1e-12f : denom;
  const float u = det3(r.dx, r.dy, r.dz, mox, moy, moz, mcx, mcy, mcz) / safe;
  const float v = det3(r.dx, r.dy, r.dz, mbx, mby, mbz, mox, moy, moz) / safe;
  const float t = det3(mox, moy, moz, mbx, mby, mbz, mcx, mcy, mcz) / safe;
  const bool hit = fabsf(ray_dot) >= 1e-5f && fabsf(denom) >= 1e-5f &&
                   u >= 0.0f && u <= 1.0f && v >= 0.0f && u + v <= 1.0f &&
                   t > kTMin && t < kTMax;
  if (!(hit && t < best->t)) return;
  const float w = (1.0f - u) - v;
  best->t = t;
  best->cr = -((w * tri[9] + u * tri[12]) + v * tri[15]) * 0.5f + 0.5f;
  best->cg = -((w * tri[10] + u * tri[13]) + v * tri[16]) * 0.5f + 0.5f;
  best->cb = -((w * tri[11] + u * tri[14]) + v * tri[17]) * 0.5f + 0.5f;
  const bool flip = ray_dot > 0.0f;
  best->nx = flip ? -gx : gx;
  best->ny = flip ? -gy : gy;
  best->nz = flip ? -gz : gz;
}

// Triangle `tri` of the mesh, vertices offset by the mesh position.
__device__ __forceinline__ void load_triangle(const MeshArgs& m, int tri,
                                              const float pos[3],
                                              float* out) {
  for (int k = 0; k < 3; ++k) {
    const int p = m.tri_points[3 * tri + k];
    const int q = m.tri_normals[3 * tri + k];
    for (int c = 0; c < 3; ++c) {
      out[3 * k + c] = m.points[3 * p + c] + pos[c];
      out[9 + 3 * k + c] = m.normals[3 * q + c];
    }
  }
}

// hit_aabb on node `node`'s box, offset by the mesh position.
__device__ __forceinline__ float hit_box(const Ray& r, float ix, float iy,
                                         float iz, const MeshArgs& m, int node,
                                         const float pos[3]) {
  const float* lo = m.node_min + 3 * node;
  const float* hi = m.node_max + 3 * node;
  const float t1x = ((lo[0] + pos[0]) - r.ox) * ix;
  const float t1y = ((lo[1] + pos[1]) - r.oy) * iy;
  const float t1z = ((lo[2] + pos[2]) - r.oz) * iz;
  const float t2x = ((hi[0] + pos[0]) - r.ox) * ix;
  const float t2y = ((hi[1] + pos[1]) - r.oy) * iy;
  const float t2z = ((hi[2] + pos[2]) - r.oz) * iz;
  const float t_near =
      fmaxf(fmaxf(fminf(t1x, t2x), fminf(t1y, t2y)), fminf(t1z, t2z));
  const float t_far =
      fminf(fminf(fmaxf(t1x, t2x), fmaxf(t1y, t2y)), fmaxf(t1z, t2z));
  return (t_near > t_far || t_far < 0.0f) ? kMissT : t_near;
}

__device__ __forceinline__ Ray load_ray(const float* origin,
                                        const float* direction, int64_t i) {
  return Ray{origin[3 * i], origin[3 * i + 1], origin[3 * i + 2],
             direction[3 * i], direction[3 * i + 1], direction[3 * i + 2]};
}

__device__ __forceinline__ void store(float* out, int64_t n, int64_t i,
                                      const Best& b) {
  const bool hit = b.t < kMissT;
  out[i] = b.t;
  out[n + i] = hit ? 1.0f : 0.0f;
  out[2 * n + i] = b.cr;
  out[3 * n + i] = b.cg;
  out[4 * n + i] = b.cb;
  out[5 * n + i] = b.nx;
  out[6 * n + i] = b.ny;
  out[7 * n + i] = b.nz;
}

__device__ __forceinline__ float guarded_inverse(float d) {
  return 1.0f / (fabsf(d) < 1e-12f ? 1e-12f : d);
}

__global__ void __launch_bounds__(kBlock) mesh_bvh_kernel(
    const float* __restrict__ origin, const float* __restrict__ direction,
    const bool* __restrict__ active, MeshArgs m, float* __restrict__ out,
    int64_t n) {
  const int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
  if (i >= n) return;
  Best best{kMissT, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  if (active == nullptr || active[i]) {
    const Ray r = load_ray(origin, direction, i);
    const float ix = guarded_inverse(r.dx), iy = guarded_inverse(r.dy);
    const float iz = guarded_inverse(r.dz);
    const float pos[3] = {m.position[0], m.position[1], m.position[2]};
    if (hit_box(r, ix, iy, iz, m, 0, pos) < best.t) {
      int stack[kStackDepth];
      int node = 0, sp = 0;
      while (true) {
        const int count = m.node_count[node];
        const int left = m.node_left[node];
        if (count > 0) {
          for (int k = 0; k < kLeafTests && k < count; ++k) {
            float tri[kTriFloats];
            load_triangle(m, m.lookup[left + k], pos, tri);
            test_triangle(r, tri, &best);
          }
        } else {
          const float d1 = hit_box(r, ix, iy, iz, m, left, pos);
          const float d2 = hit_box(r, ix, iy, iz, m, left + 1, pos);
          const bool first = d1 <= d2;
          if (fminf(d1, d2) < best.t) {
            if (fmaxf(d1, d2) < best.t) {
              stack[sp] = first ? left + 1 : left;
              sp = min(sp + 1, kStackDepth - 1);
            }
            node = first ? left : left + 1;
            continue;
          }
        }
        if (sp == 0) break;
        node = stack[--sp];
      }
    }
  }
  store(out, n, i, best);
}

__global__ void __launch_bounds__(kBlock) mesh_brute_kernel(
    const float* __restrict__ origin, const float* __restrict__ direction,
    const bool* __restrict__ active, MeshArgs m, float* __restrict__ out,
    int64_t n, int num_tris) {
  __shared__ float tris[kBruteMax * kTriFloats];
  const float pos[3] = {m.position[0], m.position[1], m.position[2]};
  for (int j = threadIdx.x; j < num_tris; j += blockDim.x)
    load_triangle(m, j, pos, tris + kTriFloats * j);
  __syncthreads();
  const int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
  if (i >= n) return;
  Best best{kMissT, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  if (active == nullptr || active[i]) {
    const Ray r = load_ray(origin, direction, i);
    for (int j = 0; j < num_tris; ++j)
      test_triangle(r, tris + kTriFloats * j, &best);
  }
  store(out, n, i, best);
}

}  // namespace

extern "C" int bhx_mesh(const float* origin, const float* direction,
                        const bool* active, const float* points,
                        const float* normals, const int* tri_points,
                        const int* tri_normals, const float* node_min,
                        const float* node_max, const int* node_left,
                        const int* node_count, const int* lookup,
                        const float* position, float* out, int64_t n,
                        int num_tris, int brute, cudaStream_t stream) {
  if (brute && num_tris > kBruteMax)
    return static_cast<int>(cudaErrorInvalidValue);
  const MeshArgs m{points,    normals,    tri_points, tri_normals, node_min,
                   node_max, node_left, node_count, lookup,      position};
  const unsigned grid = static_cast<unsigned>((n + kBlock - 1) / kBlock);
  if (brute)
    mesh_brute_kernel<<<grid, kBlock, 0, stream>>>(origin, direction, active, m,
                                                   out, n, num_tris);
  else
    mesh_bvh_kernel<<<grid, kBlock, 0, stream>>>(origin, direction, active, m,
                                                 out, n);
  return static_cast<int>(cudaGetLastError());
}

// M1: a batch of rays against a scene's triangle meshes -> the nearest hit
// across them, as (8, N) float32 rows: t, hit, color rgb, geometric normal
// xyz.  One launch (a queue pass and the walk) for up to kMaxMeshes meshes,
// with the merge of intersect_meshes inside it.
//
// Replaces: bhx/geometry/traverse.py:_intersect_bvh (:143-234, the lockstep
// BVH traversal), _intersect_brute (:98-140, chunked brute force) and
// intersect_meshes' merge (:58-86), which the reference writes in jnp (no
// Pallas kernel: XLA runs the lockstep while_loop on the TPU).  Computes
// the same function as its plain version
// bhx_torch/geometry/traverse.py:intersect_meshes_torch, bit for bit: the
// triangle and box tests repeat bhx_torch/geometry/intersect.py's
// operations in their order (built with --fmad=false), every ray walks
// each mesh's BVH as the lockstep loop's lane does, and the merge and the
// diffuse factor are the plain merge's operations.
//
// What bounds it on the card: for a large mesh, the traversal's dependent
// loads and its divergence: each ray walks its own path, the lanes of a
// warp visit different numbers of nodes (7.4 inner visits a live ray on
// average, up to 180, for the 524,288-triangle torus at 1918x1081), and
// only part of a batch is active.  Counted once, its float work and its
// bytes (the rays in, the hits out, the mesh bytes the rays reach) take
// a tenth or less of the kernel's time at the 1918x1081 frame's largest
// call (PERF.md section 6).  Rays of one warp that drift apart on the screen cost
// far more than the visits they add: the walk is bound by the scattered
// node loads, not by its arithmetic.  For a small mesh, the triangle tests.
//
// What the design does about it:
// - A queue pass appends the active lanes (a block's in pixel order, one
//   atomicAdd a block) and writes a miss for the others; the walk then runs
//   one thread per queued lane, a warp's lanes consecutive on the screen,
//   so no warp idles on inactive lanes and neighbouring rays share node
//   loads.  Persistent warps that refill retired lanes (as csrc/march.cu)
//   and a resident grid taking the queue at its stride were slower: a
//   refilled warp mixes rays from apart on the screen (PERF.md, PR 7).
// - Each lane takes every mesh of the launch in turn, from MISS_T each,
//   and keeps the nearest (a strictly nearer hit wins, so an earlier mesh
//   wins a tie; a mesh whose visible flag is false is skipped).  The
//   winner's color and normal are computed once, at the end, from its
//   triangle index, u and v, by the test's own operations; then the
//   diffuse factor.  The rays are read from the tracer's rows in place.
// - A packed layout, built once a mesh by torch (kernels/mesh.py:pack):
//   each node one 32-byte record (min xyz, left, max xyz, count) behind a
//   dummy record, so that the two children of a node are one aligned
//   64-byte read; the vertices in leaf order, a triangle one 48-byte
//   record (a, b, c in local coordinates, its index).  A walk entry
//   carries a child's left and count, read with its box, so a visit reads
//   only its children's records and a leaf only its triangles: no chain
//   node -> count -> lookup -> tri_points -> points.  Vertices stay local;
//   the position is added in the kernel, as the plain version adds it.
// - Brute force (meshes of at most 512 triangles): the block stages each
//   triangle's ray-independent part world-positioned in shared memory
//   (a, a - b, a - c and the normalised normal: 48 bytes), and every test
//   does only the ray-dependent part, in index order.
// - A triangle test leaves at the first condition of a hit that fails,
//   before the divisions when the signs of u, v or t already fail (exact:
//   the quotient would be a negative number, not zero).
// - The walk is if-if: a step is one visit, inner node or leaf (a
//   while-while step, descending to a leaf, was 20-28% slower).  The
//   per-lane stack (48 int32) is in local memory (in shared memory it was
//   3-18% slower: it shrinks the L1 that caches the node loads).
//
// Rules kept from the lockstep traversal: the near child first (d1 <= d2),
// the far child pushed only if d_far < best_t at that moment, the stack
// pointer clamped at its last entry, at most 4 triangles tested in a leaf
// (ROADMAP C.4), a hit taken only if strictly nearer, inv_dir guarded at
// 1e-12, and the root-box early out.  In brute force the first index of
// the least t wins, as the reference's chunked argmin.  A mesh's search is
// never seeded with an earlier mesh's hit: a box's t_near can round above
// the t of a triangle inside it.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr float kMissT = 1e8f;
constexpr float kTMin = 1e-8f;
constexpr float kTMax = 1e5f;
constexpr int kStackDepth = 48;
constexpr int kLeafTests = 4;
constexpr int kMaxMeshes = 8;
constexpr int kBruteMax = 512;
// Brute-force triangles staged by a launch: 48 KB of shared memory.
constexpr int kStageMax = 1024;
constexpr int kBlock = 128;
constexpr int kQueueBlock = 256;
// A lane's next entry: an inner node's first child (>= 0), a leaf
// (-1 - (first triangle << 2 | tested - 1)), or kNext: the mesh is done.
constexpr int kNext = INT_MIN;
// The merged winner: none, or an earlier launch's (its color and normal in
// the output rows).
constexpr int kNone = -1;
constexpr int kCarried = -2;
constexpr unsigned kAllLanes = 0xffffffffu;

// Flags: merge (read visible; the diffuse factor on the last launch), last.
constexpr int kMerge = 1;
constexpr int kLast = 2;
// The int64 fields of a mesh argument (bhx_mesh's ``meshes``).
constexpr int kMeshFields = 10;

struct MeshDesc {
  const float4* nodes;  // (B + 1) records of 2 float4; null in brute force
  const float4* tris;   // T leaf-order records of 3 float4; null in brute force
  const float* points;
  const float* normals;
  const int* tri_points;
  const int* tri_normals;
  const float* position;
  const bool* visible;
  int num_tris;
  int staged;  // brute force: its first staged triangle; -1 for a BVH
};

struct Meshes {
  MeshDesc m[kMaxMeshes];
  int count;
};

// px py pz dx dy dz, each a float32 row with its own stride.
struct Rays {
  const float* p[6];
  int64_t s[6];
};

struct Lane {
  float ox, oy, oz, dx, dy, dz, ix, iy, iz;
  float px, py, pz;  // the current mesh's position
  int m;             // the current mesh, -1 before the first
  int e;             // the next entry
  int sp;
  float bt, bu, bv;  // the current mesh's nearest hit
  int bk;
  float mt, mu, mv;  // the merged nearest hit
  int mm, mk;
};

// a . (b x c), summed x + y + z (intersect.py:det3).
__device__ __forceinline__ float det3(float ax, float ay, float az, float bx,
                                      float by, float bz, float cx, float cy,
                                      float cz) {
  return (ax * (by * cz - bz * cy) + ay * (bz * cx - bx * cz)) +
         az * (bx * cy - by * cx);
}

// The ray-independent part of hit_triangles on a world-positioned triangle
// (a, b, c): the normalised normal g, a - b and a - c.
struct Prepared {
  float ax, ay, az, gx, gy, gz, mbx, mby, mbz, mcx, mcy, mcz;
};

__device__ __forceinline__ Prepared prepare(float ax, float ay, float az,
                                            float bx, float by, float bz,
                                            float cx, float cy, float cz) {
  const float abx = bx - ax, aby = by - ay, abz = bz - az;
  const float acx = cx - ax, acy = cy - ay, acz = cz - az;
  float gx = aby * acz - abz * acy;
  float gy = abz * acx - abx * acz;
  float gz = abx * acy - aby * acx;
  const float inv = 1.0f / (sqrtf((gx * gx + gy * gy) + gz * gz) + 1e-20f);
  gx = gx * inv;
  gy = gy * inv;
  gz = gz * inv;
  return Prepared{ax,      ay,      az,      gx,      gy,      gz,
                  ax - bx, ay - by, az - bz, ax - cx, ay - cy, az - cz};
}

// Whether q = num / denom (|denom| >= 1e-5) is surely negative: the signs
// differ and |q| > 1e-38, so q rounds to no zero.  Exact: the test's
// u >= 0, v >= 0 and t > T_MIN then fail.
__device__ __forceinline__ bool negative_quotient(float num, float denom) {
  return (num < 0.0f) != (denom < 0.0f) && fabsf(num) > fabsf(denom) * 1e-38f;
}

// hit_triangles on the world-positioned triangle with vertex a, a - b,
// a - c and the normalised normal that ``normal`` gives; takes (t, u, v)
// of triangle ``tri`` into the mesh's best if strictly nearer.  Every
// condition of a hit is an "and", so the test leaves at the first that
// fails: |det|, then the signs of u, v and t (before their divisions), then
// |normal . dir| (before the normal, when ``normal`` computes it).  A hit
// computes every value the plain test does, by the same operations.
template <class Normal>
__device__ __forceinline__ void test_triangle(Lane& r, float ax, float ay,
                                              float az, float mbx, float mby,
                                              float mbz, float mcx, float mcy,
                                              float mcz, Normal normal,
                                              int tri) {
  const float denom = det3(r.dx, r.dy, r.dz, mbx, mby, mbz, mcx, mcy, mcz);
  if (!(fabsf(denom) >= 1e-5f)) return;
  const float mox = ax - r.ox, moy = ay - r.oy, moz = az - r.oz;
  const float nu = det3(r.dx, r.dy, r.dz, mox, moy, moz, mcx, mcy, mcz);
  if (negative_quotient(nu, denom)) return;
  const float nv = det3(r.dx, r.dy, r.dz, mbx, mby, mbz, mox, moy, moz);
  if (negative_quotient(nv, denom)) return;
  const float nt = det3(mox, moy, moz, mbx, mby, mbz, mcx, mcy, mcz);
  if (negative_quotient(nt, denom)) return;
  float gx, gy, gz;
  normal(gx, gy, gz);
  const float ray_dot = (r.dx * gx + r.dy * gy) + r.dz * gz;
  // |denom| >= 1e-5, so the plain test's guarded divisor is denom.
  const float u = nu / denom, v = nv / denom, t = nt / denom;
  const bool hit = fabsf(ray_dot) >= 1e-5f && u >= 0.0f && u <= 1.0f &&
                   v >= 0.0f && u + v <= 1.0f && t > kTMin && t < kTMax;
  if (hit && t < r.bt) {
    r.bt = t;
    r.bk = tri;
    r.bu = u;
    r.bv = v;
  }
}

// hit_aabb on a box in local coordinates, offset by the mesh position.
__device__ __forceinline__ float hit_box(const Lane& r, float4 lo, float4 hi) {
  const float t1x = ((lo.x + r.px) - r.ox) * r.ix;
  const float t1y = ((lo.y + r.py) - r.oy) * r.iy;
  const float t1z = ((lo.z + r.pz) - r.oz) * r.iz;
  const float t2x = ((hi.x + r.px) - r.ox) * r.ix;
  const float t2y = ((hi.y + r.py) - r.oy) * r.iy;
  const float t2z = ((hi.z + r.pz) - r.oz) * r.iz;
  const float t_near =
      fmaxf(fmaxf(fminf(t1x, t2x), fminf(t1y, t2y)), fminf(t1z, t2z));
  const float t_far =
      fminf(fminf(fmaxf(t1x, t2x), fmaxf(t1y, t2y)), fmaxf(t1z, t2z));
  return (t_near > t_far || t_far < 0.0f) ? kMissT : t_near;
}

// The walk entry of the node whose record is (lo, hi).
__device__ __forceinline__ int entry_of(float4 lo, float4 hi) {
  const int left = __float_as_int(lo.w), count = __float_as_int(hi.w);
  return count > 0 ? -1 - ((left << 2) | (min(count, kLeafTests) - 1)) : left;
}

__device__ __forceinline__ float guarded_inverse(float d) {
  return 1.0f / (fabsf(d) < 1e-12f ? 1e-12f : d);
}

// Triangle ``tri`` of mesh ``d`` from its index arrays, world-positioned.
__device__ __forceinline__ Prepared prepare_indexed(const MeshDesc& d, int tri,
                                                    float px, float py,
                                                    float pz) {
  const float* a = d.points + 3 * d.tri_points[3 * tri];
  const float* b = d.points + 3 * d.tri_points[3 * tri + 1];
  const float* c = d.points + 3 * d.tri_points[3 * tri + 2];
  return prepare(a[0] + px, a[1] + py, a[2] + pz, b[0] + px, b[1] + py,
                 b[2] + pz, c[0] + px, c[1] + py, c[2] + pz);
}

__device__ __forceinline__ void store(float* out, int64_t n, int64_t i,
                                      float t, float cr, float cg, float cb,
                                      float nx, float ny, float nz) {
  out[i] = t;
  out[n + i] = t < kMissT ? 1.0f : 0.0f;
  out[2 * n + i] = cr;
  out[3 * n + i] = cg;
  out[4 * n + i] = cb;
  out[5 * n + i] = nx;
  out[6 * n + i] = ny;
  out[7 * n + i] = nz;
}

// Queue pass: the active lanes' indices, a block's in pixel order, one
// atomicAdd a block (counters[0] counts them); an inactive lane's miss is
// written here.
__global__ void __launch_bounds__(kQueueBlock) mesh_queue_kernel(
    const bool* __restrict__ active, int* __restrict__ queue,
    int* __restrict__ counters, float* __restrict__ out, int64_t n) {
  __shared__ int warp_base[kQueueBlock / 32];
  __shared__ int block_base;
  const int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const bool live = i < n && active[i];
  if (i < n && !live)
    store(out, n, i, kMissT, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f);
  const unsigned mask = __ballot_sync(kAllLanes, live);
  if (lane == 0) warp_base[warp] = __popc(mask);
  __syncthreads();
  if (threadIdx.x == 0) {
    int total = 0;
    for (int w = 0; w < kQueueBlock / 32; ++w) {
      const int count = warp_base[w];
      warp_base[w] = total;
      total += count;
    }
    block_base = total ? atomicAdd(&counters[0], total) : 0;
  }
  __syncthreads();
  if (live)
    queue[block_base + warp_base[warp] + __popc(mask & ((1u << lane) - 1u))] =
        static_cast<int>(i);
}

// Lane ``s`` takes ray ``i``: its rows, its inverse direction, and the
// merged best so far (an earlier launch's, read from ``out``).
__device__ __forceinline__ void start(Lane& s, const Rays& rays,
                                      const float* out, int64_t i,
                                      bool carry) {
  s.ox = rays.p[0][i * rays.s[0]];
  s.oy = rays.p[1][i * rays.s[1]];
  s.oz = rays.p[2][i * rays.s[2]];
  s.dx = rays.p[3][i * rays.s[3]];
  s.dy = rays.p[4][i * rays.s[4]];
  s.dz = rays.p[5][i * rays.s[5]];
  s.ix = guarded_inverse(s.dx);
  s.iy = guarded_inverse(s.dy);
  s.iz = guarded_inverse(s.dz);
  s.m = -1;
  s.e = kNext;
  s.sp = 0;
  s.bt = kMissT;
  s.mt = carry ? out[i] : kMissT;
  s.mm = s.mt < kMissT ? kCarried : kNone;
}

// One step of lane ``s``: close the current mesh and open the next visible
// one (its root box, or a whole brute-force scan), or one visit of the
// BVH walk, an inner node or a leaf.  False when no mesh is left.
__device__ __forceinline__ bool step(Lane& s, const MeshDesc* meshes,
                                     unsigned visible, const float4* staged,
                                     int* stack) {
  if (s.e == kNext) {
    if (s.m >= 0 && s.bt < s.mt) {
      s.mt = s.bt;
      s.mm = s.m;
      s.mk = s.bk;
      s.mu = s.bu;
      s.mv = s.bv;
    }
    const unsigned after = s.m < 0 ? visible : visible & (~0u << (s.m + 1));
    if (!after) return false;
    s.m = __ffs(after) - 1;
    const MeshDesc& d = meshes[s.m];
    s.px = d.position[0];
    s.py = d.position[1];
    s.pz = d.position[2];
    s.bt = kMissT;
    if (d.staged >= 0) {
      const float4* tri = staged + 3 * d.staged;
      for (int j = 0; j < d.num_tris; ++j, tri += 3) {
        const float4 s0 = tri[0], s1 = tri[1], s2 = tri[2];
        test_triangle(s, s0.x, s0.y, s0.z, s1.x, s1.y, s1.z, s2.x, s2.y, s2.z,
                      [&](float& gx, float& gy, float& gz) {
                        gx = s0.w;
                        gy = s1.w;
                        gz = s2.w;
                      },
                      j);
      }
      return true;
    }
    const float4 lo = d.nodes[2], hi = d.nodes[3];
    if (hit_box(s, lo, hi) < kMissT) {
      s.e = entry_of(lo, hi);
      s.sp = 0;
    }
    return true;
  }
  const MeshDesc& d = meshes[s.m];
  if (s.e >= 0) {
    const float4* c = d.nodes + 2 * (s.e + 1);
    const float4 lo1 = c[0], hi1 = c[1], lo2 = c[2], hi2 = c[3];
    const float d1 = hit_box(s, lo1, hi1);
    const float d2 = hit_box(s, lo2, hi2);
    const bool first = d1 <= d2;
    if (fminf(d1, d2) < s.bt) {
      if (fmaxf(d1, d2) < s.bt) {
        stack[s.sp] = first ? entry_of(lo2, hi2) : entry_of(lo1, hi1);
        s.sp = min(s.sp + 1, kStackDepth - 1);
      }
      s.e = first ? entry_of(lo1, hi1) : entry_of(lo2, hi2);
    } else {
      s.e = s.sp == 0 ? kNext : stack[--s.sp];
    }
    return true;
  }
  const int leaf = -1 - s.e;
  const int tested = (leaf & 3) + 1;
  const float4* rec = d.tris + 3 * (leaf >> 2);
  for (int k = 0; k < tested; ++k, rec += 3) {
    const float4 r0 = rec[0], r1 = rec[1], r2 = rec[2];
    const float ax = r0.x + s.px, ay = r0.y + s.py, az = r0.z + s.pz;
    const float bx = r0.w + s.px, by = r1.x + s.py, bz = r1.y + s.pz;
    const float cx = r1.z + s.px, cy = r1.w + s.py, cz = r2.x + s.pz;
    test_triangle(s, ax, ay, az, ax - bx, ay - by, az - bz, ax - cx, ay - cy,
                  az - cz,
                  [&](float& gx, float& gy, float& gz) {
                    const Prepared p = prepare(ax, ay, az, bx, by, bz, cx, cy, cz);
                    gx = p.gx;
                    gy = p.gy;
                    gz = p.gz;
                  },
                  __float_as_int(r2.y));
  }
  s.e = s.sp == 0 ? kNext : stack[--s.sp];
  return true;
}

// Lane ``s`` is done: the merged winner's color (its interpolated vertex
// normal) and its geometric normal flipped toward the ray, then, on the
// last launch of a merge, the diffuse factor; written to ray ``i``.
__device__ __forceinline__ void finish(const Lane& s, const MeshDesc* meshes,
                                       const float* light, float* out,
                                       int64_t n, int64_t i, int flags) {
  float cr = 0.0f, cg = 0.0f, cb = 0.0f, nx = 0.0f, ny = 0.0f, nz = 0.0f;
  if (s.mm >= 0) {
    const MeshDesc& d = meshes[s.mm];
    const Prepared p = prepare_indexed(d, s.mk, d.position[0], d.position[1],
                                       d.position[2]);
    const float ray_dot = (s.dx * p.gx + s.dy * p.gy) + s.dz * p.gz;
    const float* n1 = d.normals + 3 * d.tri_normals[3 * s.mk];
    const float* n2 = d.normals + 3 * d.tri_normals[3 * s.mk + 1];
    const float* n3 = d.normals + 3 * d.tri_normals[3 * s.mk + 2];
    const float u = s.mu, v = s.mv;
    const float w = (1.0f - u) - v;
    cr = -((w * n1[0] + u * n2[0]) + v * n3[0]) * 0.5f + 0.5f;
    cg = -((w * n1[1] + u * n2[1]) + v * n3[1]) * 0.5f + 0.5f;
    cb = -((w * n1[2] + u * n2[2]) + v * n3[2]) * 0.5f + 0.5f;
    const bool flip = ray_dot > 0.0f;
    nx = flip ? -p.gx : p.gx;
    ny = flip ? -p.gy : p.gy;
    nz = flip ? -p.gz : p.gz;
  } else if (s.mm == kCarried) {
    cr = out[2 * n + i];
    cg = out[3 * n + i];
    cb = out[4 * n + i];
    nx = out[5 * n + i];
    ny = out[6 * n + i];
    nz = out[7 * n + i];
  }
  if ((flags & kMerge) && (flags & kLast) && s.mt < kMissT) {
    const float diffuse = (nx * light[0] + ny * light[1]) + nz * light[2];
    cr = cr * diffuse;
    cg = cg * diffuse;
    cb = cb * diffuse;
  }
  store(out, n, i, s.mt, cr, cg, cb, nx, ny, nz);
}

// The walk: one thread per queued lane (every lane when there is no
// mask), a block's lanes consecutive in the queue.  A thread walks its ray
// through every mesh, one visit a step, and writes its output.  A block
// past the queue's end leaves before staging anything.
__global__ void __launch_bounds__(kBlock) mesh_kernel(
    Rays rays, const int* __restrict__ queue, const int* __restrict__ counters,
    Meshes meshes, const float* __restrict__ light, float* __restrict__ out,
    int64_t n, int flags, int carry, int masked) {
  extern __shared__ float4 staged[];
  __shared__ MeshDesc s_mesh[kMaxMeshes];
  __shared__ unsigned s_visible;
  int stack[kStackDepth];
  const int64_t queued = masked ? counters[0] : n;
  const int64_t at = blockIdx.x * static_cast<int64_t>(kBlock) + threadIdx.x;
  if (at - threadIdx.x >= queued) return;

#pragma unroll
  for (int k = 0; k < kMaxMeshes; ++k)
    if (threadIdx.x == k && k < meshes.count) s_mesh[k] = meshes.m[k];
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned vis = 0;
    for (int k = 0; k < meshes.count; ++k)
      if (!(flags & kMerge) || *s_mesh[k].visible) vis |= 1u << k;
    s_visible = vis;
  }
  // Brute-force meshes: each triangle's ray-independent part,
  // world-positioned, as 3 float4: (a, g.x), (a - b, g.y), (a - c, g.z).
  for (int k = 0; k < meshes.count; ++k) {
    const MeshDesc& d = s_mesh[k];
    if (d.staged < 0) continue;
    const float px = d.position[0], py = d.position[1], pz = d.position[2];
    for (int j = threadIdx.x; j < d.num_tris; j += blockDim.x) {
      const Prepared p = prepare_indexed(d, j, px, py, pz);
      float4* to = staged + 3 * (d.staged + j);
      to[0] = make_float4(p.ax, p.ay, p.az, p.gx);
      to[1] = make_float4(p.mbx, p.mby, p.mbz, p.gy);
      to[2] = make_float4(p.mcx, p.mcy, p.mcz, p.gz);
    }
  }
  __syncthreads();
  if (at >= queued) return;
  const int64_t i = masked ? queue[at] : at;
  Lane s;
  start(s, rays, out, i, carry);
  while (step(s, s_mesh, s_visible, staged, stack)) {
  }
  finish(s, s_mesh, light, out, n, i, flags);
}

}  // namespace

// rays: 12 int64, the six row pointers px py pz dx dy dz, then their
// strides in elements; active: (n,) bool or NULL; queue: n int32 of
// scratch and counters: 1 int32, zero on entry, the queue's length (both
// unused without ``active``); meshes:
// ``count`` (1..kMaxMeshes) records of kMeshFields int64 (nodes, tris,
// points, normals, tri_points, tri_normals, position, visible, num_tris,
// brute); light: 3 float32 (read with kMerge | kLast); out: (8, n).  The
// first launch of a call (``launch`` 0) runs the queue pass; a later one
// reads the merged best of the earlier ones from ``out`` and the queue.
extern "C" int bhx_mesh(const int64_t* rays, const bool* active, int* queue,
                        int* counters, int launch, const int64_t* meshes,
                        int count, const float* light, float* out, int64_t n,
                        int flags, cudaStream_t stream) {
  if (n < 0 || n > INT_MAX || count < 1 || count > kMaxMeshes || launch < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return static_cast<int>(cudaSuccess);
  Rays r;
  for (int k = 0; k < 6; ++k) {
    r.p[k] = reinterpret_cast<const float*>(rays[k]);
    r.s[k] = rays[6 + k];
  }
  Meshes m;
  m.count = count;
  int staged = 0;
  for (int k = 0; k < kMaxMeshes; ++k) {
    MeshDesc& d = m.m[k];
    if (k >= count) {
      d = MeshDesc{};
      continue;
    }
    const int64_t* f = meshes + kMeshFields * k;
    d.nodes = reinterpret_cast<const float4*>(f[0]);
    d.tris = reinterpret_cast<const float4*>(f[1]);
    d.points = reinterpret_cast<const float*>(f[2]);
    d.normals = reinterpret_cast<const float*>(f[3]);
    d.tri_points = reinterpret_cast<const int*>(f[4]);
    d.tri_normals = reinterpret_cast<const int*>(f[5]);
    d.position = reinterpret_cast<const float*>(f[6]);
    d.visible = reinterpret_cast<const bool*>(f[7]);
    if (f[8] < 0 || f[8] >= (int64_t{1} << 28))
      return static_cast<int>(cudaErrorInvalidValue);
    d.num_tris = static_cast<int>(f[8]);
    if (f[9]) {
      if (d.num_tris > kBruteMax) return static_cast<int>(cudaErrorInvalidValue);
      d.staged = staged;
      staged += d.num_tris;
    } else {
      if (!d.nodes || !d.tris) return static_cast<int>(cudaErrorInvalidValue);
      d.staged = -1;
    }
  }
  if (staged > kStageMax) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = sizeof(float4) * 3 * static_cast<size_t>(staged);
  cudaError_t err;
  if ((err = cudaFuncSetAttribute(mesh_kernel,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  static_cast<int>(smem))) != cudaSuccess)
    return static_cast<int>(err);
  if (active && launch == 0)
    mesh_queue_kernel<<<static_cast<unsigned>((n + kQueueBlock - 1) / kQueueBlock),
                        kQueueBlock, 0, stream>>>(active, queue, counters, out, n);
  mesh_kernel<<<static_cast<unsigned>((n + kBlock - 1) / kBlock), kBlock, smem,
                stream>>>(r, queue, counters, m, light, out, n, flags, launch > 0,
                          active != nullptr);
  return static_cast<int>(cudaGetLastError());
}

// bhxcore — native geometry preprocessing for bhx_torch: bhx_torch's own
// copy of bhx/geometry/csrc/bhxcore.cpp, built by bhx_torch.geometry.native
// into build/bhx_torch/ (host code; it runs on whatever CPU drives the card).
//
// Implements the same BVH construction the reference performs in Rust
// (reference: src/renderer/triangle.rs:143-259): binary tree, midpoint split
// of the node AABB's longest axis on triangle centroids, vertex-bound node
// AABBs, leaves of at most `leaf_size` triangles, children contiguous, and a
// stable index-indirection array partitioned per node.  Output layout matches
// bhx_torch.geometry.bvh.BvhArrays exactly (the numpy builder is the
// executable specification; tests assert bit-identical results).
//
// Exposed via a minimal C ABI consumed with ctypes.

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <map>
#include <mutex>
#include <stack>
#include <vector>

namespace {

struct Vec3 {
  float x, y, z;
};

inline Vec3 vmin(const Vec3& a, const Vec3& b) {
  return {std::min(a.x, b.x), std::min(a.y, b.y), std::min(a.z, b.z)};
}
inline Vec3 vmax(const Vec3& a, const Vec3& b) {
  return {std::max(a.x, b.x), std::max(a.y, b.y), std::max(a.z, b.z)};
}
inline float get(const Vec3& v, int axis) {
  return axis == 0 ? v.x : (axis == 1 ? v.y : v.z);
}

// ---------------------------------------------------------------------------
// OBJ parsing (reference: src/renderer/model.rs:7-87 via tobj).
//
// Produces the same *raw* arrays as the numpy parser in bhx_torch.geometry.obj
// (pre scale/flip, 0-based indices resolved against FINAL counts, tri_n -1
// where the face carries no normal index); the shared Python post-pass
// applies conventions and synthesizes missing normals, so both parsers are
// interchangeable by construction (tests assert identical output).
// ---------------------------------------------------------------------------

struct ObjData {
  std::vector<float> points;    // P*3
  std::vector<float> normals;   // Nn*3
  std::vector<int64_t> refs_p;  // raw 1-based (or negative) per corner
  std::vector<int64_t> refs_n;  // raw index, 0 = missing
};

std::mutex g_obj_mutex;
std::map<int64_t, ObjData*> g_obj_registry;
int64_t g_obj_next = 0;

}  // namespace

extern "C" {

// Returns the number of nodes written.  Output buffers must hold at least
// 2*T nodes / T lookup entries.
int64_t bhx_build_bvh(const float* points, int64_t npoints,
                      const int32_t* tris, int64_t ntris, int32_t leaf_size,
                      float* out_node_min, float* out_node_max,
                      int32_t* out_node_left, int32_t* out_node_count,
                      int32_t* out_lookup) {
  (void)npoints;
  if (ntris == 0) {
    out_node_min[0] = out_node_min[1] = out_node_min[2] = 0.f;
    out_node_max[0] = out_node_max[1] = out_node_max[2] = 0.f;
    out_node_left[0] = 0;
    out_node_count[0] = 0;
    return 1;
  }

  // Precompute per-triangle bounds and centroids.
  std::vector<Vec3> tmin(ntris), tmax(ntris), cent(ntris);
  for (int64_t t = 0; t < ntris; ++t) {
    Vec3 lo = {1e30f, 1e30f, 1e30f}, hi = {-1e30f, -1e30f, -1e30f};
    Vec3 c = {0.f, 0.f, 0.f};
    for (int k = 0; k < 3; ++k) {
      const float* p = points + 3 * static_cast<int64_t>(tris[3 * t + k]);
      Vec3 v = {p[0], p[1], p[2]};
      lo = vmin(lo, v);
      hi = vmax(hi, v);
      c.x += v.x;
      c.y += v.y;
      c.z += v.z;
    }
    tmin[t] = lo;
    tmax[t] = hi;
    cent[t] = {c.x / 3.f, c.y / 3.f, c.z / 3.f};
  }

  for (int64_t t = 0; t < ntris; ++t) out_lookup[t] = static_cast<int32_t>(t);

  out_node_left[0] = 0;
  out_node_count[0] = static_cast<int32_t>(ntris);
  int64_t nodes_used = 1;

  std::vector<int32_t> scratch(ntris);
  std::stack<int64_t> stack;
  stack.push(0);
  while (!stack.empty()) {
    const int64_t ni = stack.top();
    stack.pop();
    const int32_t start = out_node_left[ni];
    const int32_t count = out_node_count[ni];

    Vec3 lo = {1e30f, 1e30f, 1e30f}, hi = {-1e30f, -1e30f, -1e30f};
    for (int32_t i = 0; i < count; ++i) {
      const int32_t t = out_lookup[start + i];
      lo = vmin(lo, tmin[t]);
      hi = vmax(hi, tmax[t]);
    }
    out_node_min[3 * ni + 0] = lo.x;
    out_node_min[3 * ni + 1] = lo.y;
    out_node_min[3 * ni + 2] = lo.z;
    out_node_max[3 * ni + 0] = hi.x;
    out_node_max[3 * ni + 1] = hi.y;
    out_node_max[3 * ni + 2] = hi.z;

    if (count <= leaf_size) continue;

    const Vec3 extent = {hi.x - lo.x, hi.y - lo.y, hi.z - lo.z};
    int axis = 0;
    if (extent.y > get(extent, axis)) axis = 1;
    if (extent.z > get(extent, axis)) axis = 2;
    const float split = get(lo, axis) + get(extent, axis) * 0.5f;

    // Stable partition (matches the numpy implementation: order of left and
    // right groups preserved).
    int32_t nleft = 0, nright = 0;
    for (int32_t i = 0; i < count; ++i) {
      const int32_t t = out_lookup[start + i];
      if (get(cent[t], axis) < split)
        out_lookup[start + nleft++] = t;  // safe: nleft <= i
      else
        scratch[nright++] = t;
    }
    if (nleft == 0 || nleft == count) continue;  // degenerate -> leaf
    std::memcpy(out_lookup + start + nleft, scratch.data(),
                sizeof(int32_t) * nright);

    const int64_t li = nodes_used;
    const int64_t ri = nodes_used + 1;
    nodes_used += 2;
    out_node_left[li] = start;
    out_node_count[li] = nleft;
    out_node_left[ri] = start + nleft;
    out_node_count[ri] = count - nleft;
    out_node_left[ni] = static_cast<int32_t>(li);
    out_node_count[ni] = 0;
    stack.push(ri);
    stack.push(li);
  }

  return nodes_used;
}

// Parse an OBJ file.  Returns a handle (>= 0) for the two-call readout, or
// -1 on I/O failure.  Semantics mirror the numpy parser exactly: only
// "v "/"vn "/"f " lines are read, faces are fan-triangulated, vertex refs
// are "p", "p/t", "p//n" or "p/t/n", and negative indices are resolved
// against the FINAL vertex/normal counts (matching bhx_torch.geometry.obj).
int64_t bhx_obj_parse(const char* path) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  std::fseek(f, 0, SEEK_END);
  const long size = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  std::vector<char> buf(static_cast<size_t>(size) + 1);
  const size_t got = std::fread(buf.data(), 1, static_cast<size_t>(size), f);
  std::fclose(f);
  buf[got] = '\0';

  auto* obj = new ObjData();
  std::vector<std::pair<int64_t, int64_t>> face;  // (p_ref, n_ref) per vert
  char* s = buf.data();
  char* end = s + got;
  while (s < end) {
    char* eol = s;
    while (eol < end && *eol != '\n') ++eol;
    *eol = '\0';
    if (s[0] == 'v' && s[1] == ' ') {
      char* q = s + 2;
      for (int k = 0; k < 3; ++k) obj->points.push_back(std::strtof(q, &q));
    } else if (s[0] == 'v' && s[1] == 'n' && s[2] == ' ') {
      char* q = s + 3;
      for (int k = 0; k < 3; ++k) obj->normals.push_back(std::strtof(q, &q));
    } else if (s[0] == 'f' && s[1] == ' ') {
      face.clear();
      char* q = s + 2;
      while (*q) {
        while (*q == ' ' || *q == '\t' || *q == '\r') ++q;
        if (!*q) break;
        // vertex token: p[/t[/n]] or p//n
        char* tok_end = q;
        while (*tok_end && *tok_end != ' ' && *tok_end != '\t' &&
               *tok_end != '\r')
          ++tok_end;
        int64_t pi = std::strtoll(q, &q, 10);
        int64_t ni = 0;
        if (q < tok_end && *q == '/') {
          ++q;  // past first '/'
          if (*q != '/') (void)std::strtoll(q, &q, 10);  // texcoord, unused
          if (q < tok_end && *q == '/') {
            ++q;
            if (q < tok_end && *q != ' ' && *q)
              ni = std::strtoll(q, &q, 10);
          }
        }
        q = tok_end;
        face.emplace_back(pi, ni);
      }
      for (size_t k = 1; k + 1 < face.size(); ++k) {  // fan triangulation
        obj->refs_p.push_back(face[0].first);
        obj->refs_n.push_back(face[0].second);
        obj->refs_p.push_back(face[k].first);
        obj->refs_n.push_back(face[k].second);
        obj->refs_p.push_back(face[k + 1].first);
        obj->refs_n.push_back(face[k + 1].second);
      }
    }
    s = eol + 1;
  }

  std::lock_guard<std::mutex> lock(g_obj_mutex);
  const int64_t h = g_obj_next++;
  g_obj_registry[h] = obj;
  return h;
}

// out[0] = P (vertices), out[1] = Nn (normals), out[2] = T (triangles).
void bhx_obj_counts(int64_t handle, int64_t* out) {
  std::lock_guard<std::mutex> lock(g_obj_mutex);
  auto it = g_obj_registry.find(handle);
  if (it == g_obj_registry.end()) {
    out[0] = out[1] = out[2] = 0;
    return;
  }
  out[0] = static_cast<int64_t>(it->second->points.size() / 3);
  out[1] = static_cast<int64_t>(it->second->normals.size() / 3);
  out[2] = static_cast<int64_t>(it->second->refs_p.size() / 3);
}

// Fill caller-allocated buffers: points (P*3 f32), normals (Nn*3 f32),
// tri_p / tri_n (T*3 i32, 0-based; tri_n -1 where missing), has_n (T u8).
void bhx_obj_fill(int64_t handle, float* points, float* normals,
                  int32_t* tri_p, int32_t* tri_n, uint8_t* has_n) {
  ObjData* obj;
  {
    std::lock_guard<std::mutex> lock(g_obj_mutex);
    auto it = g_obj_registry.find(handle);
    if (it == g_obj_registry.end()) return;
    obj = it->second;
  }
  const int64_t P = static_cast<int64_t>(obj->points.size() / 3);
  const int64_t Nn = static_cast<int64_t>(obj->normals.size() / 3);
  const int64_t T = static_cast<int64_t>(obj->refs_p.size() / 3);
  std::memcpy(points, obj->points.data(), sizeof(float) * obj->points.size());
  std::memcpy(normals, obj->normals.data(),
              sizeof(float) * obj->normals.size());
  for (int64_t t = 0; t < T; ++t) {
    bool all_n = true;
    for (int k = 0; k < 3; ++k) {
      const int64_t pi = obj->refs_p[3 * t + k];
      const int64_t ni = obj->refs_n[3 * t + k];
      tri_p[3 * t + k] = static_cast<int32_t>(pi > 0 ? pi - 1 : P + pi);
      tri_n[3 * t + k] =
          static_cast<int32_t>(ni > 0 ? ni - 1 : (ni < 0 ? Nn + ni : -1));
      if (ni == 0) all_n = false;
    }
    has_n[t] = all_n ? 1 : 0;
  }
}

void bhx_obj_free(int64_t handle) {
  std::lock_guard<std::mutex> lock(g_obj_mutex);
  auto it = g_obj_registry.find(handle);
  if (it != g_obj_registry.end()) {
    delete it->second;
    g_obj_registry.erase(it);
  }
}

}  // extern "C"

// Native signed-distance queries against a triangle mesh.
//
// The exact host-side engine of the template surgery (the pysdf role of the
// reference): pipeline/template.py queries it on the lattice of every
// watertight re-extraction, and models/geometry.py's SDF target can be
// checked against it. Its code below the header is the JAX package's
// native/meshsdf.cpp unchanged, so both engines answer alike.
//
// Method: median-split AABB BVH with best-first pruning for the exact
// closest point; sign from the angle-weighted pseudonormal of the closest
// feature (face / edge / vertex) — Baerentzen & Aanaes 2005, exact for
// watertight 2-manifolds, which is what every pipeline consumer feeds it
// (the whole point of rewatertight()). Queries are embarrassingly parallel
// and fan out over a std::thread pool.
//
// C ABI (ctypes-friendly), no external deps beyond pthread.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <unordered_map>
#include <vector>

namespace {

struct V3 {
  float x, y, z;
};

inline V3 operator-(V3 a, V3 b) { return {a.x - b.x, a.y - b.y, a.z - b.z}; }
inline V3 operator+(V3 a, V3 b) { return {a.x + b.x, a.y + b.y, a.z + b.z}; }
inline V3 operator*(V3 a, float s) { return {a.x * s, a.y * s, a.z * s}; }
inline float dot(V3 a, V3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }
inline V3 cross(V3 a, V3 b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z,
          a.x * b.y - a.y * b.x};
}
inline float norm(V3 a) { return std::sqrt(dot(a, a)); }
inline V3 normalized(V3 a) {
  float n = norm(a);
  return n > 1e-20f ? a * (1.0f / n) : V3{0, 0, 0};
}

// Closest-feature classification for the pseudonormal lookup.
enum Feature : int {
  kInterior = 0,
  kEdgeAB = 1,
  kEdgeAC = 2,
  kEdgeBC = 3,
  kVertA = 4,
  kVertB = 5,
  kVertC = 6,
};

// Ericson, "Real-Time Collision Detection" §5.1.5, with the Voronoi
// region (= closest feature) reported so the caller can pick the right
// pseudonormal.
inline V3 closest_on_triangle(V3 p, V3 a, V3 b, V3 c, Feature* feat) {
  V3 ab = b - a, ac = c - a, ap = p - a;
  float d1 = dot(ab, ap), d2 = dot(ac, ap);
  if (d1 <= 0.f && d2 <= 0.f) {
    *feat = kVertA;
    return a;
  }
  V3 bp = p - b;
  float d3 = dot(ab, bp), d4 = dot(ac, bp);
  if (d3 >= 0.f && d4 <= d3) {
    *feat = kVertB;
    return b;
  }
  float vc = d1 * d4 - d3 * d2;
  if (vc <= 0.f && d1 >= 0.f && d3 <= 0.f) {
    *feat = kEdgeAB;
    return a + ab * (d1 / (d1 - d3));
  }
  V3 cp = p - c;
  float d5 = dot(ab, cp), d6 = dot(ac, cp);
  if (d6 >= 0.f && d5 <= d6) {
    *feat = kVertC;
    return c;
  }
  float vb = d5 * d2 - d1 * d6;
  if (vb <= 0.f && d2 >= 0.f && d6 <= 0.f) {
    *feat = kEdgeAC;
    return a + ac * (d2 / (d2 - d6));
  }
  float va = d3 * d6 - d5 * d4;
  if (va <= 0.f && (d4 - d3) >= 0.f && (d5 - d6) >= 0.f) {
    *feat = kEdgeBC;
    return b + (c - b) * ((d4 - d3) / ((d4 - d3) + (d5 - d6)));
  }
  float denom = 1.0f / (va + vb + vc);
  *feat = kInterior;
  return a + ab * (vb * denom) + ac * (vc * denom);
}

struct Node {
  float bmin[3], bmax[3];
  int32_t left;   // internal: child index; leaf: start into tri_order_
  int32_t count;  // 0 for internal nodes (right child = left + 1... no:
                  // right stored implicitly as left+?; we store both)
  int32_t right;  // internal only
};

inline float aabb_sqdist(const Node& n, V3 p) {
  float d = 0.f;
  const float pv[3] = {p.x, p.y, p.z};
  for (int k = 0; k < 3; ++k) {
    float v = pv[k];
    float e = (v < n.bmin[k]) ? n.bmin[k] - v
                              : (v > n.bmax[k] ? v - n.bmax[k] : 0.f);
    d += e * e;
  }
  return d;
}

class MeshSDF {
 public:
  MeshSDF(const float* verts, int nv, const int32_t* faces, int nf)
      : nv_(nv), nf_(nf) {
    v_.resize(nv);
    std::memcpy(v_.data(), verts, sizeof(float) * 3 * nv);
    f_.assign(faces, faces + 3 * static_cast<size_t>(nf));
    BuildNormals();
    BuildBVH();
  }

  // Returns unsigned distance; fills *sgn with +1 outside / -1 inside,
  // *face with the nearest face id, *cp with the closest surface point.
  float Query(V3 p, float* sgn, int32_t* face, V3* cp) const {
    float best = 3.4e38f;
    int32_t best_tri = -1;
    Feature best_feat = kInterior;
    V3 best_cp{0, 0, 0};

    int32_t stack[128];
    int sp = 0;
    stack[sp++] = 0;
    while (sp) {
      int32_t ni = stack[--sp];
      const Node& n = nodes_[ni];
      if (aabb_sqdist(n, p) >= best) continue;
      if (n.count > 0) {
        for (int32_t i = 0; i < n.count; ++i) {
          int32_t t = tri_order_[n.left + i];
          V3 a = v_[f_[3 * t]], b = v_[f_[3 * t + 1]], c = v_[f_[3 * t + 2]];
          Feature feat;
          V3 q = closest_on_triangle(p, a, b, c, &feat);
          V3 d = p - q;
          float sq = dot(d, d);
          if (sq < best) {
            best = sq;
            best_tri = t;
            best_feat = feat;
            best_cp = q;
          }
        }
      } else {
        // visit nearer child first (better pruning)
        float dl = aabb_sqdist(nodes_[n.left], p);
        float dr = aabb_sqdist(nodes_[n.right], p);
        int32_t first = n.left, second = n.right;
        if (dr < dl) std::swap(first, second);
        if (sp + 2 <= 128) {
          stack[sp++] = second;
          stack[sp++] = first;
        } else {  // pathological depth: drop pruning order, keep correctness
          stack[sp - 1] = first;
        }
      }
    }

    V3 pn = Pseudonormal(best_tri, best_feat);
    *sgn = dot(pn, p - best_cp) >= 0.f ? 1.f : -1.f;
    *face = best_tri;
    *cp = best_cp;
    return std::sqrt(best);
  }

 private:
  void BuildNormals() {
    fn_.resize(nf_);
    vn_.assign(nv_, V3{0, 0, 0});
    auto ekey = [](int32_t a, int32_t b) -> uint64_t {
      if (a > b) std::swap(a, b);
      return (static_cast<uint64_t>(static_cast<uint32_t>(a)) << 32) |
             static_cast<uint32_t>(b);
    };
    std::unordered_map<uint64_t, int32_t> eid;
    eid.reserve(static_cast<size_t>(nf_) * 2);
    edge_of_face_.resize(static_cast<size_t>(nf_) * 3);
    for (int32_t t = 0; t < nf_; ++t) {
      int32_t ia = f_[3 * t], ib = f_[3 * t + 1], ic = f_[3 * t + 2];
      V3 a = v_[ia], b = v_[ib], c = v_[ic];
      V3 n = cross(b - a, c - a);  // area-weighted
      V3 nn = normalized(n);
      fn_[t] = nn;
      // angle-weighted accumulation at each corner
      V3 ea1 = normalized(b - a), ea2 = normalized(c - a);
      V3 eb1 = normalized(c - b), eb2 = normalized(a - b);
      V3 ec1 = normalized(a - c), ec2 = normalized(b - c);
      auto ang = [](V3 u, V3 w) {
        return std::acos(std::min(1.f, std::max(-1.f, dot(u, w))));
      };
      vn_[ia] = vn_[ia] + nn * ang(ea1, ea2);
      vn_[ib] = vn_[ib] + nn * ang(eb1, eb2);
      vn_[ic] = vn_[ic] + nn * ang(ec1, ec2);
      // edge normals: sum of adjacent face normals
      const int32_t pairs[3][2] = {{ia, ib}, {ia, ic}, {ib, ic}};
      for (int e = 0; e < 3; ++e) {
        uint64_t k = ekey(pairs[e][0], pairs[e][1]);
        auto it = eid.find(k);
        int32_t id;
        if (it == eid.end()) {
          id = static_cast<int32_t>(en_.size());
          eid.emplace(k, id);
          en_.push_back(V3{0, 0, 0});
        } else {
          id = it->second;
        }
        en_[id] = en_[id] + nn;
        edge_of_face_[3 * t + e] = id;
      }
    }
  }

  V3 Pseudonormal(int32_t t, Feature feat) const {
    if (t < 0) return V3{0, 0, 1};
    switch (feat) {
      case kInterior:
        return fn_[t];
      case kEdgeAB:
        return en_[edge_of_face_[3 * t + 0]];
      case kEdgeAC:
        return en_[edge_of_face_[3 * t + 1]];
      case kEdgeBC:
        return en_[edge_of_face_[3 * t + 2]];
      case kVertA:
        return vn_[f_[3 * t]];
      case kVertB:
        return vn_[f_[3 * t + 1]];
      default:
        return vn_[f_[3 * t + 2]];
    }
  }

  void BuildBVH() {
    tri_order_.resize(nf_);
    for (int32_t i = 0; i < nf_; ++i) tri_order_[i] = i;
    cent_.resize(nf_);
    for (int32_t t = 0; t < nf_; ++t) {
      V3 a = v_[f_[3 * t]], b = v_[f_[3 * t + 1]], c = v_[f_[3 * t + 2]];
      cent_[t] = (a + b + c) * (1.f / 3.f);
    }
    nodes_.reserve(static_cast<size_t>(nf_) * 2);
    nodes_.push_back(Node{});
    BuildRange(0, 0, nf_);
    cent_.clear();
    cent_.shrink_to_fit();
  }

  void BuildRange(int32_t ni, int32_t start, int32_t count) {
    Node& n0 = nodes_[ni];
    float bmin[3] = {3.4e38f, 3.4e38f, 3.4e38f};
    float bmax[3] = {-3.4e38f, -3.4e38f, -3.4e38f};
    for (int32_t i = start; i < start + count; ++i) {
      int32_t t = tri_order_[i];
      for (int c = 0; c < 3; ++c) {
        const V3& p = v_[f_[3 * t + c]];
        const float pv[3] = {p.x, p.y, p.z};
        for (int k = 0; k < 3; ++k) {
          bmin[k] = std::min(bmin[k], pv[k]);
          bmax[k] = std::max(bmax[k], pv[k]);
        }
      }
    }
    std::memcpy(n0.bmin, bmin, sizeof(bmin));
    std::memcpy(n0.bmax, bmax, sizeof(bmax));
    if (count <= kLeafSize) {
      n0.left = start;
      n0.count = count;
      n0.right = -1;
      return;
    }
    // split on the longest centroid axis at the median
    float cmin[3] = {3.4e38f, 3.4e38f, 3.4e38f};
    float cmax[3] = {-3.4e38f, -3.4e38f, -3.4e38f};
    for (int32_t i = start; i < start + count; ++i) {
      const V3& p = cent_[tri_order_[i]];
      const float pv[3] = {p.x, p.y, p.z};
      for (int k = 0; k < 3; ++k) {
        cmin[k] = std::min(cmin[k], pv[k]);
        cmax[k] = std::max(cmax[k], pv[k]);
      }
    }
    int axis = 0;
    float ext = cmax[0] - cmin[0];
    for (int k = 1; k < 3; ++k) {
      if (cmax[k] - cmin[k] > ext) {
        ext = cmax[k] - cmin[k];
        axis = k;
      }
    }
    int32_t mid = start + count / 2;
    std::nth_element(
        tri_order_.begin() + start, tri_order_.begin() + mid,
        tri_order_.begin() + start + count, [&](int32_t a, int32_t b) {
          const float* pa = &cent_[a].x;
          const float* pb = &cent_[b].x;
          return pa[axis] < pb[axis];
        });
    if (mid == start) ++mid;  // all-equal centroids: force progress
    int32_t li = static_cast<int32_t>(nodes_.size());
    nodes_.push_back(Node{});
    nodes_.push_back(Node{});
    // re-fetch: push_back may have reallocated
    nodes_[ni].left = li;
    nodes_[ni].right = li + 1;
    nodes_[ni].count = 0;
    BuildRange(li, start, mid - start);
    BuildRange(li + 1, mid, start + count - mid);
  }

  static constexpr int32_t kLeafSize = 8;
  int32_t nv_, nf_;
  std::vector<V3> v_;
  std::vector<int32_t> f_;
  std::vector<V3> fn_, vn_, en_, cent_;
  std::vector<int32_t> edge_of_face_;
  std::vector<Node> nodes_;
  std::vector<int32_t> tri_order_;
};

void QueryRange(const MeshSDF* m, const float* pts, int64_t lo, int64_t hi,
                float* out_sdf, float* out_cp, int32_t* out_face,
                int sign_mode) {
  for (int64_t i = lo; i < hi; ++i) {
    V3 p{pts[3 * i], pts[3 * i + 1], pts[3 * i + 2]};
    float sgn;
    int32_t face;
    V3 cp;
    float d = m->Query(p, &sgn, &face, &cp);
    float s = (sign_mode == 2) ? d : (sign_mode == 1 ? -sgn * d : sgn * d);
    out_sdf[i] = s;
    if (out_cp) {
      out_cp[3 * i] = cp.x;
      out_cp[3 * i + 1] = cp.y;
      out_cp[3 * i + 2] = cp.z;
    }
    if (out_face) out_face[i] = face;
  }
}

}  // namespace

extern "C" {

void* msdf_build(const float* verts, int32_t nv, const int32_t* faces,
                 int32_t nf) {
  if (nv <= 0 || nf <= 0) return nullptr;
  return new MeshSDF(verts, nv, faces, nf);
}

void msdf_free(void* h) { delete static_cast<MeshSDF*>(h); }

// sign_mode: 0 = negative inside (conventional SDF), 1 = positive inside
// (the pipeline convention, ref hmsdf.py:237 negates pysdf), 2 = unsigned.
// out_cp ([n,3]) and out_face ([n]) may be NULL.
void msdf_query(void* h, const float* pts, int64_t n, float* out_sdf,
                float* out_cp, int32_t* out_face, int32_t sign_mode,
                int32_t n_threads) {
  const MeshSDF* m = static_cast<const MeshSDF*>(h);
  int hw = static_cast<int>(std::thread::hardware_concurrency());
  int T = n_threads > 0 ? n_threads : (hw > 0 ? hw : 1);
  if (static_cast<int64_t>(T) > n) T = static_cast<int>(n > 0 ? n : 1);
  if (T <= 1) {
    QueryRange(m, pts, 0, n, out_sdf, out_cp, out_face, sign_mode);
    return;
  }
  std::vector<std::thread> th;
  th.reserve(T);
  int64_t chunk = (n + T - 1) / T;
  for (int t = 0; t < T; ++t) {
    int64_t lo = t * chunk, hi = std::min<int64_t>(n, lo + chunk);
    if (lo >= hi) break;
    th.emplace_back(QueryRange, m, pts, lo, hi, out_sdf, out_cp, out_face,
                    sign_mode);
  }
  for (auto& t : th) t.join();
}

}  // extern "C"

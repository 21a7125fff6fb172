// Native mesh-preprocessing runtime.
//
// C++17 reimplementation of the irregular host stage (the part the reference
// keeps native too: reference/mesh.cpp): vertex welding by axis-interval
// proximity, manifold topology extraction, flood-fill outward normal
// orientation, and angle-weighted vertex-average normals.  Exposed as a
// C ABI consumed from Python via ctypes (cbtr_tpu/native/__init__.py); the
// NumPy implementation in cbtr_tpu/mesh/core.py is the behavioural oracle.
//
// Algorithms follow reference/mesh.cpp:
//   welding          mesh.cpp:14-91  (epsilon = 0.2 x smallest side)
//   edge->face map   mesh.cpp:118-153
//   fellow tables    mesh.cpp:185-222 (resolve table :216)
//   flood fill       mesh.cpp:224-357 (near-coplanar perturbation :265-274)
//   vertex averages  mesh.cpp:284-308
#include <algorithm>
#include <array>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <limits>
#include <map>
#include <numeric>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

using Vec3 = std::array<float, 3>;

inline Vec3 sub(const Vec3 &a, const Vec3 &b) {
  return {a[0] - b[0], a[1] - b[1], a[2] - b[2]};
}
inline Vec3 add(const Vec3 &a, const Vec3 &b) {
  return {a[0] + b[0], a[1] + b[1], a[2] + b[2]};
}
inline Vec3 mul(const Vec3 &a, float s) { return {a[0] * s, a[1] * s, a[2] * s}; }
inline float dot(const Vec3 &a, const Vec3 &b) {
  return a[0] * b[0] + a[1] * b[1] + a[2] * b[2];
}
inline Vec3 cross(const Vec3 &a, const Vec3 &b) {
  return {a[1] * b[2] - a[2] * b[1], a[2] * b[0] - a[0] * b[2],
          a[0] * b[1] - a[1] * b[0]};
}
inline float norm(const Vec3 &a) { return std::sqrt(dot(a, a)); }

struct Mesh {
  std::vector<Vec3> verts;  // 3 per face
  int32_t F = 0;

  Vec3 &at(int32_t f, int32_t c) { return verts[3 * f + c]; }
  const Vec3 &at(int32_t f, int32_t c) const { return verts[3 * f + c]; }
};

constexpr float kWeldEpsilonFactor = 0.2f;          // mesh.h:20
constexpr float kNormalsEpsilon = 0.01f;            // mesh.h:21
constexpr float kIndependentMoveFactor = 0.2f;      // mesh.h:22

float smallestSide(const Mesh &m) {
  float best = std::numeric_limits<float>::max();
  for (int32_t f = 0; f < m.F; ++f)
    for (int32_t c = 0; c < 3; ++c)
      best = std::min(best, norm(sub(m.at(f, c), m.at(f, (c + 1) % 3))));
  return best;
}

// ---------------------------------------------------------------------------
// vertex welding (mesh.cpp:14-91)
// ---------------------------------------------------------------------------
struct UnionFind {
  std::vector<int32_t> parent;
  explicit UnionFind(size_t n) : parent(n) {
    std::iota(parent.begin(), parent.end(), 0);
  }
  int32_t find(int32_t a) {
    while (parent[a] != a) {
      parent[a] = parent[parent[a]];
      a = parent[a];
    }
    return a;
  }
  void unite(int32_t a, int32_t b) {
    a = find(a);
    b = find(b);
    if (a != b) parent[std::max(a, b)] = std::min(a, b);
  }
};

void standardizeVertices(Mesh &m) {
  if (m.F == 0) return;
  const float eps = smallestSide(m) * kWeldEpsilonFactor;
  const float eps2 = eps * eps;
  const size_t N = m.verts.size();

  // dedup exact duplicates first (instances of a point behave identically)
  std::map<Vec3, int32_t> uniqMap;
  std::vector<int32_t> inverse(N);
  std::vector<Vec3> uniq;
  for (size_t i = 0; i < N; ++i) {
    auto it = uniqMap.find(m.verts[i]);
    if (it == uniqMap.end()) {
      it = uniqMap.emplace(m.verts[i], (int32_t)uniq.size()).first;
      uniq.push_back(m.verts[i]);
    }
    inverse[i] = it->second;
  }

  // per-axis projections -> proximity intervals; pick axis with smallest
  // largest-interval population (mesh.cpp:86-88)
  int bestAxis = 0;
  size_t bestMax = std::numeric_limits<size_t>::max();
  std::vector<std::pair<size_t, size_t>> bestIntervals;
  std::vector<int32_t> order(N), bestOrder;
  for (int axis = 0; axis < 3; ++axis) {
    std::iota(order.begin(), order.end(), 0);
    std::stable_sort(order.begin(), order.end(), [&](int32_t a, int32_t b) {
      return m.verts[a][axis] < m.verts[b][axis];
    });
    std::vector<std::pair<size_t, size_t>> intervals;
    size_t start = 0;
    float startVal = m.verts[order[0]][axis];
    size_t maxPop = 0;
    for (size_t i = 1; i < N; ++i) {
      const float v = m.verts[order[i]][axis];
      if (v - startVal >= eps) {
        intervals.emplace_back(start, i);
        maxPop = std::max(maxPop, i - start);
        start = i;
        startVal = v;
      }
    }
    intervals.emplace_back(start, N);
    maxPop = std::max(maxPop, N - start);
    if (maxPop < bestMax) {
      bestMax = maxPop;
      bestAxis = axis;
      bestIntervals = std::move(intervals);
      bestOrder = order;
    }
  }
  (void)bestAxis;

  // weld within intervals: union of epsilon-close unique vertices
  UnionFind uf(uniq.size());
  std::vector<int32_t> members;
  for (auto [s, e] : bestIntervals) {
    members.clear();
    for (size_t i = s; i < e; ++i) members.push_back(inverse[bestOrder[i]]);
    std::sort(members.begin(), members.end());
    members.erase(std::unique(members.begin(), members.end()), members.end());
    for (size_t a = 0; a < members.size(); ++a)
      for (size_t b = a + 1; b < members.size(); ++b) {
        const Vec3 d = sub(uniq[members[a]], uniq[members[b]]);
        if (dot(d, d) < eps2) uf.unite(members[a], members[b]);
      }
  }

  // representative = lexicographically largest member of each cluster
  std::vector<int32_t> repIdx(uniq.size());
  std::iota(repIdx.begin(), repIdx.end(), 0);
  for (size_t i = 0; i < uniq.size(); ++i) {
    const int32_t r = uf.find((int32_t)i);
    if (uniq[i] > uniq[repIdx[r]] || (int32_t)i == repIdx[r]) {
      if (uniq[i] > uniq[repIdx[r]]) repIdx[r] = (int32_t)i;
    }
  }
  for (size_t i = 0; i < N; ++i)
    m.verts[i] = uniq[repIdx[uf.find(inverse[i])]];
}

// ---------------------------------------------------------------------------
// topology (mesh.cpp:118-222)
// ---------------------------------------------------------------------------
struct Topology {
  std::vector<int32_t> face2vertex;   // [F*3]
  std::vector<Vec3> vertices;         // [V]
  std::vector<int32_t> fellow;        // [F*3]
  std::vector<int8_t> fellowStart;    // [F*3]
};

// common-side-start resolve table (mesh.cpp:216), indexed by positions of
// (v0, v1) inside the fellow face
constexpr int8_t kResolve[3][3] = {{3, 0, 2}, {0, 3, 1}, {2, 1, 3}};

bool buildTopology(const Mesh &m, Topology &topo, std::string &err) {
  const size_t N = m.verts.size();
  std::map<Vec3, int32_t> vmap;
  topo.face2vertex.resize(N);
  topo.vertices.clear();
  for (size_t i = 0; i < N; ++i) {
    auto it = vmap.find(m.verts[i]);
    if (it == vmap.end()) {
      it = vmap.emplace(m.verts[i], (int32_t)topo.vertices.size()).first;
      topo.vertices.push_back(m.verts[i]);
    }
    topo.face2vertex[i] = it->second;
  }

  std::map<std::pair<int32_t, int32_t>, std::vector<int32_t>> edge2instance;
  for (int32_t f = 0; f < m.F; ++f)
    for (int32_t s = 0; s < 3; ++s) {
      const int32_t a = topo.face2vertex[3 * f + s];
      const int32_t b = topo.face2vertex[3 * f + (s + 1) % 3];
      edge2instance[{std::min(a, b), std::max(a, b)}].push_back(3 * f + s);
    }

  topo.fellow.assign(N, -1);
  topo.fellowStart.assign(N, 3);
  for (auto &[edge, insts] : edge2instance) {
    if (insts.size() != 2) {
      err = "Vertex on edge detected.";  // mesh.cpp:204
      return false;
    }
    topo.fellow[insts[0]] = insts[1] / 3;
    topo.fellow[insts[1]] = insts[0] / 3;
  }
  for (int32_t f = 0; f < m.F; ++f)
    for (int32_t s = 0; s < 3; ++s) {
      const int32_t v0 = topo.face2vertex[3 * f + s];
      const int32_t v1 = topo.face2vertex[3 * f + (s + 1) % 3];
      const int32_t other = topo.fellow[3 * f + s];
      int p0 = -1, p1 = -1;
      for (int c = 0; c < 3; ++c) {
        if (topo.face2vertex[3 * other + c] == v0) p0 = c;
        if (topo.face2vertex[3 * other + c] == v1) p1 = c;
      }
      if (p0 < 0 || p1 < 0 || kResolve[p0][p1] == 3) {
        err = "Inconsistent neighbour topology.";
        return false;
      }
      topo.fellowStart[3 * f + s] = kResolve[p0][p1];
    }
  return true;
}

// ---------------------------------------------------------------------------
// normal orientation flood fill (mesh.cpp:224-357)
// ---------------------------------------------------------------------------
Vec3 faceNormal(const Mesh &m, int32_t f) {
  return cross(sub(m.at(f, 1), m.at(f, 0)), sub(m.at(f, 2), m.at(f, 0)));
}

Vec3 altitude(const Vec3 &c1, const Vec3 &c2, const Vec3 &indep) {
  const Vec3 common = sub(c2, c1);
  const Vec3 rel = sub(indep, c1);
  const float den = dot(common, common);
  const float foot = den > 1e-30f ? dot(common, rel) / den : 0.0f;
  return sub(rel, mul(common, foot));
}

void swapCorners(Mesh &m, Topology &topo, int32_t f, int c1, int c2) {
  std::swap(m.at(f, c1), m.at(f, c2));
  std::swap(topo.face2vertex[3 * f + c1], topo.face2vertex[3 * f + c2]);
}

void normalizeAgainst(Mesh &m, Topology &topo, int32_t known, int32_t unknown) {
  // find the vertex of each face not shared with the other (mesh.cpp:250-262)
  int ik = -1, iu = -1;
  for (int c = 0; c < 3; ++c) {
    const int32_t id = topo.face2vertex[3 * known + c];
    bool shared = false;
    for (int d = 0; d < 3; ++d)
      shared |= topo.face2vertex[3 * unknown + d] == id;
    if (!shared) { ik = c; break; }
  }
  for (int c = 0; c < 3; ++c) {
    const int32_t id = topo.face2vertex[3 * unknown + c];
    bool shared = false;
    for (int d = 0; d < 3; ++d)
      shared |= topo.face2vertex[3 * known + d] == id;
    if (!shared) { iu = c; break; }
  }
  const int c1k = (ik + 1) % 3, c2k = (ik + 2) % 3;
  const int c1u = (iu + 1) % 3, c2u = (iu + 2) % 3;

  const Vec3 altK = altitude(m.at(known, c1k), m.at(known, c2k), m.at(known, ik));
  Vec3 altU = altitude(m.at(unknown, c1u), m.at(unknown, c2u), m.at(unknown, iu));
  float dotAlt = dot(altK, altU);
  Vec3 nK = faceNormal(m, known);
  Vec3 nU = faceNormal(m, unknown);
  float dotN = dot(nK, nU);
  const float den = norm(nK) * norm(nU);
  if (std::fabs(dotN / std::max(den, 1e-30f)) < kNormalsEpsilon) {
    // near-perpendicular: perturb the independent vertex (mesh.cpp:265-274)
    const Vec3 mid = mul(add(m.at(known, c1k), m.at(known, c2k)), 0.5f);
    const Vec3 moved =
        add(m.at(unknown, iu), mul(sub(m.at(known, ik), mid), kIndependentMoveFactor));
    altU = altitude(m.at(unknown, c1u), m.at(unknown, c2u), moved);
    dotAlt = dot(altK, altU);
    Mesh tmp;  // recompute the unknown normal with the moved vertex
    Vec3 a = m.at(unknown, 0), b = m.at(unknown, 1), c = m.at(unknown, 2);
    if (iu == 0) a = moved; else if (iu == 1) b = moved; else c = moved;
    nU = cross(sub(b, a), sub(c, a));
    dotN = dot(nK, nU);
  }
  if (dotAlt * dotN > 0.0f) swapCorners(m, topo, unknown, c1u, c2u);
}

void standardizeNormals(Mesh &m, Topology &topo, std::string &err) {
  // initial face: at the smallest-x vertex instance, most parallel to (-1,0,0)
  size_t smallestInstance = 0;
  for (size_t i = 1; i < m.verts.size(); ++i)
    if (m.verts[i][0] < m.verts[smallestInstance][0]) smallestInstance = i;
  const int32_t vid = topo.face2vertex[smallestInstance];

  int32_t initial = -1;
  float bestAbs = -1.0f;
  for (int32_t f = 0; f < m.F; ++f) {
    bool touches = false;
    for (int c = 0; c < 3; ++c) touches |= topo.face2vertex[3 * f + c] == vid;
    if (!touches) continue;
    Vec3 n = faceNormal(m, f);
    const float ln = norm(n);
    const float a = ln > 1e-30f ? std::fabs(-n[0] / ln) : 0.0f;
    if (a > bestAbs) { bestAbs = a; initial = f; }
  }
  if (faceNormal(m, initial)[0] > 0.0f)  // want alignment with (-1,0,0)
    swapCorners(m, topo, initial, 0, 1);

  // LIFO flood fill (mesh.cpp:334-350)
  std::vector<uint8_t> remaining(m.F, 1);
  remaining[initial] = 0;
  std::vector<std::pair<int32_t, int32_t>> stack;
  for (int s = 0; s < 3; ++s) stack.emplace_back(initial, topo.fellow[3 * initial + s]);
  while (!stack.empty()) {
    auto [known, unknown] = stack.back();
    stack.pop_back();
    if (remaining[unknown]) normalizeAgainst(m, topo, known, unknown);
    remaining[unknown] = 0;
    for (int s = 0; s < 3; ++s) {
      const int32_t nb = topo.fellow[3 * unknown + s];
      if (remaining[nb] && nb != unknown) stack.emplace_back(unknown, nb);
    }
  }

  // rebuild: swaps changed side indexing (mesh.cpp:352-355)
  if (!buildTopology(m, topo, err)) return;
}

void vertexAverageNormals(const Mesh &m, const Topology &topo,
                          std::vector<Vec3> &out) {
  out.assign(topo.vertices.size(), {0, 0, 0});
  std::vector<std::array<double, 3>> sums(topo.vertices.size(), {0, 0, 0});
  for (int32_t f = 0; f < m.F; ++f) {
    Vec3 n = faceNormal(m, f);
    const float ln = std::max(norm(n), 1e-30f);
    n = mul(n, 1.0f / ln);
    for (int c = 0; c < 3; ++c) {
      const Vec3 a = sub(m.at(f, (c + 1) % 3), m.at(f, c));
      const Vec3 b = sub(m.at(f, (c + 2) % 3), m.at(f, c));
      const float den = std::max(norm(a) * norm(b), 1e-30f);
      const float angle =
          std::acos(std::min(1.0f, std::max(-1.0f, dot(a, b) / den)));
      auto &s = sums[topo.face2vertex[3 * f + c]];
      s[0] += (double)n[0] * angle;
      s[1] += (double)n[1] * angle;
      s[2] += (double)n[2] * angle;
    }
  }
  for (size_t v = 0; v < sums.size(); ++v) {
    const double ln = std::sqrt(sums[v][0] * sums[v][0] + sums[v][1] * sums[v][1] +
                                sums[v][2] * sums[v][2]);
    const double inv = ln > 1e-30 ? 1.0 / ln : 0.0;
    out[v] = {(float)(sums[v][0] * inv), (float)(sums[v][1] * inv),
              (float)(sums[v][2] * inv)};
  }
}

}  // namespace

extern "C" {

// Full preprocessing pipeline over a triangle soup, in place.
//   tris:               [F*9] floats, welded+reoriented on return
//   fellow:             [F*3] int32 out
//   fellow_starts:      [F*3] int32 out
//   corner_avg_normals: [F*9] float out (vertex-average normal per corner)
// Returns 0 on success; on failure writes a message into err.
int cbtr_preprocess(float *tris, int32_t nfaces, int32_t *fellow,
                    int32_t *fellow_starts, float *corner_avg_normals,
                    char *err, int32_t errlen) {
  Mesh m;
  m.F = nfaces;
  m.verts.resize((size_t)nfaces * 3);
  std::memcpy(m.verts.data(), tris, sizeof(float) * 9 * nfaces);

  std::string msg;
  standardizeVertices(m);
  Topology topo;
  if (!buildTopology(m, topo, msg)) {
    std::strncpy(err, msg.c_str(), errlen - 1);
    return 1;
  }
  standardizeNormals(m, topo, msg);
  if (!msg.empty()) {
    std::strncpy(err, msg.c_str(), errlen - 1);
    return 1;
  }
  std::vector<Vec3> avg;
  vertexAverageNormals(m, topo, avg);

  std::memcpy(tris, m.verts.data(), sizeof(float) * 9 * nfaces);
  for (int32_t i = 0; i < nfaces * 3; ++i) {
    fellow[i] = topo.fellow[i];
    fellow_starts[i] = topo.fellowStart[i];
    const Vec3 &n = avg[topo.face2vertex[i]];
    corner_avg_normals[3 * i + 0] = n[0];
    corner_avg_normals[3 * i + 1] = n[1];
    corner_avg_normals[3 * i + 2] = n[2];
  }
  return 0;
}

// Standalone welding (for tests / pipelines that only need welding).
int cbtr_weld(float *tris, int32_t nfaces) {
  Mesh m;
  m.F = nfaces;
  m.verts.resize((size_t)nfaces * 3);
  std::memcpy(m.verts.data(), tris, sizeof(float) * 9 * nfaces);
  standardizeVertices(m);
  std::memcpy(tris, m.verts.data(), sizeof(float) * 9 * nfaces);
  return 0;
}
}

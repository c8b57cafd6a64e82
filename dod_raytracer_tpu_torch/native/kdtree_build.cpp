// Native SAH kd-tree builder.
//
// C++ implementation of the host-side scene-compile step with the exact
// contract of the numpy reference builder (accel/_kdtree_np.py), which in
// turn mirrors the reference tracer's recursive SAH build
// (src/accelerators/kdtree.cpp:66-260 in AVassilev98/dod_raytracer):
// preorder nodes (left child = idx+1, right patched), straddler lane
// duplication, floor-truncated cost comparisons (the reference's
// unsigned-from-float assignment), right-empty-only bonus, and the
// maxDepth = round(log2(8 + 1.3 N)) cap.
//
// Exposed through a C ABI consumed via ctypes (native/__init__.py); the
// Python side supplies per-lane AABBs and receives flat arrays.
//
// Build: see native/build.py (g++ -O2 -std=c++17 -ffp-contract=off -shared
// -fPIC: no contracted FMA may move a truncated cost, so the tree is the
// numpy builder's bits).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <limits>
#include <vector>

namespace {

struct Edge {
  float offset;
  int32_t lane;
  bool is_end;
};

struct Builder {
  const float* lane_min;  // (L, 3)
  const float* lane_max;  // (L, 3)
  int32_t num_lanes;
  int32_t max_prims;
  double intersect_cost;
  double traversal_cost;
  double empty_bonus;

  std::vector<int32_t> node_flag;
  std::vector<float> node_split;
  std::vector<int32_t> node_right;
  std::vector<int32_t> node_leaf_start;
  std::vector<int32_t> node_leaf_lanes;
  std::vector<int32_t> prim_nums;
  int32_t max_leaf_lanes = 0;
  int32_t max_depth = 0;

  void add_leaf(const std::vector<int32_t>& lanes) {
    node_flag.push_back(3);
    node_split.push_back(0.0f);
    node_right.push_back(0);
    node_leaf_start.push_back(static_cast<int32_t>(prim_nums.size()));
    node_leaf_lanes.push_back(static_cast<int32_t>(lanes.size()));
    prim_nums.insert(prim_nums.end(), lanes.begin(), lanes.end());
    max_leaf_lanes = std::max(max_leaf_lanes, static_cast<int32_t>(lanes.size()));
  }

  static double surface_area(const double bmin[3], const double bmax[3]) {
    double d0 = bmax[0] - bmin[0], d1 = bmax[1] - bmin[1], d2 = bmax[2] - bmin[2];
    return 2.0 * (d0 * d1 + d0 * d2 + d1 * d2);
  }

  void recurse(int depth, int bad_refines, double bmin[3], double bmax[3],
               std::vector<int32_t>& lanes) {
    if (depth == 0 || static_cast<int32_t>(lanes.size()) <= max_prims) {
      add_leaf(lanes);
      return;
    }
    const size_t n = lanes.size();
    const double original_cost = intersect_cost * static_cast<double>(n);
    const double inv_sa = 1.0 / surface_area(bmin, bmax);
    double extent[3] = {bmax[0] - bmin[0], bmax[1] - bmin[1], bmax[2] - bmin[2]};
    int max_axis = 0;
    if (extent[1] > extent[max_axis]) max_axis = 1;
    if (extent[2] > extent[max_axis]) max_axis = 2;

    double best_floor = std::numeric_limits<double>::infinity();
    int best_axis = -1;
    int64_t best_j = -1;
    float best_offset = 0.0f;
    std::vector<Edge> edges_by_axis[3];

    for (int k = 0; k < 3; ++k) {
      const int axis = (max_axis + k) % 3;
      std::vector<Edge>& edges = edges_by_axis[axis];
      edges.reserve(2 * n);
      for (size_t i = 0; i < n; ++i) {
        const int32_t lane = lanes[i];
        edges.push_back({lane_min[lane * 3 + axis], lane, false});
        edges.push_back({lane_max[lane * 3 + axis], lane, true});
      }
      std::stable_sort(edges.begin(), edges.end(),
                       [](const Edge& a, const Edge& b) { return a.offset < b.offset; });

      int64_t n_left = 0;
      int64_t n_right = static_cast<int64_t>(n);
      const double o1 = extent[(axis + 1) % 3];
      const double o2 = extent[(axis + 2) % 3];
      for (size_t j = 0; j < edges.size(); ++j) {
        const Edge& e = edges[j];
        if (e.is_end) --n_right;
        if (e.offset >= bmin[axis] && e.offset <= bmax[axis]) {
          const double dl = e.offset - bmin[axis];
          const double dr = bmax[axis] - e.offset;
          const double sa_l = 2.0 * (dl * o1 + dl * o2 + o1 * o2);
          const double sa_r = 2.0 * (dr * o1 + dr * o2 + o1 * o2);
          const double eb = (n_right == 0) ? empty_bonus : 0.0;
          const double cost =
              traversal_cost + intersect_cost * (1.0 - eb) *
                                   (sa_l * inv_sa * n_left + sa_r * inv_sa * n_right);
          const double fl = std::floor(cost);
          if (fl < best_floor) {
            best_floor = fl;
            best_axis = axis;
            best_j = static_cast<int64_t>(j);
            best_offset = e.offset;
          }
        }
        if (!e.is_end) ++n_left;
      }
      if (best_floor < original_cost) break;  // kdtree.cpp:196-199
    }

    if (best_floor > original_cost) ++bad_refines;  // kdtree.cpp:202-205
    if (best_axis < 0 || bad_refines == 3 ||
        (best_floor > 4 * original_cost && n < 16)) {  // kdtree.cpp:208-214
      add_leaf(lanes);
      return;
    }

    const std::vector<Edge>& edges = edges_by_axis[best_axis];
    std::vector<int32_t> left_lanes, right_lanes;
    for (int64_t i = 0; i < best_j; ++i)
      if (!edges[i].is_end) left_lanes.push_back(edges[i].lane);
    for (size_t i = best_j + 1; i < edges.size(); ++i)
      if (edges[i].is_end) right_lanes.push_back(edges[i].lane);

    const size_t my_idx = node_flag.size();
    node_flag.push_back(best_axis);
    node_split.push_back(best_offset);
    node_right.push_back(0);
    node_leaf_start.push_back(0);
    node_leaf_lanes.push_back(0);

    double lmax[3] = {bmax[0], bmax[1], bmax[2]};
    double rmin[3] = {bmin[0], bmin[1], bmin[2]};
    lmax[best_axis] = best_offset;
    rmin[best_axis] = best_offset;
    recurse(depth - 1, bad_refines, bmin, lmax, left_lanes);
    node_right[my_idx] = static_cast<int32_t>(node_flag.size());
    recurse(depth - 1, bad_refines, rmin, bmax, right_lanes);
  }

  void build() {
    max_depth = static_cast<int>(
        std::floor(std::log2(8.0 + 1.3 * static_cast<double>(num_lanes)) + 0.5));
    double bmin[3], bmax[3];
    for (int a = 0; a < 3; ++a) {
      bmin[a] = std::numeric_limits<double>::infinity();
      bmax[a] = -std::numeric_limits<double>::infinity();
    }
    for (int32_t i = 0; i < num_lanes; ++i) {
      for (int a = 0; a < 3; ++a) {
        bmin[a] = std::min(bmin[a], static_cast<double>(lane_min[i * 3 + a]));
        bmax[a] = std::max(bmax[a], static_cast<double>(lane_max[i * 3 + a]));
      }
    }
    std::vector<int32_t> all(num_lanes);
    for (int32_t i = 0; i < num_lanes; ++i) all[i] = i;
    recurse(max_depth, 0, bmin, bmax, all);
  }
};

}  // namespace

extern "C" {

void* kd_build(const float* lane_min, const float* lane_max, int32_t num_lanes,
               int32_t max_prims, double intersect_cost, double traversal_cost,
               double empty_bonus) {
  auto* b = new Builder();
  b->lane_min = lane_min;
  b->lane_max = lane_max;
  b->num_lanes = num_lanes;
  b->max_prims = max_prims;
  b->intersect_cost = intersect_cost;
  b->traversal_cost = traversal_cost;
  b->empty_bonus = empty_bonus;
  b->build();
  return b;
}

int32_t kd_num_nodes(void* h) { return static_cast<int32_t>(static_cast<Builder*>(h)->node_flag.size()); }
int32_t kd_num_prims(void* h) { return static_cast<int32_t>(static_cast<Builder*>(h)->prim_nums.size()); }
int32_t kd_max_leaf_lanes(void* h) { return static_cast<Builder*>(h)->max_leaf_lanes; }
int32_t kd_max_depth(void* h) { return static_cast<Builder*>(h)->max_depth; }

void kd_copy(void* h, int32_t* flag, float* split, int32_t* right,
             int32_t* leaf_start, int32_t* leaf_lanes, int32_t* prims) {
  auto* b = static_cast<Builder*>(h);
  std::memcpy(flag, b->node_flag.data(), b->node_flag.size() * sizeof(int32_t));
  std::memcpy(split, b->node_split.data(), b->node_split.size() * sizeof(float));
  std::memcpy(right, b->node_right.data(), b->node_right.size() * sizeof(int32_t));
  std::memcpy(leaf_start, b->node_leaf_start.data(), b->node_leaf_start.size() * sizeof(int32_t));
  std::memcpy(leaf_lanes, b->node_leaf_lanes.data(), b->node_leaf_lanes.size() * sizeof(int32_t));
  std::memcpy(prims, b->prim_nums.data(), b->prim_nums.size() * sizeof(int32_t));
}

void kd_free(void* h) { delete static_cast<Builder*>(h); }

}  // extern "C"

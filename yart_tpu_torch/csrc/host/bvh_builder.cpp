// Native binned-SAH BVH builder: the scene builder's triangle tree.
//
// Copy of yart_tpu/native/bvh_builder.cpp (the same algorithm and C ABI):
// binned SAH over all 3 axes as in the reference's src/core/bvh.hpp:41-348,
// a two-direction cost sweep and the leaf-vs-split test, emitting the flat
// node arrays of yart_tpu_torch/scene/bvh.py HostBVH. Loaded over ctypes by
// yart_tpu_torch/native.py; the numpy build_bvh in scene/bvh.py is its twin.
//
// Built at first use by yart_tpu_torch/kernels/build.py with
// g++ -O3 -std=c++17 -shared -fPIC -ffp-contract=off: no -march=native and
// no FMA contraction, so the tree is the same on every x86-64 host.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <limits>
#include <vector>

namespace {

struct V3 {
  float x, y, z;
};

inline V3 vmin(const V3 &a, const V3 &b) {
  return {std::min(a.x, b.x), std::min(a.y, b.y), std::min(a.z, b.z)};
}
inline V3 vmax(const V3 &a, const V3 &b) {
  return {std::max(a.x, b.x), std::max(a.y, b.y), std::max(a.z, b.z)};
}

struct AABB {
  V3 lo{std::numeric_limits<float>::infinity(),
        std::numeric_limits<float>::infinity(),
        std::numeric_limits<float>::infinity()};
  V3 hi{-std::numeric_limits<float>::infinity(),
        -std::numeric_limits<float>::infinity(),
        -std::numeric_limits<float>::infinity()};

  void grow(const V3 &p) {
    lo = vmin(lo, p);
    hi = vmax(hi, p);
  }
  void grow(const AABB &b) {
    lo = vmin(lo, b.lo);
    hi = vmax(hi, b.hi);
  }
  float area() const {
    float dx = std::max(hi.x - lo.x, 0.0f);
    float dy = std::max(hi.y - lo.y, 0.0f);
    float dz = std::max(hi.z - lo.z, 0.0f);
    return dx * dy + dy * dz + dz * dx;
  }
};

struct BuildCtx {
  const AABB *tri_box;
  const V3 *cent;
  int32_t *order;
  int max_leaf;
  int n_bins;
  float *node_min;
  float *node_max;
  int32_t *left;
  int32_t *count;
  int n_nodes;
  int max_depth;
};

struct Item {
  int node, first, span, depth;
};

float centAxis(const V3 &c, int axis) {
  return axis == 0 ? c.x : (axis == 1 ? c.y : c.z);
}

void build(BuildCtx &ctx, int n_tris) {
  std::vector<Item> stack;
  stack.push_back({0, 0, n_tris, 1});
  ctx.n_nodes = 1;
  ctx.max_depth = 1;

  std::vector<AABB> bin_box(ctx.n_bins);
  std::vector<int> bin_cnt(ctx.n_bins);
  std::vector<float> r_area(ctx.n_bins);
  std::vector<int32_t> tmp;

  while (!stack.empty()) {
    Item it = stack.back();
    stack.pop_back();
    ctx.max_depth = std::max(ctx.max_depth, it.depth);

    AABB node_box;
    AABB cent_box;
    for (int i = it.first; i < it.first + it.span; i++) {
      node_box.grow(ctx.tri_box[ctx.order[i]]);
      cent_box.grow(ctx.cent[ctx.order[i]]);
    }
    ctx.node_min[it.node * 3 + 0] = node_box.lo.x;
    ctx.node_min[it.node * 3 + 1] = node_box.lo.y;
    ctx.node_min[it.node * 3 + 2] = node_box.lo.z;
    ctx.node_max[it.node * 3 + 0] = node_box.hi.x;
    ctx.node_max[it.node * 3 + 1] = node_box.hi.y;
    ctx.node_max[it.node * 3 + 2] = node_box.hi.z;

    // Leaves are capped at max_leaf so the device leaf test is fixed-width;
    // oversized-but-SAH-cheap clusters still split (unlike the reference's
    // MAX_LEAF_SIZE=20 scalar loop, bvh.hpp:14).
    bool make_leaf = it.span <= ctx.max_leaf;
    int best_axis = -1, best_bin = 0;
    float best_cost = std::numeric_limits<float>::infinity();
    float best_lo = 0.0f, best_scale = 0.0f;

    if (!make_leaf) {
      for (int axis = 0; axis < 3; axis++) {
        float c_lo = centAxis(cent_box.lo, axis);
        float c_hi = centAxis(cent_box.hi, axis);
        float ext = c_hi - c_lo;
        if (ext <= 0.0f) continue;
        float scale = ctx.n_bins / ext;

        for (int b = 0; b < ctx.n_bins; b++) {
          bin_box[b] = AABB();
          bin_cnt[b] = 0;
        }
        for (int i = it.first; i < it.first + it.span; i++) {
          int t = ctx.order[i];
          int b = std::min(
              ctx.n_bins - 1,
              (int)((centAxis(ctx.cent[t], axis) - c_lo) * scale));
          bin_box[b].grow(ctx.tri_box[t]);
          bin_cnt[b]++;
        }
        // rightward sweep areas
        AABB right;
        int rcnt = 0;
        for (int b = ctx.n_bins - 1; b > 0; b--) {
          right.grow(bin_box[b]);
          rcnt += bin_cnt[b];
          r_area[b] = rcnt > 0 ? right.area() * rcnt
                               : std::numeric_limits<float>::infinity();
        }
        AABB leftb;
        int lcnt = 0;
        for (int b = 0; b < ctx.n_bins - 1; b++) {
          leftb.grow(bin_box[b]);
          lcnt += bin_cnt[b];
          if (lcnt == 0 || lcnt == it.span) continue;
          float cost = leftb.area() * lcnt + r_area[b + 1];
          if (cost < best_cost) {
            best_cost = cost;
            best_axis = axis;
            best_bin = b;
            best_lo = c_lo;
            best_scale = scale;
          }
        }
      }

    }

    if (make_leaf) {
      ctx.left[it.node] = it.first;
      ctx.count[it.node] = it.span;
      continue;
    }

    int mid;
    if (best_axis < 0) {
      // Degenerate centroids: median split on the widest node axis.
      int axis = 0;
      float dx = node_box.hi.x - node_box.lo.x;
      float dy = node_box.hi.y - node_box.lo.y;
      float dz = node_box.hi.z - node_box.lo.z;
      if (dy > dx) axis = 1;
      if (dz > (axis == 0 ? dx : dy)) axis = 2;
      std::sort(ctx.order + it.first, ctx.order + it.first + it.span,
                [&](int32_t a, int32_t b) {
                  return centAxis(ctx.cent[a], axis) <
                         centAxis(ctx.cent[b], axis);
                });
      mid = it.span / 2;
    } else {
      auto pred = [&](int32_t t) {
        int b = std::min(ctx.n_bins - 1,
                         (int)((centAxis(ctx.cent[t], best_axis) - best_lo) *
                               best_scale));
        return b <= best_bin;
      };
      int32_t *pivot = std::partition(ctx.order + it.first,
                                      ctx.order + it.first + it.span, pred);
      mid = (int)(pivot - (ctx.order + it.first));
      if (mid == 0 || mid == it.span) {
        std::sort(ctx.order + it.first, ctx.order + it.first + it.span,
                  [&](int32_t a, int32_t b) {
                    return centAxis(ctx.cent[a], best_axis) <
                           centAxis(ctx.cent[b], best_axis);
                  });
        mid = it.span / 2;
      }
    }

    int l_child = ctx.n_nodes;
    ctx.n_nodes += 2;
    ctx.left[it.node] = l_child;
    ctx.count[it.node] = 0;
    stack.push_back({l_child + 1, it.first + mid, it.span - mid, it.depth + 1});
    stack.push_back({l_child, it.first, mid, it.depth + 1});
  }
}

}  // namespace

extern "C" {

// Returns 0 on success. Output arrays must be preallocated:
// node_min/node_max: [2n-1, 3]; left/count: [2n-1]; tri_order: [n].
int yart_build_bvh(const float *v0, const float *v1, const float *v2,
                   int n_tris, int max_leaf, int n_bins, float *node_min,
                   float *node_max, int32_t *left, int32_t *count,
                   int32_t *tri_order, int32_t *out_n_nodes,
                   int32_t *out_depth) {
  if (n_tris <= 0 || n_bins < 2 || max_leaf < 1) return 1;

  std::vector<AABB> tri_box(n_tris);
  std::vector<V3> cent(n_tris);
  for (int i = 0; i < n_tris; i++) {
    V3 a{v0[i * 3], v0[i * 3 + 1], v0[i * 3 + 2]};
    V3 b{v1[i * 3], v1[i * 3 + 1], v1[i * 3 + 2]};
    V3 c{v2[i * 3], v2[i * 3 + 1], v2[i * 3 + 2]};
    tri_box[i].grow(a);
    tri_box[i].grow(b);
    tri_box[i].grow(c);
    cent[i] = {(a.x + b.x + c.x) / 3.0f, (a.y + b.y + c.y) / 3.0f,
               (a.z + b.z + c.z) / 3.0f};
    tri_order[i] = i;
  }

  BuildCtx ctx;
  ctx.tri_box = tri_box.data();
  ctx.cent = cent.data();
  ctx.order = tri_order;
  ctx.max_leaf = max_leaf;
  ctx.n_bins = n_bins;
  ctx.node_min = node_min;
  ctx.node_max = node_max;
  ctx.left = left;
  ctx.count = count;

  build(ctx, n_tris);

  *out_n_nodes = ctx.n_nodes;
  *out_depth = ctx.max_depth;
  return 0;
}
}

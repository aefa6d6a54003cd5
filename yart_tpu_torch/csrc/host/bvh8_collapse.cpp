// Native BVH8 collapse: binary SAH tree -> 8-wide groups.
//
// Copy of yart_tpu/native/bvh8_collapse.cpp: a C++ port of collapse_bvh8
// (greedy largest-area expansion; yart_tpu_torch/scene/bvh.py holds the
// numpy twin, equal bit for bit), for scene-compile speed on large scenes.
// Same encoding: child >= 0: inner group id; == -1: empty; <= -2: leaf with
// v = -(child+2), first = v >> 4, count = v & 15. Built with the flags of
// bvh_builder.cpp.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <limits>
#include <unordered_map>
#include <vector>

namespace {

constexpr int kWidth = 8;

float area(const float* node_min, const float* node_max, int i) {
  float dx = std::max(node_max[i * 3 + 0] - node_min[i * 3 + 0], 0.0f);
  float dy = std::max(node_max[i * 3 + 1] - node_min[i * 3 + 1], 0.0f);
  float dz = std::max(node_max[i * 3 + 2] - node_min[i * 3 + 2], 0.0f);
  return dx * dy + dy * dz + dz * dx;
}

void expand(const float* node_min, const float* node_max, const int32_t* left,
            const int32_t* count, int b, std::vector<int>& slots) {
  slots.clear();
  slots.push_back(b);
  while ((int)slots.size() < kWidth) {
    int best = -1;
    float best_area = -1.0f;
    for (size_t i = 0; i < slots.size(); i++) {
      int s = slots[i];
      if (count[s] == 0) {
        float a = area(node_min, node_max, s);
        if (a > best_area) {
          best_area = a;
          best = (int)i;
        }
      }
    }
    if (best < 0) break;
    int s = slots[best];
    slots.erase(slots.begin() + best);
    slots.push_back(left[s]);
    slots.push_back(left[s] + 1);
  }
}

}  // namespace

extern "C" {

// boxes: [cap, 8, 6]; child: [cap, 8]; cap >= number of inner binary nodes+1.
int yart_collapse_bvh8(const float* node_min, const float* node_max,
                       const int32_t* left, const int32_t* count, int n_nodes,
                       int cap, float* boxes, int32_t* child, int32_t* out_m,
                       int32_t* out_depth) {
  if (n_nodes <= 0) return 1;
  const float inf = std::numeric_limits<float>::infinity();

  auto initGroup = [&](int gi) {
    for (int k = 0; k < kWidth; k++) {
      float* b = boxes + (size_t)gi * kWidth * 6 + k * 6;
      b[0] = b[1] = b[2] = inf;
      b[3] = b[4] = b[5] = -inf;
      child[(size_t)gi * kWidth + k] = -1;
    }
  };

  // Root leaf special case.
  if (count[0] > 0) {
    if (cap < 1) return 2;
    initGroup(0);
    float* b = boxes;
    std::memcpy(b, node_min, 3 * sizeof(float));
    std::memcpy(b + 3, node_max, 3 * sizeof(float));
    child[0] = -((left[0] << 4 | count[0]) + 2);
    *out_m = 1;
    *out_depth = 1;
    return 0;
  }

  std::unordered_map<int, int> group_of;
  std::vector<int> order;
  std::vector<int> stack{0};
  std::vector<int> slots;
  std::vector<int> depth_of;

  group_of.reserve(n_nodes);
  while (!stack.empty()) {
    int b = stack.back();
    stack.pop_back();
    if (group_of.count(b)) continue;
    int gi = (int)order.size();
    if (gi >= cap) return 2;
    group_of[b] = gi;
    order.push_back(b);
    expand(node_min, node_max, left, count, b, slots);
    for (int s : slots)
      if (count[s] == 0) stack.push_back(s);
  }

  int m = (int)order.size();
  for (int gi = 0; gi < m; gi++) {
    initGroup(gi);
    expand(node_min, node_max, left, count, order[gi], slots);
    for (size_t k = 0; k < slots.size(); k++) {
      int s = slots[k];
      float* bx = boxes + (size_t)gi * kWidth * 6 + k * 6;
      std::memcpy(bx, node_min + (size_t)s * 3, 3 * sizeof(float));
      std::memcpy(bx + 3, node_max + (size_t)s * 3, 3 * sizeof(float));
      if (count[s] > 0)
        child[(size_t)gi * kWidth + k] = -(((left[s] << 4) | count[s]) + 2);
      else
        child[(size_t)gi * kWidth + k] = group_of[s];
    }
  }

  // Depth by BFS from group 0.
  std::vector<int> depth(m, 0);
  depth[0] = 1;
  std::vector<int> level{0};
  int max_depth = 1;
  while (!level.empty()) {
    std::vector<int> next;
    for (int g : level)
      for (int k = 0; k < kWidth; k++) {
        int c = child[(size_t)g * kWidth + k];
        if (c >= 0 && depth[c] == 0) {
          depth[c] = depth[g] + 1;
          max_depth = std::max(max_depth, depth[c]);
          next.push_back(c);
        }
      }
    level.swap(next);
  }

  *out_m = m;
  *out_depth = max_depth;
  return 0;
}
}

// Host voxelizers (C ABI, loaded with ctypes by
// presight_tpu_torch/native/__init__.py, which builds it with g++ at first
// use into <repo>/build/native/).
//
// The port's copy of the JAX package's presight_tpu/native/voxelize.cpp:
//   C6: the streaming voxel mean-downsample of extraction. It replaces
//       Open3D's voxel_down_sample_and_trace (extract_priors.py:216-245)
//       with a single-pass hash-map accumulation of points, colours and
//       features -- O(N) time and O(V) memory instead of the reference's
//       up-to-300 GB host sort. Per-voxel sums accumulate in f64 in arrival
//       order, so the outputs equal the numpy StreamingVoxelAccumulator's
//       byte for byte.
//   C5: the first-come voxel assignment of stage 3's VoxelizePriorPoints
//       (the reference's numba _points_to_voxel_kernel,
//       occupancy/mmdet3d/datasets/pipelines/prior_points.py:232-298).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <unordered_map>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// C6 replacement: voxel mean-downsample with feature tracing.
//
// points   (n, 3) float64 (or float32 upcast by caller)
// colors   (n, 3) float32, may be null
// features (n, fdim) float32, may be null
// voxel_size, min_bound[3]: Open3D bucketing floor((p - min_bound) / size)
//
// Two-call protocol: first call with out_* null to get num_voxels, then the
// caller allocates and the second call fills. To avoid hashing twice, the
// handle from the first call carries the map.
// ---------------------------------------------------------------------------

struct VoxelAccum {
  std::unordered_map<int64_t, int64_t> key_to_slot;
  std::vector<int64_t> keys;
  std::vector<double> pts;     // (v, 3) sums
  std::vector<double> cols;    // (v, 3) sums
  std::vector<double> feats;   // (v, fdim) sums
  std::vector<int64_t> hits;   // (v,)
  int64_t fdim = 0;
  bool has_colors = false;
};

void* voxel_accum_create(int64_t fdim, int has_colors) {
  auto* acc = new VoxelAccum();
  acc->fdim = fdim;
  acc->has_colors = has_colors != 0;
  return acc;
}

void voxel_accum_destroy(void* handle) { delete static_cast<VoxelAccum*>(handle); }

// Add a batch of points (streaming-friendly: call repeatedly per frame).
void voxel_accum_add(void* handle, const double* points, const float* colors,
                     const float* features, int64_t n, double voxel_size,
                     const double* min_bound) {
  auto* acc = static_cast<VoxelAccum*>(handle);
  const int64_t fdim = acc->fdim;
  for (int64_t i = 0; i < n; ++i) {
    const double* p = points + i * 3;
    int64_t ix = (int64_t)std::floor((p[0] - min_bound[0]) / voxel_size);
    int64_t iy = (int64_t)std::floor((p[1] - min_bound[1]) / voxel_size);
    int64_t iz = (int64_t)std::floor((p[2] - min_bound[2]) / voxel_size);
    int64_t key = (ix << 42) | (iy << 21) | iz;

    auto it = acc->key_to_slot.find(key);
    int64_t slot;
    if (it == acc->key_to_slot.end()) {
      slot = (int64_t)acc->keys.size();
      acc->key_to_slot.emplace(key, slot);
      acc->keys.push_back(key);
      acc->pts.resize(acc->pts.size() + 3, 0.0);
      if (acc->has_colors) acc->cols.resize(acc->cols.size() + 3, 0.0);
      if (fdim > 0) acc->feats.resize(acc->feats.size() + fdim, 0.0);
      acc->hits.push_back(0);
    } else {
      slot = it->second;
    }
    double* ps = acc->pts.data() + slot * 3;
    ps[0] += p[0];
    ps[1] += p[1];
    ps[2] += p[2];
    if (acc->has_colors && colors) {
      double* cs = acc->cols.data() + slot * 3;
      const float* c = colors + i * 3;
      cs[0] += c[0];
      cs[1] += c[1];
      cs[2] += c[2];
    }
    if (fdim > 0 && features) {
      double* fs = acc->feats.data() + slot * fdim;
      const float* f = features + i * fdim;
      for (int64_t d = 0; d < fdim; ++d) fs[d] += f[d];
    }
    acc->hits[slot] += 1;
  }
}

int64_t voxel_accum_size(void* handle) {
  return (int64_t)static_cast<VoxelAccum*>(handle)->keys.size();
}

// Fill caller-allocated output arrays with per-voxel means, sorted by key.
// The means are f64 quotients sum / hits, as numpy computes them, so the
// caller's dtype conversions give the numpy accumulator's bytes.
void voxel_accum_finalize(void* handle, double* out_points, double* out_colors,
                          double* out_features, int64_t* out_hits,
                          int64_t* out_keys) {
  auto* acc = static_cast<VoxelAccum*>(handle);
  const int64_t v = (int64_t)acc->keys.size();
  const int64_t fdim = acc->fdim;

  std::vector<int64_t> order(v);
  for (int64_t i = 0; i < v; ++i) order[i] = i;
  std::stable_sort(order.begin(), order.end(), [&](int64_t a, int64_t b) {
    return acc->keys[a] < acc->keys[b];
  });

  for (int64_t o = 0; o < v; ++o) {
    const int64_t slot = order[o];
    const double hits = (double)acc->hits[slot];
    for (int d = 0; d < 3; ++d) out_points[o * 3 + d] = acc->pts[slot * 3 + d] / hits;
    if (out_colors && acc->has_colors)
      for (int d = 0; d < 3; ++d) out_colors[o * 3 + d] = acc->cols[slot * 3 + d] / hits;
    if (out_features && fdim > 0)
      for (int64_t d = 0; d < fdim; ++d)
        out_features[o * fdim + d] = acc->feats[slot * fdim + d] / hits;
    out_hits[o] = acc->hits[slot];
    if (out_keys) out_keys[o] = acc->keys[slot];
  }
}

// ---------------------------------------------------------------------------
// C5 replacement: first-come voxel assignment with caps
// (prior_points.py:232-298 semantics):
//   * voxel coord = floor((p - coors_range_min) / voxel_size), per axis, in f32
//   * points outside the range are skipped
//   * first-come: voxels appear in point order, capped at max_voxels
//   * each voxel holds at most max_points points (extras dropped)
// Outputs: voxels (max_voxels, max_points, ndim) pre-zeroed by caller,
// coors (max_voxels, 3) in (z, y, x) order as downstream expects,
// num_points_per_voxel (max_voxels,) pre-zeroed. Returns the voxel count.
// ---------------------------------------------------------------------------

int64_t points_to_voxel_first_come(
    const float* points, int64_t n, int64_t ndim, const float* voxel_size,
    const float* coors_range /* (6,) xmin ymin zmin xmax ymax zmax */,
    int64_t max_points, int64_t max_voxels, float* voxels /* zeroed */,
    int32_t* coors, int32_t* num_points_per_voxel) {
  std::unordered_map<int64_t, int64_t> coor_to_voxel;
  int64_t voxel_num = 0;
  int32_t grid[3];
  for (int d = 0; d < 3; ++d) {
    grid[d] = (int32_t)std::round((coors_range[3 + d] - coors_range[d]) /
                                  voxel_size[d]);
  }
  for (int64_t i = 0; i < n; ++i) {
    const float* p = points + i * ndim;
    int32_t c[3];
    bool ok = true;
    for (int d = 0; d < 3; ++d) {
      int32_t cd = (int32_t)std::floor((p[d] - coors_range[d]) / voxel_size[d]);
      if (cd < 0 || cd >= grid[d]) {
        ok = false;
        break;
      }
      c[d] = cd;
    }
    if (!ok) continue;
    int64_t key = ((int64_t)c[2] << 42) | ((int64_t)c[1] << 21) | (int64_t)c[0];
    auto it = coor_to_voxel.find(key);
    int64_t vid;
    if (it == coor_to_voxel.end()) {
      if (voxel_num >= max_voxels) continue;
      vid = voxel_num++;
      coor_to_voxel.emplace(key, vid);
      coors[vid * 3 + 0] = c[2];
      coors[vid * 3 + 1] = c[1];
      coors[vid * 3 + 2] = c[0];
    } else {
      vid = it->second;
    }
    int32_t& cnt = num_points_per_voxel[vid];
    if (cnt < max_points) {
      std::memcpy(voxels + (vid * max_points + cnt) * ndim, p,
                  sizeof(float) * ndim);
      cnt += 1;
    }
  }
  return voxel_num;
}

}  // extern "C"

// Native host-side scan preprocessing for the PyTorch port: range filter +
// concentric-zone ground segmentation with per-point normal cosines.
//
// The port's own copy of the JAX package's nerfloam_tpu/native/ground_seg.cpp,
// with the same C ABI and the same arithmetic: built with the same g++ flags
// it gives bit for bit what the JAX loader feeds its tracker. It runs on the
// host CPU once per scan, in the prefetching loader's thread
// (nerfloam_tpu_torch/data/prefetch.py); the card does the field work.
// Its algorithm is that of nerfloam_tpu_torch/data/ground.py, the numpy twin:
// polar cells, lowest-quantile seeding, iterated PCA plane fits, uprightness
// test, cosine |n . dir| for ground inliers. The twin rounds otherwise (an
// interpolated seed quantile, rings by geomspace, a float32 plane fit), so
// the two agree only to a tolerance.
//
// Exposed via a plain C ABI for ctypes (nerfloam_tpu_torch/native/__init__.py).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct Vec3 {
  double x, y, z;
};

// 3x3 symmetric eigen-decomposition via Jacobi rotations (enough for PCA).
void eigh3(double a[3][3], double w[3], double v[3][3]) {
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) v[i][j] = (i == j) ? 1.0 : 0.0;
  for (int sweep = 0; sweep < 24; ++sweep) {
    double off = std::abs(a[0][1]) + std::abs(a[0][2]) + std::abs(a[1][2]);
    if (off < 1e-14) break;
    for (int p = 0; p < 2; ++p) {
      for (int q = p + 1; q < 3; ++q) {
        if (std::abs(a[p][q]) < 1e-18) continue;
        double theta = (a[q][q] - a[p][p]) / (2.0 * a[p][q]);
        double t = (theta >= 0 ? 1.0 : -1.0) /
                   (std::abs(theta) + std::sqrt(theta * theta + 1.0));
        double c = 1.0 / std::sqrt(t * t + 1.0), s = t * c;
        for (int k = 0; k < 3; ++k) {
          double akp = a[k][p], akq = a[k][q];
          a[k][p] = c * akp - s * akq;
          a[k][q] = s * akp + c * akq;
        }
        for (int k = 0; k < 3; ++k) {
          double apk = a[p][k], aqk = a[q][k];
          a[p][k] = c * apk - s * aqk;
          a[q][k] = s * apk + c * aqk;
        }
        for (int k = 0; k < 3; ++k) {
          double vkp = v[k][p], vkq = v[k][q];
          v[k][p] = c * vkp - s * vkq;
          v[k][q] = s * vkp + c * vkq;
        }
      }
    }
  }
  for (int i = 0; i < 3; ++i) w[i] = a[i][i];
  // sort ascending
  int order[3] = {0, 1, 2};
  std::sort(order, order + 3, [&](int i, int j) { return w[i] < w[j]; });
  double w2[3];
  double v2[3][3];
  for (int i = 0; i < 3; ++i) {
    w2[i] = w[order[i]];
    for (int k = 0; k < 3; ++k) v2[k][i] = v[k][order[i]];
  }
  std::memcpy(w, w2, sizeof(w2));
  std::memcpy(v, v2, sizeof(v2));
}

bool plane_fit(const float* pts, const int* idx, const uint8_t* sel, int n,
               double normal[3], double* d_out) {
  double mean[3] = {0, 0, 0};
  int cnt = 0;
  for (int i = 0; i < n; ++i) {
    if (!sel[i]) continue;
    const float* p = pts + 3 * idx[i];
    mean[0] += p[0];
    mean[1] += p[1];
    mean[2] += p[2];
    ++cnt;
  }
  if (cnt < 3) return false;
  for (double& m : mean) m /= cnt;
  double cov[3][3] = {{0, 0, 0}, {0, 0, 0}, {0, 0, 0}};
  for (int i = 0; i < n; ++i) {
    if (!sel[i]) continue;
    const float* p = pts + 3 * idx[i];
    double q[3] = {p[0] - mean[0], p[1] - mean[1], p[2] - mean[2]};
    for (int r = 0; r < 3; ++r)
      for (int c = 0; c < 3; ++c) cov[r][c] += q[r] * q[c];
  }
  for (int r = 0; r < 3; ++r)
    for (int c = 0; c < 3; ++c) cov[r][c] /= cnt;
  double w[3], v[3][3];
  eigh3(cov, w, v);
  normal[0] = v[0][0];
  normal[1] = v[1][0];
  normal[2] = v[2][0];
  if (normal[2] < 0) {
    normal[0] = -normal[0];
    normal[1] = -normal[1];
    normal[2] = -normal[2];
  }
  *d_out = -(normal[0] * mean[0] + normal[1] * mean[1] + normal[2] * mean[2]);
  return true;
}

}  // namespace

extern "C" {

// points: (n, 3) float32. Outputs: ground_mask (n,) uint8, cos (n,) float32.
// Returns number of ground points.
int segment_ground(const float* points, int n, int n_rings, int n_sectors,
                   float min_range, float max_range, float seed_quantile,
                   float dist_th, float uprightness_th, int n_iters,
                   float sensor_height, uint8_t* ground_mask, float* cos_out) {
  if (n <= 0) return 0;
  std::memset(ground_mask, 0, n);
  for (int i = 0; i < n; ++i) cos_out[i] = 1.0f;

  const int n_cells = n_rings * n_sectors;
  std::vector<std::vector<int>> cells(n_cells);
  const double log_min = std::log(min_range), log_max = std::log(max_range);
  for (int i = 0; i < n; ++i) {
    const float* p = points + 3 * i;
    double r = std::sqrt((double)p[0] * p[0] + (double)p[1] * p[1]);
    double lr = std::log(std::max((double)min_range, std::min((double)max_range, r)));
    int ring = std::min(n_rings - 1,
                        std::max(0, (int)((lr - log_min) / (log_max - log_min) *
                                          n_rings)));
    double az = std::atan2((double)p[1], (double)p[0]);  // [-pi, pi]
    int sec = std::min(n_sectors - 1,
                       std::max(0, (int)((az + M_PI) / (2 * M_PI) * n_sectors)));
    cells[ring * n_sectors + sec].push_back(i);
  }

  std::vector<uint8_t> sel;
  std::vector<float> zs;
  int total_ground = 0;
  for (auto& cell : cells) {
    int m = (int)cell.size();
    if (m < 8) continue;
    zs.resize(m);
    for (int i = 0; i < m; ++i) zs[i] = points[3 * cell[i] + 2];
    std::vector<float> zsort(zs);
    std::nth_element(zsort.begin(), zsort.begin() + (int)(seed_quantile * m),
                     zsort.end());
    float z_seed = zsort[(int)(seed_quantile * m)];
    sel.assign(m, 0);
    int cnt = 0;
    for (int i = 0; i < m; ++i) {
      if (zs[i] <= z_seed + 0.15f && zs[i] > -sensor_height - 1.5f) {
        sel[i] = 1;
        ++cnt;
      }
    }
    if (cnt < 3) continue;
    double normal[3], d;
    bool ok = false;
    for (int it = 0; it < n_iters; ++it) {
      if (!plane_fit(points, cell.data(), sel.data(), m, normal, &d)) {
        ok = false;
        break;
      }
      ok = true;
      int inl = 0;
      for (int i = 0; i < m; ++i) {
        const float* p = points + 3 * cell[i];
        double dist = std::abs(normal[0] * p[0] + normal[1] * p[1] +
                               normal[2] * p[2] + d);
        sel[i] = dist < dist_th;
        inl += sel[i];
      }
      if (inl < 3) {
        ok = false;
        break;
      }
    }
    if (!ok || normal[2] < uprightness_th) continue;
    for (int i = 0; i < m; ++i) {
      if (!sel[i]) continue;
      int gi = cell[i];
      const float* p = points + 3 * gi;
      double nrm = std::sqrt((double)p[0] * p[0] + (double)p[1] * p[1] +
                             (double)p[2] * p[2]) +
                   1e-12;
      double c = std::abs((normal[0] * p[0] + normal[1] * p[1] +
                           normal[2] * p[2]) /
                          nrm);
      ground_mask[gi] = 1;
      cos_out[gi] = (float)c;
      ++total_ground;
    }
  }
  return total_ground;
}

// KITTI-style .bin range/z filter: input (n, 4) float32 xyzr, outputs packed
// (x,y,z) float32 for points passing z > z_min and min_d < |p| < max_d.
// Returns the surviving count (<= n). out must hold 3*n floats.
int filter_scan(const float* xyzr, int n, int stride, float z_min, float min_d,
                float max_d, float* out) {
  int k = 0;
  for (int i = 0; i < n; ++i) {
    const float* p = xyzr + stride * i;
    if (p[2] <= z_min) continue;
    double d = std::sqrt((double)p[0] * p[0] + (double)p[1] * p[1] +
                         (double)p[2] * p[2]);
    if (max_d > 0 && d >= max_d) continue;
    if (min_d > 0 && d <= min_d) continue;
    out[3 * k] = p[0];
    out[3 * k + 1] = p[1];
    out[3 * k + 2] = p[2];
    ++k;
  }
  return k;
}

}  // extern "C"

// Native WOMD motion-metrics engine (minADE / minFDE / miss rate / overlap /
// mAP) — the C++ counterpart of trafficbots_tpu/eval/motion_metrics.py,
// replacing the reference's Waymo TF C++ op dependency
// (upstream src/models/metrics/womd.py:176-227). Loaded via ctypes
// (eval/native_metrics.py); the numpy implementation is the test oracle.
//
// Build: g++ -O3 -march=native -shared -fPIC motion_metrics.cc -o libmotion_metrics.so

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr int kNumBuckets = 8;
constexpr double kPi = 3.14159265358979323846;

struct Config {
  int history;
  int future;
  float speed_lower, speed_upper, scale_lower, scale_upper;
  int step_ratio;  // track_hz / pred_hz
};

struct PredRecord {
  float score;
  bool is_match;
  int64_t group_id;
};

inline int PredToTrackStep(const Config& c, int i) {
  return c.history + c.step_ratio * (i + 1);
}

// 8-way trajectory-shape bucket (mirrors motion_metrics_utils.cc and the
// python classify_trajectory).
int ClassifyTrajectory(const uint8_t* valid, const float* x, const float* y,
                       const float* yaw, const float* spd, int n) {
  int i0 = -1, i1 = -1;
  for (int i = 0; i < n; ++i) {
    if (valid[i]) {
      if (i0 < 0) i0 = i;
      i1 = i;
    }
  }
  if (i0 < 0 || i1 == i0) return -1;
  double dx_w = x[i1] - x[i0], dy_w = y[i1] - y[i0];
  double disp = std::hypot(dx_w, dy_w);
  double c = std::cos(-yaw[i0]), s = std::sin(-yaw[i0]);
  double dx = dx_w * c - dy_w * s;
  double dy = dx_w * s + dy_w * c;
  double hd = yaw[i1] - yaw[i0];
  double max_speed = std::max(spd[i0], spd[i1]);
  if (max_speed < 2.0 && disp < 5.0) return 0;
  if (std::fabs(hd) < kPi / 6.0) {
    if (std::fabs(dy) < 5.0) return 1;
    return dy > 0 ? 2 : 3;
  }
  if (hd < -kPi / 6.0 && dy < 0) return dx < -5.0 ? 6 : 7;
  return dx < -5.0 ? 4 : 5;
}

void BoxCorners(double cx, double cy, double heading, double length,
                double width, double out[4][2]) {
  double c = std::cos(heading), s = std::sin(heading);
  double dxl = c * length / 2, dyl = s * length / 2;
  double dxw = -s * width / 2, dyw = c * width / 2;
  out[0][0] = cx + dxl + dxw; out[0][1] = cy + dyl + dyw;
  out[1][0] = cx + dxl - dxw; out[1][1] = cy + dyl - dyw;
  out[2][0] = cx - dxl - dxw; out[2][1] = cy - dyl - dyw;
  out[3][0] = cx - dxl + dxw; out[3][1] = cy - dyl + dyw;
}

bool BoxesOverlap(const double b1[4][2], const double b2[4][2]) {
  const double(*boxes[2])[2] = {b1, b2};
  for (int bi = 0; bi < 2; ++bi) {
    for (int i = 0; i < 4; ++i) {
      const double* p0 = boxes[bi][i];
      const double* p1 = boxes[bi][(i + 1) % 4];
      double ax = -(p1[1] - p0[1]), ay = p1[0] - p0[0];
      double min1 = 1e30, max1 = -1e30, min2 = 1e30, max2 = -1e30;
      for (int j = 0; j < 4; ++j) {
        double d1 = b1[j][0] * ax + b1[j][1] * ay;
        double d2 = b2[j][0] * ax + b2[j][1] * ay;
        min1 = std::min(min1, d1); max1 = std::max(max1, d1);
        min2 = std::min(min2, d2); max2 = std::max(max2, d2);
      }
      if (max1 < min2 || max2 < min1) return false;
    }
  }
  return true;
}

// soft=true: extra non-missing guesses for an already-matched group are
// skipped instead of counted as false positives (Soft mAP).
double ApFromRecords(std::vector<PredRecord>& recs, int64_t n_objects,
                     bool soft = false) {
  if (n_objects == 0) return 0.0;
  std::stable_sort(recs.begin(), recs.end(),
                   [](const PredRecord& a, const PredRecord& b) { return a.score > b.score; });
  std::vector<char> seen;
  std::vector<double> tp, fp;
  // group ids may be sparse; map via sorted unique
  std::vector<int64_t> gids;
  gids.reserve(recs.size());
  for (auto& r : recs) gids.push_back(r.group_id);
  std::sort(gids.begin(), gids.end());
  gids.erase(std::unique(gids.begin(), gids.end()), gids.end());
  seen.assign(gids.size(), 0);
  auto gidx = [&](int64_t g) {
    return std::lower_bound(gids.begin(), gids.end(), g) - gids.begin();
  };
  for (auto& r : recs) {
    size_t gi = gidx(r.group_id);
    if (r.is_match && !seen[gi]) {
      seen[gi] = 1;
      tp.push_back(1.0);
      fp.push_back(0.0);
    } else if (r.is_match && soft) {
      continue;
    } else {
      tp.push_back(0.0);
      fp.push_back(1.0);
    }
  }
  if (tp.empty()) return 0.0;
  double tpc = 0, fpc = 0, ap = 0;
  std::vector<double> recall(tp.size()), precision(tp.size());
  for (size_t i = 0; i < tp.size(); ++i) {
    tpc += tp[i];
    fpc += fp[i];
    recall[i] = tpc / (double)n_objects;
    precision[i] = tpc / std::max(tpc + fpc, 1e-9);
  }
  // 101-point interpolation (matches the python oracle)
  for (int ri = 0; ri <= 100; ++ri) {
    double r_level = ri / 100.0;
    double best = 0.0;
    for (size_t i = 0; i < tp.size(); ++i)
      if (recall[i] >= r_level) best = std::max(best, precision[i]);
    ap += best;
  }
  return ap / 101.0;
}

struct BreakdownAcc {
  double ade_sum = 0, fde_sum = 0, miss_sum = 0, overlap_sum = 0;
  int64_t count = 0;
  std::vector<PredRecord> records[kNumBuckets];
  int64_t bucket_counts[kNumBuckets] = {0};
};

}  // namespace

extern "C" {

// out layout: [3 object types][n_cfg steps][6 metrics:
//   min_ade, min_fde, miss_rate, overlap_rate, mAP, soft mAP]
int motion_metrics_compute(
    const float* pred_traj, const float* pred_score, const float* gt_traj,
    const uint8_t* gt_valid, const int64_t* pgi, const uint8_t* pgi_mask,
    const float* obj_type, int64_t B, int64_t M, int64_t K, int64_t N,
    int64_t TP, int64_t A, int64_t TG, int history, int step_ratio,
    float speed_lower, float speed_upper, float scale_lower, float scale_upper,
    const int* meas_steps, const float* lat_thresh, const float* lon_thresh,
    int n_cfg, float* out) {
  Config cfg{history, 0, speed_lower, speed_upper, scale_lower, scale_upper, step_ratio};

  std::vector<BreakdownAcc> acc(3 * n_cfg);
  int64_t group_counter = 0;

  // strides
  const int64_t pt_m = K * N * TP * 2, pt_k = N * TP * 2, pt_n = TP * 2;
  const int64_t gt_a = TG * 7;

  std::vector<float> gx(TG), gy(TG), gyaw(TG), gspd(TG);

  for (int64_t b = 0; b < B; ++b) {
    const float* PT = pred_traj + b * M * pt_m;
    const float* PS = pred_score + b * M * K;
    const float* GT = gt_traj + b * A * gt_a;
    const uint8_t* GV = gt_valid + b * A * TG;
    const int64_t* PGI = pgi + b * M * N;
    const uint8_t* PGM = pgi_mask + b * M * N;
    const float* OT = obj_type + b * A;

    for (int64_t m = 0; m < M; ++m) {
      std::vector<int64_t> objs, gts;
      for (int64_t n = 0; n < N; ++n)
        if (PGM[m * N + n]) {
          objs.push_back(n);
          gts.push_back(PGI[m * N + n]);
        }
      if (objs.empty()) continue;
      bool cur_ok = true;
      for (auto g : gts)
        if (!GV[g * TG + history]) cur_ok = false;
      if (!cur_ok) continue;

      // speed scales
      std::vector<double> scales(gts.size());
      for (size_t gi = 0; gi < gts.size(); ++gi) {
        const float* row = GT + gts[gi] * gt_a + history * 7;
        double v = std::hypot(row[5], row[6]);
        double frac = (v - speed_lower) / (speed_upper - speed_lower);
        frac = std::min(1.0, std::max(0.0, frac));
        scales[gi] = scale_lower + (scale_upper - scale_lower) * frac;
      }

      int64_t g0 = gts[0];
      int fut = TG - history;
      for (int t = 0; t < fut; ++t) {
        const float* row = GT + g0 * gt_a + (history + t) * 7;
        gx[t] = row[0];
        gy[t] = row[1];
        gyaw[t] = row[4];
        gspd[t] = std::hypot(row[5], row[6]);
      }
      // pack x/y into interleaved-friendly arrays for classify
      std::vector<float> cls_x(fut), cls_y(fut);
      for (int t = 0; t < fut; ++t) { cls_x[t] = gx[t]; cls_y[t] = gy[t]; }
      int bucket = ClassifyTrajectory(GV + g0 * TG + history, cls_x.data(),
                                      cls_y.data(), gyaw.data(), gspd.data(), fut);
      int ot = (int)OT[g0];
      if (ot < 1 || ot > 3 || bucket < 0) continue;

      for (int ci = 0; ci < n_cfg; ++ci) {
        int T = meas_steps[ci];
        int track_T = PredToTrackStep(cfg, T - 1);
        if (track_T >= TG) continue;
        bool step_ok = true;
        for (auto g : gts)
          if (!GV[g * TG + track_T]) step_ok = false;
        if (!step_ok) continue;

        BreakdownAcc& a = acc[(ot - 1) * n_cfg + ci];
        double min_ade = 1e30, min_fde = 1e30;
        bool all_miss = true;
        std::vector<char> k_missed(K, 0);
        for (int64_t k = 0; k < K; ++k) {
          double ade_acc = 0; int ade_n = 0;
          double fde_acc = 0; int fde_n = 0;
          bool k_miss = false;
          for (size_t oi = 0; oi < objs.size(); ++oi) {
            int64_t n = objs[oi], g = gts[oi];
            const float* pk = PT + m * pt_m + k * pt_k + n * pt_n;
            double errs = 0; int errn = 0;
            for (int t2 = 0; t2 < T; ++t2) {
              int tt = PredToTrackStep(cfg, t2);
              if (!GV[g * TG + tt]) continue;
              const float* grow = GT + g * gt_a + tt * 7;
              double dx = pk[t2 * 2] - grow[0], dy = pk[t2 * 2 + 1] - grow[1];
              errs += std::hypot(dx, dy);
              errn++;
            }
            if (errn) { ade_acc += errs / errn; ade_n++; }
            const float* grow = GT + g * gt_a + track_T * 7;
            double dx = pk[(T - 1) * 2] - grow[0], dy = pk[(T - 1) * 2 + 1] - grow[1];
            fde_acc += std::hypot(dx, dy);
            fde_n++;
            double h = grow[4];
            double c = std::cos(-h), s = std::sin(-h);
            double lon = dx * c - dy * s, lat = dx * s + dy * c;
            if (std::fabs(lat) > lat_thresh[ci] * scales[oi] ||
                std::fabs(lon) > lon_thresh[ci] * scales[oi])
              k_miss = true;
          }
          double ade = ade_n ? ade_acc / ade_n : 0.0;
          double fde = fde_n ? fde_acc / fde_n : 0.0;
          min_ade = std::min(min_ade, ade);
          min_fde = std::min(min_fde, fde);
          k_missed[k] = k_miss;
          if (!k_miss) all_miss = false;
        }

        // overlap: most-likely guess vs other objects' GT boxes
        int64_t k_star = 0;
        for (int64_t k = 1; k < K; ++k)
          if (PS[m * K + k] > PS[m * K + k_star]) k_star = k;
        double overlap = 0.0;
        for (size_t oi = 0; oi < objs.size() && overlap == 0.0; ++oi) {
          int64_t n = objs[oi], g = gts[oi];
          const float* grow_cur = GT + g * gt_a + history * 7;
          double length = grow_cur[2], width = grow_cur[3];
          double px_prev = grow_cur[0], py_prev = grow_cur[1];
          const float* pk = PT + m * pt_m + k_star * pt_k + n * pt_n;
          for (int t2 = 0; t2 < T && overlap == 0.0; ++t2) {
            int tt = PredToTrackStep(cfg, t2);
            if (tt >= TG) break;
            double px = pk[t2 * 2], py = pk[t2 * 2 + 1];
            double dx = px - px_prev, dy = py - py_prev;
            double heading = (std::hypot(dx, dy) > 1e-4)
                                 ? std::atan2(dy, dx)
                                 : GT[g * gt_a + tt * 7 + 4];
            px_prev = px; py_prev = py;
            double bp[4][2];
            BoxCorners(px, py, heading, length, width, bp);
            for (int64_t other = 0; other < A; ++other) {
              if (other == g || !GV[other * TG + tt]) continue;
              const float* og = GT + other * gt_a + tt * 7;
              if (std::max(std::fabs(og[0] - px), std::fabs(og[1] - py)) >
                  length + og[2])
                continue;
              double bo[4][2];
              BoxCorners(og[0], og[1], og[4], og[2], og[3], bo);
              if (BoxesOverlap(bp, bo)) { overlap = 1.0; break; }
            }
          }
        }

        a.ade_sum += min_ade;
        a.fde_sum += min_fde;
        a.miss_sum += all_miss ? 1.0 : 0.0;
        a.overlap_sum += overlap;
        a.count++;
        a.bucket_counts[bucket]++;
        for (int64_t k = 0; k < K; ++k)
          a.records[bucket].push_back(
              {PS[m * K + k], !k_missed[k], group_counter});
        group_counter++;
      }
    }
  }

  for (int ot = 0; ot < 3; ++ot) {
    for (int ci = 0; ci < n_cfg; ++ci) {
      BreakdownAcc& a = acc[ot * n_cfg + ci];
      float* o = out + (ot * n_cfg + ci) * 6;
      double cnt = std::max<int64_t>(a.count, 1);
      o[0] = a.count ? (float)(a.ade_sum / cnt) : 0.f;
      o[1] = a.count ? (float)(a.fde_sum / cnt) : 0.f;
      o[2] = a.count ? (float)(a.miss_sum / cnt) : 0.f;
      o[3] = a.count ? (float)(a.overlap_sum / cnt) : 0.f;
      double map_sum = 0, smap_sum = 0;
      int map_n = 0;
      for (int bkt = 0; bkt < kNumBuckets; ++bkt) {
        if (a.bucket_counts[bkt] == 0) continue;
        map_sum += ApFromRecords(a.records[bkt], a.bucket_counts[bkt]);
        smap_sum += ApFromRecords(a.records[bkt], a.bucket_counts[bkt], true);
        map_n++;
      }
      o[4] = map_n ? (float)(map_sum / map_n) : 0.f;
      o[5] = map_n ? (float)(smap_sum / map_n) : 0.f;
    }
  }
  return 0;
}

}  // extern "C"

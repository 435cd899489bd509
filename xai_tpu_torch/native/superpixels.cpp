// Native host helpers for the XAI framework: superpixel segmentation and
// curve projection.  Replaces the reference's skimage/cvxopt dependencies
// (SURVEY.md §2.9: slic for MDA, felzenszwalb for XRAI/MAC, quickshift for
// LIME, cvxopt QP for the MAS curve projection).
//
// Implemented from the original papers:
//  - SLIC:        Achanta et al., "SLIC Superpixels", PAMI 2012
//  - Felzenszwalb: Felzenszwalb & Huttenlocher, IJCV 2004
//  - Quickshift:  Vedaldi & Soatto, ECCV 2008
//  - Curve projection: Dykstra's alternating projections onto the
//    intersection of {box [0,1]} x {second-difference halfspaces} x
//    {fixed endpoints} — the cvxopt QP in MASTestFunctions.py:311-350.
//
// C ABI (ctypes).  All images are float32 row-major HxWxC.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <chrono>
#include <cstdio>
#include <cstdlib>
#include <numeric>
#include <thread>
#include <vector>

// run fn(y) for y in [0, H) across hardware threads (quickshift's density
// and parent searches are pixel-independent; single-threaded they were
// ~0.4 s/image at 224^2 — the LIME bottleneck)
template <typename F>
static void parallel_rows(int H, F fn) {
  unsigned n = std::thread::hardware_concurrency();
  if (n <= 1 || H < 32) {
    for (int y = 0; y < H; y++) fn(y);
    return;
  }
  n = std::min<unsigned>(n, 16);
  std::vector<std::thread> ts;
  for (unsigned t = 0; t < n; t++)
    ts.emplace_back([=]() {
      for (int y = (int)t; y < H; y += (int)n) fn(y);
    });
  for (auto& th : ts) th.join();
}



// vectorizable expf: 2^(x*log2e) via exponent-bit assembly + 5th-order
// polynomial on the fraction (~2e-7 relative).  libm expf is a scalar call
// the compiler can't vectorize; this form auto-vectorizes 16-wide under
// -march=native AVX-512, and the quickshift density estimate (the LIME
// bottleneck: ~31M exps/image single-core) is pure exp throughput.
static inline float fast_expf(float x) {
  x = x < -80.0f ? -80.0f : x;        // exp(-80) ~ 1.8e-35: effectively 0
  float t = x * 1.44269504089f;
  float fi = floorf(t);
  float f = t - fi;
  float p = 1.0f + f * (0.693147180f + f * (0.240226507f +
            f * (0.0555041087f + f * (0.00961812910f +
            f * 0.00133335581f))));
  int32_t i = ((int32_t)fi + 127) << 23;
  float scale = __builtin_bit_cast(float, i);
  return scale * p;
}

extern "C" {

// ---------------------------------------------------------------------------
// RGB -> CIELAB (D65), matching the standard conversion skimage uses.
// ---------------------------------------------------------------------------
static inline float f_lab(float t) {
  return t > 0.008856f ? cbrtf(t) : (7.787f * t + 16.0f / 116.0f);
}

static void rgb2lab(const float* rgb, float* lab, int n) {
  for (int i = 0; i < n; i++) {
    float r = rgb[3 * i], g = rgb[3 * i + 1], b = rgb[3 * i + 2];
    auto inv = [](float c) {
      return c > 0.04045f ? powf((c + 0.055f) / 1.055f, 2.4f) : c / 12.92f;
    };
    r = inv(r); g = inv(g); b = inv(b);
    float X = (0.412453f * r + 0.357580f * g + 0.180423f * b) / 0.95047f;
    float Y = (0.212671f * r + 0.715160f * g + 0.072169f * b);
    float Z = (0.019334f * r + 0.119193f * g + 0.950227f * b) / 1.08883f;
    float fx = f_lab(X), fy = f_lab(Y), fz = f_lab(Z);
    lab[3 * i] = 116.0f * fy - 16.0f;
    lab[3 * i + 1] = 500.0f * (fx - fy);
    lab[3 * i + 2] = 200.0f * (fy - fz);
  }
}

// ---------------------------------------------------------------------------
// SLIC
// ---------------------------------------------------------------------------
// image: HxWx3 float32 RGB in [0,1]; labels out: HxW int32 in [0, K)
// Matches skimage defaults: LAB space, 10 iterations, connectivity
// enforcement with min size HW/K * 0.5.
int slic(const float* image, int H, int W, int n_segments, float compactness,
         int max_iter, int32_t* labels) {
  int N = H * W;
  std::vector<float> lab(3 * N);
  rgb2lab(image, lab.data(), N);

  // initial cluster centers on a regular grid
  float step = sqrtf((float)N / n_segments);
  std::vector<float> cx, cy, cl, ca, cb;
  for (float y = step / 2; y < H; y += step)
    for (float x = step / 2; x < W; x += step) {
      int yi = (int)y, xi = (int)x;
      int idx = yi * W + xi;
      cy.push_back(y); cx.push_back(x);
      cl.push_back(lab[3 * idx]); ca.push_back(lab[3 * idx + 1]);
      cb.push_back(lab[3 * idx + 2]);
    }
  int K = (int)cx.size();
  if (K == 0) return 0;

  std::vector<float> dist(N);
  std::vector<int32_t> lbl(N, -1);
  float invwt = (compactness / step) * (compactness / step);

  for (int it = 0; it < max_iter; it++) {
    std::fill(dist.begin(), dist.end(), 1e30f);
    for (int k = 0; k < K; k++) {
      int y0 = std::max(0, (int)(cy[k] - step)),
          y1 = std::min(H, (int)(cy[k] + step) + 1);
      int x0 = std::max(0, (int)(cx[k] - step)),
          x1 = std::min(W, (int)(cx[k] + step) + 1);
      for (int y = y0; y < y1; y++)
        for (int x = x0; x < x1; x++) {
          int idx = y * W + x;
          float dl = lab[3 * idx] - cl[k];
          float da = lab[3 * idx + 1] - ca[k];
          float db = lab[3 * idx + 2] - cb[k];
          float dy = y - cy[k], dx = x - cx[k];
          float d = dl * dl + da * da + db * db +
                    (dy * dy + dx * dx) * invwt;
          if (d < dist[idx]) { dist[idx] = d; lbl[idx] = k; }
        }
    }
    // update centers
    std::vector<double> sy(K, 0), sx(K, 0), sl(K, 0), sa(K, 0), sb(K, 0);
    std::vector<int> cnt(K, 0);
    for (int i = 0; i < N; i++) {
      int k = lbl[i];
      if (k < 0) continue;
      sy[k] += i / W; sx[k] += i % W;
      sl[k] += lab[3 * i]; sa[k] += lab[3 * i + 1]; sb[k] += lab[3 * i + 2];
      cnt[k]++;
    }
    for (int k = 0; k < K; k++)
      if (cnt[k]) {
        cy[k] = sy[k] / cnt[k]; cx[k] = sx[k] / cnt[k];
        cl[k] = sl[k] / cnt[k]; ca[k] = sa[k] / cnt[k];
        cb[k] = sb[k] / cnt[k];
      }
  }

  // enforce connectivity: relabel connected components; absorb small ones
  std::vector<int32_t> out(N, -1);
  std::vector<int> stack;
  int next_label = 0;
  int min_size = std::max(1, (int)(N / (float)K * 0.5f));
  std::vector<int> component;
  for (int i = 0; i < N; i++) {
    if (out[i] >= 0) continue;
    component.clear();
    stack.push_back(i);
    out[i] = next_label;
    component.push_back(i);
    // neighbor label adjacent to this component (for absorption)
    int adj = -1;
    while (!stack.empty()) {
      int p = stack.back(); stack.pop_back();
      int py = p / W, px = p % W;
      const int dy[4] = {-1, 1, 0, 0}, dx[4] = {0, 0, -1, 1};
      for (int d = 0; d < 4; d++) {
        int ny = py + dy[d], nx = px + dx[d];
        if (ny < 0 || ny >= H || nx < 0 || nx >= W) continue;
        int q = ny * W + nx;
        if (out[q] < 0 && lbl[q] == lbl[i]) {
          out[q] = next_label;
          component.push_back(q);
          stack.push_back(q);
        } else if (out[q] >= 0 && out[q] != next_label) {
          adj = out[q];
        }
      }
    }
    if ((int)component.size() < min_size && adj >= 0) {
      for (int p : component) out[p] = adj;
    } else {
      next_label++;
    }
  }
  std::memcpy(labels, out.data(), N * sizeof(int32_t));
  return next_label;
}

// ---------------------------------------------------------------------------
// Felzenszwalb-Huttenlocher graph segmentation
// ---------------------------------------------------------------------------
struct DSU {
  std::vector<int> parent, rank_, size;
  DSU(int n) : parent(n), rank_(n, 0), size(n, 1) {
    std::iota(parent.begin(), parent.end(), 0);
  }
  int find(int x) {
    while (parent[x] != x) { parent[x] = parent[parent[x]]; x = parent[x]; }
    return x;
  }
  int join(int a, int b) {
    a = find(a); b = find(b);
    if (a == b) return a;
    if (rank_[a] < rank_[b]) std::swap(a, b);
    parent[b] = a; size[a] += size[b];
    if (rank_[a] == rank_[b]) rank_[a]++;
    return a;
  }
};

static void gaussian_blur_host(const float* src, float* dst, int H, int W,
                               int C, float sigma) {
  if (sigma <= 0) { std::memcpy(dst, src, (size_t)H * W * C * 4); return; }
  int r = (int)ceilf(4.0f * sigma);
  std::vector<float> k(2 * r + 1);
  float s = 0;
  for (int i = -r; i <= r; i++) {
    k[i + r] = expf(-0.5f * i * i / (sigma * sigma));
    s += k[i + r];
  }
  for (auto& v : k) v /= s;
  std::vector<float> tmp((size_t)H * W * C);
  // horizontal
  for (int y = 0; y < H; y++)
    for (int x = 0; x < W; x++)
      for (int c = 0; c < C; c++) {
        float acc = 0;
        for (int i = -r; i <= r; i++) {
          int xx = std::min(W - 1, std::max(0, x + i));
          acc += k[i + r] * src[(y * W + xx) * C + c];
        }
        tmp[(y * W + x) * C + c] = acc;
      }
  // vertical
  for (int y = 0; y < H; y++)
    for (int x = 0; x < W; x++)
      for (int c = 0; c < C; c++) {
        float acc = 0;
        for (int i = -r; i <= r; i++) {
          int yy = std::min(H - 1, std::max(0, y + i));
          acc += k[i + r] * tmp[(yy * W + x) * C + c];
        }
        dst[(y * W + x) * C + c] = acc;
      }
}

// image HxWxC float32; labels out HxW int32; returns #segments
int felzenszwalb(const float* image, int H, int W, int C, float scale,
                 float sigma, int min_size, int32_t* labels) {
  int N = H * W;
  std::vector<float> img((size_t)N * C);
  gaussian_blur_host(image, img.data(), H, W, C, sigma);

  struct Edge { float w; int a, b; };
  std::vector<Edge> edges;
  edges.reserve((size_t)N * 4);
  auto diff = [&](int p, int q) {
    float d = 0;
    for (int c = 0; c < C; c++) {
      float v = img[(size_t)p * C + c] - img[(size_t)q * C + c];
      d += v * v;
    }
    return sqrtf(d);
  };
  for (int y = 0; y < H; y++)
    for (int x = 0; x < W; x++) {
      int p = y * W + x;
      if (x + 1 < W) edges.push_back({diff(p, p + 1), p, p + 1});
      if (y + 1 < H) edges.push_back({diff(p, p + W), p, p + W});
      if (x + 1 < W && y + 1 < H)
        edges.push_back({diff(p, p + W + 1), p, p + W + 1});
      if (x > 0 && y + 1 < H)
        edges.push_back({diff(p, p + W - 1), p, p + W - 1});
    }
  std::sort(edges.begin(), edges.end(),
            [](const Edge& a, const Edge& b) { return a.w < b.w; });

  DSU dsu(N);
  std::vector<float> threshold(N, scale);
  for (auto& e : edges) {
    int a = dsu.find(e.a), b = dsu.find(e.b);
    if (a == b) continue;
    if (e.w <= threshold[a] && e.w <= threshold[b]) {
      int r = dsu.join(a, b);
      threshold[r] = e.w + scale / dsu.size[r];
    }
  }
  // merge small components
  for (auto& e : edges) {
    int a = dsu.find(e.a), b = dsu.find(e.b);
    if (a != b && (dsu.size[a] < min_size || dsu.size[b] < min_size))
      dsu.join(a, b);
  }
  // relabel 0..K-1
  std::vector<int32_t> remap(N, -1);
  int next = 0;
  for (int i = 0; i < N; i++) {
    int r = dsu.find(i);
    if (remap[r] < 0) remap[r] = next++;
    labels[i] = remap[r];
  }
  return next;
}

// ---------------------------------------------------------------------------
// Quickshift (Vedaldi & Soatto) — LIME's default segmenter
// ---------------------------------------------------------------------------
// image HxWx3 RGB [0,1]; ratio scales color vs space; kernel_size the
// Parzen bandwidth; max_dist the maximum parent link length.

int quickshift(const float* image, int H, int W, float ratio,
               float kernel_size, float max_dist, int32_t* labels) {
  auto t_start = std::chrono::steady_clock::now();
  int N = H * W;
  std::vector<float> lab(3 * N);
  rgb2lab(image, lab.data(), N);
  for (int i = 0; i < 3 * N; i++) lab[i] *= ratio;

  // Parzen density with gaussian kernel over a (2w+1)^2 window.
  // Channel-planar (SoA) layout + unrolled channels + fast_expf lets the
  // compiler vectorize the contiguous inner xx loop (the container is
  // single-core, so SIMD is the only parallelism available).
  int w = std::max(1, (int)(3.0f * kernel_size));
  std::vector<float> density(N, 0.0f);
  float inv2s2 = 1.0f / (2.0f * kernel_size * kernel_size);
  std::vector<float> Lp(N), Ap(N), Bp(N);
  for (int i = 0; i < N; i++) {
    Lp[i] = lab[3 * i];
    Ap[i] = lab[3 * i + 1];
    Bp[i] = lab[3 * i + 2];
  }
  parallel_rows(H, [&](int y) {
    float* drow = &density[y * W];
    const float* Lc = &Lp[y * W];
    const float* Ac = &Ap[y * W];
    const float* Bc = &Bp[y * W];
    for (int dy = -w; dy <= w; dy++) {
      int yy = y + dy;
      if (yy < 0 || yy >= H) continue;
      for (int dx = -w; dx <= w; dx++) {
        // q = (yy, x + dx) contributes to p = (y, x) for every valid x:
        // the x loop is contiguous in both rows, trip ~W — wide enough
        // for the 16-lane AVX-512 form (the per-pixel 25-element window
        // loop vectorized but its trip count wasted the lanes)
        int x0 = dx < 0 ? -dx : 0;
        int x1 = dx > 0 ? W - dx : W;
        const float* Lr = &Lp[yy * W + dx];
        const float* Ar = &Ap[yy * W + dx];
        const float* Br = &Bp[yy * W + dx];
        float sp = (float)(dy * dy + dx * dx);
        #pragma omp simd
        for (int x = x0; x < x1; x++) {
          float vl = Lc[x] - Lr[x], va = Ac[x] - Ar[x],
                vb = Bc[x] - Br[x];
          float d = sp + vl * vl + va * va + vb * vb;
          drow[x] += fast_expf(-d * inv2s2);
        }
      }
    }
  });

  auto t_density = std::chrono::steady_clock::now();
  // link each pixel to the nearest higher-density neighbor.  skimage
  // confines the parent search to the SAME 3*kernel_size window as the
  // density estimate; max_dist is only the joint-distance cutoff beyond
  // which the pixel stays a root ("higher means fewer clusters").  A
  // max_dist-wide search (the previous behavior) cost O(N * max_dist^2)
  // (~10 s at 224^2 with LIME's max_dist=200) and collapsed everything
  // into one segment.  Ring-by-ring scan with an r^2 >= best early exit.
  int wd = std::min(w, (int)ceilf(max_dist));
  std::vector<int> parent(N);
  std::iota(parent.begin(), parent.end(), 0);
  parallel_rows(H, [&](int y) {
    for (int x = 0; x < W; x++) {
      int p = y * W + x;
      float best = max_dist * max_dist;
      int bestq = p;
      float dp = density[p];
      for (int r = 1; r <= wd; r++) {
        if ((float)(r) * (float)(r) >= best) break;
        int y0 = y - r, y1 = y + r, x0 = x - r, x1 = x + r;
        // ring perimeter: top & bottom rows, left & right columns
        for (int pass = 0; pass < 2; pass++) {
          int yy = pass == 0 ? y0 : y1;
          if (yy < 0 || yy >= H) continue;
          int xs = std::max(0, x0), xe = std::min(W - 1, x1);
          for (int xx = xs; xx <= xe; xx++) {
            int q = yy * W + xx;
            if (density[q] <= dp) continue;
            float d = (float)((y - yy) * (y - yy) + (x - xx) * (x - xx));
            for (int c = 0; c < 3; c++) {
              float v = lab[3 * p + c] - lab[3 * q + c];
              d += v * v;
            }
            if (d < best) { best = d; bestq = q; }
          }
        }
        for (int pass = 0; pass < 2; pass++) {
          int xx = pass == 0 ? x0 : x1;
          if (xx < 0 || xx >= W) continue;
          int ys = std::max(0, y0 + 1), ye = std::min(H - 1, y1 - 1);
          for (int yy = ys; yy <= ye; yy++) {
            int q = yy * W + xx;
            if (density[q] <= dp) continue;
            float d = (float)((y - yy) * (y - yy) + (x - xx) * (x - xx));
            for (int c = 0; c < 3; c++) {
              float v = lab[3 * p + c] - lab[3 * q + c];
              d += v * v;
            }
            if (d < best) { best = d; bestq = q; }
          }
        }
      }
      parent[p] = bestq;
    }
  });
  auto t_parent = std::chrono::steady_clock::now();
  if (getenv("XAI_NATIVE_DEBUG")) {
    auto ms = [](auto a, auto b) {
      return std::chrono::duration<double, std::milli>(b - a).count();
    };
    fprintf(stderr, "[quickshift] density %.1f ms, parent %.1f ms\n",
            ms(t_start, t_density), ms(t_density, t_parent));
  }

  // flatten forests to roots, relabel
  std::vector<int32_t> remap(N, -1);
  int next = 0;
  for (int i = 0; i < N; i++) {
    int r = i;
    while (parent[r] != r) r = parent[r];
    int rr = i;  // path compress
    while (parent[rr] != rr) { int t = parent[rr]; parent[rr] = r; rr = t; }
    if (remap[r] < 0) remap[r] = next++;
    labels[i] = remap[r];
  }
  return next;
}

// ---------------------------------------------------------------------------
// MAS curve projection (cvxopt QP replacement, MASTestFunctions.py:311-350)
// min ||x - y||^2  s.t.  0<=x<=1, x[0]=y[0], x[n-1]=y[n-1],
//   del: -x[i] + 2x[i+1] - x[i+2] <= 0   (convex curve)
//   ins:  x[i] - 2x[i+1] + x[i+2] <= 0   (concave curve)
// Dykstra's alternating projections; each halfspace a^T x <= 0 projected in
// closed form.  mode: 0 = del (convex), 1 = ins (concave).
// ---------------------------------------------------------------------------
void project_curve(const double* y, int n, int mode, int iters, double* x) {
  std::vector<double> xv(y, y + n);
  int m = n - 2;                     // halfspaces
  std::vector<double> corr((size_t)m, 0.0);  // Dykstra corrections per constraint
  std::vector<double> corr_i(n, 0.0), corr_box(n, 0.0);
  // each constraint involves 3 coords: (i, i+1, i+2) with coeffs
  double c0 = (mode == 0) ? -1 : 1, c1 = (mode == 0) ? 2 : -2,
         c2 = (mode == 0) ? -1 : 1;
  double norm2 = c0 * c0 + c1 * c1 + c2 * c2;  // = 6

  for (int it = 0; it < iters; it++) {
    // box + endpoints projection with its correction
    for (int i = 0; i < n; i++) {
      double v = xv[i] + corr_box[i];
      double pv = std::min(1.0, std::max(0.0, v));
      if (i == 0) pv = y[0];
      if (i == n - 1) pv = y[n - 1];
      corr_box[i] = v - pv;
      xv[i] = pv;
    }
    // halfspace projections (cyclic); each correction is stored as the
    // scalar multiple t of its constraint normal a (Dykstra: v = x + t*a)
    double max_step = 0.0;
    for (int i = 0; i < m; i++) {
      double a_dot = c0 * (xv[i]) + c1 * (xv[i + 1]) + c2 * (xv[i + 2]) +
                     corr[i] * norm2;
      double t = a_dot > 0 ? a_dot / norm2 : 0.0;
      // new correction = (v - P(v)) expressed in multiples of a:
      // v = x + corr*a ; P(v) = v - t*a ; corr_new = t
      double d = corr[i] - t;
      xv[i] += d * c0;
      xv[i + 1] += d * c1;
      xv[i + 2] += d * c2;
      corr[i] = t;
      double ad = d > 0 ? d : -d;
      if (ad > max_step) max_step = ad;
    }
    // converged: no projection moved anything this sweep.  Dykstra's rate
    // is linear, so strongly infeasible curves (e.g. S-shaped responses
    // projected onto the concave cone) genuinely need 1e4-1e5 sweeps —
    // the early exit makes a large `iters` cap affordable for the easy
    // majority.
    if (max_step < 1e-14 && it > 0) break;
  }
  // final feasibility pass: box + endpoints exactly (residual halfspace
  // violation is O(1/iters))
  for (int i = 0; i < n; i++) xv[i] = std::min(1.0, std::max(0.0, xv[i]));
  xv[0] = y[0];
  xv[n - 1] = y[n - 1];
  std::memcpy(x, xv.data(), n * sizeof(double));
}

}  // extern "C"

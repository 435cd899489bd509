// Quickshift parent links of LAB * ratio planes lab [B, 3, H, W] float32:
//   density[p] = sum over the (2w+1)^2 window q of exp(-d2(p, q) * inv2s2)
//   parent[p]  = the window pixel q (Chebyshev |q - p| <= wd, q != p) of
//                least d2 with density[q] > density[p] and d2 < max_d2,
//                the earliest offset on ties; else p itself
// where d2 = ((dl0^2 + dl1^2) + dl2^2) + dy^2 + dx^2.  Output: out [B, H, W]
// int32 flat parent index, density scratch dens [B, H, W] float32.
//
// Replaces the Pallas TPU kernel quickshift_parents_pallas / _make_kernel
// (xai_tpu/kernels/quickshift_pallas.py), which held one whole padded
// image in VMEM and ran the 625 window offsets as a loop of rolled
// full-image planes.
//
// Bound on the H100: operations.  At 224 px and w = wd = 12 each phase
// visits ~29.6 M in-image (pixel, offset) pairs: ~12 FP32 lane operations
// and one exp per pair for the density, ~14 for the parent, ~0.8 G lane
// operations in all, ~23 us at 128 lanes x 132 SMs x 1.98 GHz.  Bytes are
// ~0.8 MB (~0.24 us at 3.35 TB/s).  So the design keeps every read of
// the window in shared memory: a block of 32 x 8 threads, one output pixel
// each, loads its tile of the LAB planes with a w-pixel halo (and, for the
// parent phase, the density tile), then each thread walks its window
// offsets in row-major order.  A warp reads one row of 32 consecutive
// pixels: no bank conflicts.  The halo outside the image holds the plain
// version's sentinels (LAB 1e6, density -1e30): a sentinel's density term
// is exactly +0.0 and it never passes the parent test, so every thread
// runs the same fixed window with no bounds test.  (Clamping the loop
// bounds to the image instead gave wrong densities on the H100 in the
// last block column, where the inner loop's end varies per thread.)
//
// Numerics: the parents must be bit-exact against the plain PyTorch
// version, and a parent flips on a near-tie of two densities, so every
// float operation rounds as that version's separate elementwise ops do:
// explicit __fsub_rn / __fmul_rn / __fadd_rn (nvcc would otherwise
// contract a * a + b into an FMA), expf (not __expf), and the window
// summed in the same order.
#include <cmath>

#include <cuda_runtime.h>

namespace {

constexpr int TX = 32;   // output tile width; blockDim.x
constexpr int TY = 8;    // output tile height; blockDim.y

constexpr float COLOR_FILL = 1e6f;   // ops/quickshift.py _COLOR_FILL
constexpr float DENS_FILL = -1e30f;  // ops/quickshift.py _DENS_FILL

// One [H, W] plane's tile [sh][sw] at (y0, x0), `fill` outside the plane.
__device__ void load_tile(const float* __restrict__ plane, float* tile,
                          int H, int W, int y0, int x0, int sh, int sw,
                          float fill) {
  const int tid = threadIdx.y * TX + threadIdx.x;
  for (int i = tid; i < sh * sw; i += TX * TY) {
    const int ty = i / sw, tx = i - ty * sw;
    const int gy = y0 + ty, gx = x0 + tx;
    tile[i] = (gy >= 0 && gy < H && gx >= 0 && gx < W)
                  ? plane[(size_t)gy * W + gx] : fill;
  }
}

__device__ __forceinline__ float dist2(const float* l0, const float* l1,
                                       const float* l2, int j, float c0,
                                       float c1, float c2, float sp) {
  const float a = __fsub_rn(l0[j], c0);
  const float b = __fsub_rn(l1[j], c1);
  const float c = __fsub_rn(l2[j], c2);
  return __fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn(a, a), __fmul_rn(b, b)),
                             __fmul_rn(c, c)),
                   sp);
}

__global__ void __launch_bounds__(TX * TY)
density_kernel(const float* __restrict__ lab, float* __restrict__ dens,
               int H, int W, int w, float inv2s2) {
  extern __shared__ float smem[];
  const int sw = TX + 2 * w, sh = TY + 2 * w, n = sh * sw;
  const size_t hw = (size_t)H * W;
  const float* img = lab + blockIdx.z * 3 * hw;
  const int y0 = blockIdx.y * TY - w, x0 = blockIdx.x * TX - w;
  for (int p = 0; p < 3; ++p)
    load_tile(img + p * hw, smem + p * n, H, W, y0, x0, sh, sw,
              COLOR_FILL);
  __syncthreads();

  const int gy = blockIdx.y * TY + threadIdx.y;
  const int gx = blockIdx.x * TX + threadIdx.x;
  if (gy >= H || gx >= W) return;
  const float* l0 = smem;
  const float* l1 = smem + n;
  const float* l2 = smem + 2 * n;
  const int ci = (threadIdx.y + w) * sw + threadIdx.x + w;
  const float c0 = l0[ci], c1 = l1[ci], c2 = l2[ci];
  float acc = 0.f;
  for (int dy = -w; dy <= w; ++dy) {
    const int row = ci + dy * sw;
    for (int dx = -w; dx <= w; ++dx) {
      const float d2 = dist2(l0, l1, l2, row + dx, c0, c1, c2,
                             (float)(dy * dy + dx * dx));
      acc = __fadd_rn(acc, expf(__fmul_rn(-d2, inv2s2)));
    }
  }
  dens[blockIdx.z * hw + (size_t)gy * W + gx] = acc;
}

__global__ void __launch_bounds__(TX * TY)
parent_kernel(const float* __restrict__ lab, const float* __restrict__ dens,
              int* __restrict__ out, int H, int W, int w, int wd,
              float max_d2) {
  extern __shared__ float smem[];
  const int sw = TX + 2 * w, sh = TY + 2 * w, n = sh * sw;
  const size_t hw = (size_t)H * W;
  const float* img = lab + blockIdx.z * 3 * hw;
  const int y0 = blockIdx.y * TY - w, x0 = blockIdx.x * TX - w;
  for (int p = 0; p < 3; ++p)
    load_tile(img + p * hw, smem + p * n, H, W, y0, x0, sh, sw,
              COLOR_FILL);
  load_tile(dens + blockIdx.z * hw, smem + 3 * n, H, W, y0, x0, sh, sw,
            DENS_FILL);
  __syncthreads();

  const int gy = blockIdx.y * TY + threadIdx.y;
  const int gx = blockIdx.x * TX + threadIdx.x;
  if (gy >= H || gx >= W) return;
  const float* l0 = smem;
  const float* l1 = smem + n;
  const float* l2 = smem + 2 * n;
  const float* dn = smem + 3 * n;
  const int ci = (threadIdx.y + w) * sw + threadIdx.x + w;
  const float c0 = l0[ci], c1 = l1[ci], c2 = l2[ci], own = dn[ci];
  float best = INFINITY;
  int best_off = 0;
  for (int dy = -wd; dy <= wd; ++dy) {
    const int row = ci + dy * sw;
    for (int dx = -wd; dx <= wd; ++dx) {
      if (dy == 0 && dx == 0) continue;
      const float d2 = dist2(l0, l1, l2, row + dx, c0, c1, c2,
                             (float)(dy * dy + dx * dx));
      // strict < keeps the earliest offset on ties
      if (dn[row + dx] > own && d2 < max_d2 && d2 < best) {
        best = d2;
        best_off = dy * W + dx;
      }
    }
  }
  out[blockIdx.z * hw + (size_t)gy * W + gx] = gy * W + gx + best_off;
}

}  // namespace

extern "C" {

const char* xai_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// lab: [b, 3, h, w_img] float32; dens: [b, h, w_img] float32 scratch;
// out: [b, h, w_img] int32; all contiguous.  The caller checks shapes,
// b <= 65535, 0 <= wd <= w and w <= 18, which keeps the parent phase's
// four tiles of (32 + 2w) x (8 + 2w) floats under the 48 KB a block gets
// without opting in.  Launches the density phase, then the parent phase,
// on `stream`.
int xai_quickshift_parents(const void* lab, void* dens, void* out, int b,
                           int h, int w_img, int w, int wd, float inv2s2,
                           float max_d2, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t tile = sizeof(float) * (TX + 2 * w) * (TY + 2 * w);
  const dim3 grid((w_img + TX - 1) / TX, (h + TY - 1) / TY, b);
  const dim3 block(TX, TY);
  density_kernel<<<grid, block, 3 * tile, st>>>(
      static_cast<const float*>(lab), static_cast<float*>(dens), h, w_img, w,
      inv2s2);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  parent_kernel<<<grid, block, 4 * tile, st>>>(
      static_cast<const float*>(lab), static_cast<const float*>(dens),
      static_cast<int*>(out), h, w_img, w, wd, max_d2);
  return cudaGetLastError();
}

}  // extern "C"

// Quickshift parent links of LAB * ratio planes lab [B, 3, H, W] float32:
//   density[p] = sum over the (2w+1)^2 window q of exp(-d2(p, q) * inv2s2)
//   parent[p]  = the window pixel q (Chebyshev |q - p| <= wd, q != p) of
//                least d2 with density[q] > density[p] and d2 < max_d2,
//                the earliest offset on ties; else p itself
// where d2 = ((dl0^2 + dl1^2) + dl2^2) + (dy^2 + dx^2).  Output: out
// [B, H, W] int32 flat parent index, density scratch dens [B, H, W] float32.
//
// Replaces the Pallas TPU kernel quickshift_parents_pallas / _make_kernel
// (xai_tpu/kernels/quickshift_pallas.py), which held one whole padded
// image in VMEM and ran the 625 window offsets as a loop of rolled
// full-image planes.
//
// What bounds it on the H100: instruction issue.  At 224 px and w = wd = 12
// each phase visits ~29.6 M in-image (pixel, offset) pairs.  Bit-exact
// parents fix the arithmetic of a pair (below): ~20 issued instructions a
// density pair (d2 with its spatial term, the scale, expf's sequence, the
// accumulate) and ~14 a parent pair, against the ~12 and ~14 FP32 lane operations that
// kernels/bounds.py counts for the bound.  Bytes are ~0.8 MB (~0.24 us).
//
// What held the first version back (97 us at one image, 250 us at four,
// on an NVIDIA H100 80GB HBM3 at 700 W):
// one thread per pixel on 32 x 8 tiles gave 196 blocks for 132 SMs at one
// image, 1.48 a SM; every pair read its neighbour's 3 (parent: 4) floats
// from shared memory with 3 (4) loads; and the window was a run-time loop,
// so every pair also paid for loop counters, addresses and its spatial
// term.
//
// The design:
// - A compile-time window.  The kernels are templates on w and wd: LIME's
//   w = wd = 12 is instantiated (its loops unroll, dx^2 and the
//   shared-memory offsets become constants), and an instantiation with
//   both read at run time serves every other 1 <= w <= MAX_W.
// - One 16-byte load a neighbour.  The tile holds (L0, L1, L2, density)
//   per pixel as a float4, so a pair reads its neighbour with one LDS.128.
// - Register blocking along y.  A thread owns R vertically adjacent pixels
//   of one column.  It walks the source rows of its strip top to bottom
//   and each row left to right, loads a neighbour once and updates every
//   owned pixel whose window holds that row.  Each pixel still meets its
//   window in row-major order (dy ascending, then dx ascending), the order
//   of the plain version, so its density is the same float sum, bit for
//   bit, and the strict < of the parent search keeps the same earliest
//   offset on ties.  A warp reads 32 consecutive pixels of one row: no
//   bank conflicts.
// - Two tiles.  R = 2 with 8 warps a block (32 x 16 pixels) issues the
//   fewest loads, but one 224 px image is only 98 such blocks; R = 1 with
//   4 warps (32 x 4) gives 392 blocks, 3 on every SM, and 1568 warps for
//   528 schedulers.  The launch takes the larger tile wherever its blocks
//   spread evenly over the SMs (four images: 392 blocks).  Timed against
//   this choice, 32 x 4 alone lost 8 % at four images and 32 x 16 alone
//   18 % at one, and R >= 3 was slower at both: a row unrolls into 26 KB
//   of code and more (PERF.md, PR 3).
// - The tile and its w-pixel halo reach shared memory through registers,
//   16 pixels a thread at a time, one 16-byte store a pixel.  (4-byte
//   cp.async copies into the interleaved tile, four to a pixel, each store
//   4-way bank-conflicted, measured slower.)  The halo outside the image
//   holds the plain version's sentinels (LAB 1e6, density -1e30): a
//   sentinel's density term is exactly +0.0 and it never passes the
//   parent test, so every pixel runs the same fixed window with no bounds
//   test.  (Clamping each thread's loop bounds to the image instead gave
//   wrong densities on the H100 in the last block column.)  Rows of a
//   strip below the image are computed and not stored.
// - Density and parent stay two launches: a parent needs the densities of
//   its whole window, halo included.  The parent phase is launched as a
//   programmatic dependent of the density phase: its blocks are launched
//   while the density phase ends, and wait for it (griddepcontrol.wait)
//   before they load their tiles.
//
// Numerics: the parents must be bit-exact against the plain PyTorch
// version, and a parent flips on a near-tie of two densities, so every
// float operation rounds as that version's separate elementwise ops do:
// explicit __fsub_rn / __fmul_rn / __fadd_rn (nvcc would otherwise
// contract a * a + b into an FMA), expf (not __expf: it matches torch.exp
// on CUDA bit for bit), the spatial term dy^2 + dx^2 exact (two exact
// integers in float), and x * -s for the plain -x * s (the same
// rounding).  The parent search starts its best distance at max_d2, which
// is the plain version's d2 < max_d2 && d2 < best, and skips no offset:
// the pixel itself has d2 = 0 but not a higher density.
#include <cmath>

#include <cuda_runtime.h>

namespace {

// A thread owns R pixels of one column, one above another; a block is
// WARPS warps stacked in y: a 32 x R*WARPS output tile.
template <int R_, int WARPS_>
struct Tile {
  static constexpr int R = R_, WARPS = WARPS_, TY = R_ * WARPS_;
};
using Few = Tile<1, 4>;    // grids of few blocks: 1568 warps at one image
using Many = Tile<2, 8>;   // grids that fill every SM evenly

constexpr int TX = 32;             // output tile width
constexpr int LIME_W = 12;         // kernel_size 4: w = wd = 12
constexpr float COLOR_FILL = 1e6f;   // ops/quickshift.py _COLOR_FILL
constexpr float DENS_FILL = -1e30f;  // ops/quickshift.py _DENS_FILL

// The block's tile of one image as (L0, L1, L2, density) per pixel: [sh][sw]
// float4 at (y0, x0), the tile's top-left corner in the image, with the
// plain version's sentinels outside the image; the density is 0 where
// `dens` is null (the density phase).  A thread loads the floats of 16
// pixels at a time, all in flight together, and stores each pixel with one
// 16-byte store; a thread then reads a neighbour with one 16-byte load.
template <class T>
__device__ __forceinline__ void load_tile(const float* __restrict__ img,
                                          const float* __restrict__ dens,
                                          float4* tile, size_t hw, int H,
                                          int W, int y0, int x0, int sh,
                                          int sw) {
  constexpr int N = T::WARPS * TX, BATCH = 16;
  const int n = sh * sw;
  const int tid = threadIdx.y * TX + threadIdx.x;
  for (int first = 0; first < n; first += BATCH * N) {
    float4 v[BATCH];
#pragma unroll
    for (int j = 0; j < BATCH; ++j) {
      const int p = first + j * N + tid;
      const int ty = p / sw, tx = p - ty * sw;
      const int gy = y0 + ty, gx = x0 + tx;
      if (p < n && gy >= 0 && gy < H && gx >= 0 && gx < W) {
        const size_t o = (size_t)gy * W + gx;
        v[j] = make_float4(__ldg(img + o), __ldg(img + hw + o),
                           __ldg(img + 2 * hw + o),
                           dens ? __ldg(dens + o) : 0.f);
      } else {
        v[j] = make_float4(COLOR_FILL, COLOR_FILL, COLOR_FILL, DENS_FILL);
      }
    }
#pragma unroll
    for (int j = 0; j < BATCH; ++j) {
      const int p = first + j * N + tid;
      if (p < n) tile[p] = v[j];
    }
  }
}

__device__ __forceinline__ float dist2(const float4& q, float c0, float c1,
                                       float c2, float sp) {
  const float a = __fsub_rn(q.x, c0);
  const float b = __fsub_rn(q.y, c1);
  const float c = __fsub_rn(q.z, c2);
  return __fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn(a, a), __fmul_rn(b, b)),
                             __fmul_rn(c, c)),
                   sp);
}

// Pixel i of a strip meets source row s (s = 0 is the top row of pixel
// 0's window of radius r) at dy = s - r - i, and takes the row where
// |dy| <= r (`on`; CHECK is false on the rows that every owned pixel
// takes).  dyy = dy^2, an exact integer in float.
template <int R, bool CHECK>
struct RowDy {
  float dyy[R];
  bool on[R];

  __device__ __forceinline__ RowDy(int s, int r) {
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int dy = s - r - i;
      dyy[i] = static_cast<float>(dy * dy);
      on[i] = !CHECK ||
              static_cast<unsigned>(s - i) <= static_cast<unsigned>(2 * r);
    }
  }
};

// Source row s of a strip (s = 0 is the top row of pixel 0's window) into
// the density sums of the thread's R pixels.  `t` points at the strip's
// top row, centre column.
template <class T, int W_, bool CHECK>
__device__ __forceinline__ void density_row(const float4* t, int sw, int s,
                                            int w, const float (&c0)[T::R],
                                            const float (&c1)[T::R],
                                            const float (&c2)[T::R],
                                            float (&acc)[T::R],
                                            float neg_inv2s2) {
  if (W_ > 0) w = W_;
  const float4* row = t + s * sw;
  const RowDy<T::R, CHECK> dy(s, w);
#pragma unroll
  for (int dx = -w; dx <= w; ++dx) {
    const float4 q = row[dx];
    const float dxx = static_cast<float>(dx * dx);
#pragma unroll
    for (int i = 0; i < T::R; ++i) {
      if (dy.on[i]) {
        const float d2 =
            dist2(q, c0[i], c1[i], c2[i], __fadd_rn(dy.dyy[i], dxx));
        acc[i] = __fadd_rn(acc[i], expf(__fmul_rn(d2, neg_inv2s2)));
      }
    }
  }
}

template <class T, int W_>
__global__ void __launch_bounds__(TX * T::WARPS)
density_kernel(const float* __restrict__ lab, float* __restrict__ dens,
               int H, int W, int w_run, float neg_inv2s2) {
  constexpr int R = T::R;
  const int w = W_ > 0 ? W_ : w_run;
  extern __shared__ float4 tile[];
  const int sw = TX + 2 * w, sh = T::TY + 2 * w;
  const size_t hw = (size_t)H * W;
  const float* img = lab + blockIdx.z * 3 * hw;
  const int y0 = blockIdx.y * T::TY, x0 = blockIdx.x * TX;
  load_tile<T>(img, nullptr, tile, hw, H, W, y0 - w, x0 - w, sh, sw);
  __syncthreads();

  const int strip = threadIdx.y * R;     // tile row of pixel 0, less w
  const float4* t = tile + strip * sw + threadIdx.x + w;
  float c0[R], c1[R], c2[R], acc[R];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const float4 q = t[(i + w) * sw];
    c0[i] = q.x;
    c1[i] = q.y;
    c2[i] = q.z;
    acc[i] = 0.f;
  }
  int s = 0;
  for (; s < R - 1; ++s)
    density_row<T, W_, true>(t, sw, s, w, c0, c1, c2, acc, neg_inv2s2);
  for (; s <= 2 * w; ++s)
    density_row<T, W_, false>(t, sw, s, w, c0, c1, c2, acc, neg_inv2s2);
  for (; s < R + 2 * w; ++s)
    density_row<T, W_, true>(t, sw, s, w, c0, c1, c2, acc, neg_inv2s2);

  const int gx = x0 + threadIdx.x;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int gy = y0 + strip + i;
    if (gy < H && gx < W) dens[blockIdx.z * hw + (size_t)gy * W + gx] = acc[i];
  }
}

// Source row s of a strip (s = 0 is the top row of pixel 0's parent
// window) into the parent search of the thread's R pixels, as
// density_row; a pixel keeps the dx of its best offset, and its dy is
// set after the row if the row improved its best.
template <class T, int WD_, bool CHECK>
__device__ __forceinline__ void parent_row(
    const float4* t, int sw, int s, int wd, const float (&c0)[T::R],
    const float (&c1)[T::R], const float (&c2)[T::R],
    const float (&own)[T::R], float (&best)[T::R], int (&bdy)[T::R],
    int (&bdx)[T::R]) {
  constexpr int R = T::R;
  if (WD_ > 0) wd = WD_;
  const float4* row = t + s * sw;
  const RowDy<R, CHECK> dy(s, wd);
  float before[R];
#pragma unroll
  for (int i = 0; i < R; ++i) before[i] = best[i];
#pragma unroll
  for (int dx = -wd; dx <= wd; ++dx) {
    const float4 q = row[dx];
    const float dxx = static_cast<float>(dx * dx);
#pragma unroll
    for (int i = 0; i < R; ++i) {
      if (dy.on[i]) {
        const float d2 =
            dist2(q, c0[i], c1[i], c2[i], __fadd_rn(dy.dyy[i], dxx));
        // strict < keeps the earliest offset on ties
        if (q.w > own[i] && d2 < best[i]) {
          best[i] = d2;
          bdx[i] = dx;
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < R; ++i)
    if (best[i] < before[i]) bdy[i] = s - wd - i;
}

template <class T, int W_, int WD_>
__global__ void __launch_bounds__(TX * T::WARPS)
parent_kernel(const float* __restrict__ lab, const float* __restrict__ dens,
              int* __restrict__ out, int H, int W, int w_run, int wd_run,
              float max_d2) {
  constexpr int R = T::R;
  const int w = W_ > 0 ? W_ : w_run;
  const int wd = W_ > 0 ? WD_ : wd_run;
  extern __shared__ float4 tile[];
  const int sw = TX + 2 * w, sh = T::TY + 2 * w;
  const size_t hw = (size_t)H * W;
  const float* img = lab + blockIdx.z * 3 * hw;
  const int y0 = blockIdx.y * T::TY, x0 = blockIdx.x * TX;
  // launched before the density phase ends (launch): its blocks start
  // while that phase's last blocks run, and read the densities only after
  // it has finished and its writes are visible
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  load_tile<T>(img, dens + blockIdx.z * hw, tile, hw, H, W, y0 - w, x0 - w,
               sh, sw);
  __syncthreads();

  const int strip = threadIdx.y * R;
  const float4* t = tile + (strip + w - wd) * sw + threadIdx.x + w;
  float c0[R], c1[R], c2[R], own[R], best[R];
  int bdy[R], bdx[R];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const float4 q = t[(i + wd) * sw];
    c0[i] = q.x;
    c1[i] = q.y;
    c2[i] = q.z;
    own[i] = q.w;
    best[i] = max_d2;
    bdy[i] = 0;
    bdx[i] = 0;
  }
  int s = 0;
  for (; s < R - 1; ++s)
    parent_row<T, WD_, true>(t, sw, s, wd, c0, c1, c2, own, best, bdy, bdx);
  for (; s <= 2 * wd; ++s)
    parent_row<T, WD_, false>(t, sw, s, wd, c0, c1, c2, own, best, bdy,
                              bdx);
  for (; s < R + 2 * wd; ++s)
    parent_row<T, WD_, true>(t, sw, s, wd, c0, c1, c2, own, best, bdy, bdx);

  const int gx = x0 + threadIdx.x;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int gy = y0 + strip + i;
    if (gy < H && gx < W)
      out[blockIdx.z * hw + (size_t)gy * W + gx] =
          (gy + bdy[i]) * W + gx + bdx[i];
  }
}

template <typename K>
cudaError_t allow_smem(K* kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

// W_ = WD_ = 0: the window read at run time.
template <class T, int W_, int WD_>
cudaError_t launch(const float* lab, float* dens, int* out, int b, int h,
                   int w_img, int w, int wd, float neg_inv2s2, float max_d2,
                   cudaStream_t st) {
  const size_t tile = sizeof(float4) * (TX + 2 * w) * (T::TY + 2 * w);
  const dim3 grid((w_img + TX - 1) / TX, (h + T::TY - 1) / T::TY, b);
  const dim3 block(TX, T::WARPS);
  cudaError_t err = allow_smem(density_kernel<T, W_>, tile);
  if (err != cudaSuccess) return err;
  err = allow_smem(parent_kernel<T, W_, WD_>, tile);
  if (err != cudaSuccess) return err;
  density_kernel<T, W_><<<grid, block, tile, st>>>(lab, dens, h, w_img, w,
                                                    neg_inv2s2);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute early;
  early.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  early.val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = block;
  cfg.dynamicSmemBytes = tile;
  cfg.stream = st;
  cfg.attrs = &early;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, parent_kernel<T, W_, WD_>, lab,
                           static_cast<const float*>(dens), out, h, w_img, w,
                           wd, max_d2);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// The Many tile where its blocks spread over the SMs evenly: the busiest
// SM holds no more than 10/9 of the mean.  Else the Few tile, whose
// blocks are a quarter the size.  (One 224 px image: Many gives 98 blocks
// for 132 SMs, Few 392, 3 a SM; four images: Many gives 392.)
template <int W_, int WD_>
cudaError_t launch_tile(const float* lab, float* dens, int* out, int b,
                        int h, int w_img, int w, int wd, float neg_inv2s2,
                        float max_d2, int sms, cudaStream_t st) {
  const long blocks = (long)((w_img + TX - 1) / TX) *
                      ((h + Many::TY - 1) / Many::TY) * b;
  const long busiest = (blocks + sms - 1) / sms;
  if (blocks * 10 >= busiest * sms * 9)
    return launch<Many, W_, WD_>(lab, dens, out, b, h, w_img, w, wd,
                                 neg_inv2s2, max_d2, st);
  return launch<Few, W_, WD_>(lab, dens, out, b, h, w_img, w, wd, neg_inv2s2,
                              max_d2, st);
}

}  // namespace

extern "C" {

const char* xai_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// lab: [b, 3, h, w_img] float32; dens: [b, h, w_img] float32 scratch;
// out: [b, h, w_img] int32; all contiguous.  The caller checks shapes,
// b <= 65535 and 0 <= wd <= w <= MAX_W.  Launches the density phase, then
// the parent phase, on `stream`.
int xai_quickshift_parents(const void* lab, void* dens, void* out, int b,
                           int h, int w_img, int w, int wd, float inv2s2,
                           float max_d2, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  const auto* l = static_cast<const float*>(lab);
  auto* d = static_cast<float*>(dens);
  auto* o = static_cast<int*>(out);
  auto* st = static_cast<cudaStream_t>(stream);
  if (w == LIME_W && wd == LIME_W)
    return launch_tile<LIME_W, LIME_W>(l, d, o, b, h, w_img, w, wd, -inv2s2,
                                       max_d2, sms, st);
  return launch_tile<0, 0>(l, d, o, b, h, w_img, w, wd, -inv2s2, max_d2, sms,
                           st);
}

}  // extern "C"

// Separable 'same', zero-padded Gaussian blur of float32 planes [N, H, W].
//
// Replaces the Pallas TPU kernel pallas_blur / _blur_kernel
// (xai_tpu/kernels/blur_pallas.py).  The 31x31 sigma-31 kernel (gkern) is
// rank-1, so the blur is a column pass with `col` taps followed by a row
// pass with `row` taps, the SVD factors computed on the host in float64.
//
// The TPU form ran each pass as a 224-deep banded-Toeplitz matmul
// (T_col @ x @ T_row^T) because the MXU made that cheap and 62 unrolled
// shifted adds stalled its compiler.  On Hopper those GEMMs would be ~85%
// zeros; 62 fused multiply-adds per pixel on the CUDA cores are far less
// work.  At the main path's [3, 224, 224] the work is 18.7 MFLOP and
// 1.2 MB of device traffic: ~0.28 us of float32 issue at 67 TFLOP/s and
// ~0.36 us at 3.35 TB/s, so the bound is bytes and in practice the launch.
// The design therefore reads each input pixel from device memory once:
// one block per (plane, 32x32 output tile) loads the tile plus its
// klen/2-pixel halo (zeros outside the plane) into shared memory, runs the
// column pass into shared memory, then the row pass straight to device
// memory.  Summation order is that of the TPU form (columns, then rows).
#include <cuda_runtime.h>

namespace {

constexpr int TILE = 32;   // output tile edge; blockDim.x
constexpr int ROWS = 8;    // blockDim.y

__global__ void __launch_bounds__(TILE * ROWS)
blur_planes_kernel(const float* __restrict__ x, float* __restrict__ out,
                   const float* __restrict__ col,
                   const float* __restrict__ row, int H, int W, int klen) {
  extern __shared__ float smem[];
  const int pad = klen / 2;
  const int span = TILE + klen - 1;      // tile edge plus both halos
  float* tcol = smem;                    // [klen]
  float* trow = tcol + klen;             // [klen]
  float* tile = trow + klen;             // [span][span] input + halo
  float* mid = tile + span * span;       // [TILE][span] after column pass

  const size_t plane_off = (size_t)blockIdx.z * H * W;
  const float* plane = x + plane_off;
  const int y0 = blockIdx.y * TILE - pad;
  const int x0 = blockIdx.x * TILE - pad;
  const int tid = threadIdx.y * TILE + threadIdx.x;
  const int nthreads = TILE * ROWS;

  for (int i = tid; i < klen; i += nthreads) {
    tcol[i] = col[i];
    trow[i] = row[i];
  }
  for (int i = tid; i < span * span; i += nthreads) {
    const int ty = i / span, tx = i - ty * span;
    const int gy = y0 + ty, gx = x0 + tx;
    tile[i] = (gy >= 0 && gy < H && gx >= 0 && gx < W)
                  ? plane[(size_t)gy * W + gx] : 0.f;
  }
  __syncthreads();

  // column pass: mid[r][c] = sum_t col[t] * tile[r + t][c]
  for (int i = tid; i < TILE * span; i += nthreads) {
    const int r = i / span, c = i - r * span;
    float acc = 0.f;
    for (int t = 0; t < klen; ++t)
      acc = fmaf(tcol[t], tile[(r + t) * span + c], acc);
    mid[i] = acc;
  }
  __syncthreads();

  // row pass: out[r][c] = sum_t row[t] * mid[r][c + t]
  const int gx = blockIdx.x * TILE + threadIdx.x;
  for (int r = threadIdx.y; r < TILE; r += ROWS) {
    const int gy = blockIdx.y * TILE + r;
    if (gy < H && gx < W) {
      const float* m = mid + r * span + threadIdx.x;
      float acc = 0.f;
      for (int t = 0; t < klen; ++t) acc = fmaf(trow[t], m[t], acc);
      out[plane_off + (size_t)gy * W + gx] = acc;
    }
  }
}

}  // namespace

extern "C" {

const char* xai_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// x, out: [n, h, w] float32, contiguous; col, row: [klen] float32 taps.
// The caller checks shapes and klen (odd, <= 63: shared memory stays
// under the 48 KB a block gets without opting in).
int xai_blur_planes(const void* x, void* out, const void* col,
                    const void* row, int n, int h, int w, int klen,
                    int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const int span = TILE + klen - 1;
  const size_t smem = sizeof(float) * (2 * klen + span * span + TILE * span);
  const dim3 grid((w + TILE - 1) / TILE, (h + TILE - 1) / TILE, n);
  const dim3 block(TILE, ROWS);
  blur_planes_kernel<<<grid, block, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(out),
      static_cast<const float*>(col), static_cast<const float*>(row), h, w,
      klen);
  return cudaGetLastError();
}

}  // extern "C"

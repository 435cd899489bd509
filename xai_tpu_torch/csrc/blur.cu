// Separable 'same', zero-padded Gaussian blur of float32 planes [N, H, W].
//
// Replaces the Pallas TPU kernel pallas_blur / _blur_kernel
// (xai_tpu/kernels/blur_pallas.py).  The klen x klen kernel (gkern) is
// rank-1, so the blur is a row pass with `row` taps and a column pass with
// `col` taps, the SVD factors computed on the host in float64.  The TPU
// form ran each pass as a 224-deep banded-Toeplitz matmul (T_col @ x @
// T_row^T), cheap on the MXU; on Hopper those GEMMs would be ~85% zeros,
// and 62 fused multiply-adds a pixel on the CUDA cores are far less work.
//
// What bounds it on the H100: bytes, and below them the launch.  At the
// main path's [3, 224, 224] the work is 18.7 MFLOP (~0.28 us at
// 67 TFLOP/s) and 1.2 MB of device traffic (~0.36 us at 3.35 TB/s), both
// under the card's per-launch floor of a few microseconds (PERF.md).  So
// the kernel is latency-bound: its time is the path of one block.
//
// What held the first version back: 32 x 32 tiles gave 147 blocks for 132
// SMs at [3, 224, 224] (15 SMs ran two blocks one after the other), the
// tile load was a 15-step loop with an integer division and a dependent
// load in each step, and both passes read a tap and an operand from shared
// memory for every FMA, behind three phases and two barriers.
//
// The design:
// - 32 x 40 output tiles: 7 x 6 x 3 = 126 blocks at [3, 224, 224], one per
//   SM and none waiting; 504 at [12, 224, 224], ~4 a SM.
// - klen is a template parameter (every odd klen up to MAX_KLEN is
//   instantiated; the main path runs 31), the taps are kernel parameters,
//   so every FMA reads its tap from the constant bank, and every loop
//   unrolls.
// - The tile plus its klen/2 halo reaches shared memory by cp.async, all
//   copies of the block in flight at once; a copy from outside the plane
//   reads nothing and writes zero, the 'same' zero padding.
// - Sliding register windows.  The row pass gives a thread RR outputs of
//   one row: it loads RR + klen - 1 inputs once and runs RR x klen FMAs
//   on registers.  A warp spans 32 rows, and the input rows' odd pitch
//   keeps its reads free of bank conflicts.  The column pass gives a
//   thread RC outputs down one column the same way; a warp spans 32
//   neighbouring columns, so its stores to device memory are coalesced.
//
// Numerics: the contract is max |delta| < 1e-5 against the dense conv of
// gkern, which allows any summation order; each output sums its klen
// products in tap order with fmaf.
#include <cuda_runtime.h>

namespace {

constexpr int TW = 32;        // output tile width
constexpr int TH = 40;        // output tile height
constexpr int RR = 8;         // row-pass outputs a task
constexpr int RC = 5;         // column-pass outputs a task
constexpr int THREADS = TW * (TH / RC);   // one column-pass task a thread
constexpr int MAX_KLEN = 63;  // kernels/blur.py MAX_KLEN
static_assert(TH % RC == 0 && TW % RR == 0, "tile and tasks disagree");

template <int K>
struct Taps {
  float col[K];
  float row[K];
};

template <int K>
struct Tile {
  static constexpr int IH = TH + K - 1;     // input rows, halo included
  static constexpr int IW = TW + K - 1;     // input columns
  static constexpr int SIN = IW | 1;        // odd pitch: a warp reads 32 rows
  static constexpr int SMID = TW + 1;       // odd pitch, the same for writes
  static constexpr size_t SMEM = sizeof(float) * IH * (SIN + SMID);
};

// A 4-byte cp.async; src_bytes 0 reads nothing and writes zero.
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(src_bytes));
}

template <int K>
__global__ void __launch_bounds__(THREADS)
blur_kernel(const float* __restrict__ x, float* __restrict__ out, int H,
            int W, const Taps<K> taps) {
  using T = Tile<K>;
  constexpr int PAD = K / 2;
  extern __shared__ float smem[];
  float* in = smem;                   // [IH][SIN]
  float* mid = smem + T::IH * T::SIN; // [IH][SMID], after the row pass
  const size_t plane_off = (size_t)blockIdx.z * H * W;
  const float* plane = x + plane_off;
  const int y0 = blockIdx.y * TH, x0 = blockIdx.x * TW;
  const int tid = threadIdx.x;

  // 1. the input tile and its halo, zeros outside the plane
#pragma unroll 4
  for (int i = tid; i < T::IH * T::IW; i += THREADS) {
    const int r = i / T::IW, c = i - r * T::IW;
    const int gy = y0 - PAD + r, gx = x0 - PAD + c;
    const bool inside = gy >= 0 && gy < H && gx >= 0 && gx < W;
    cp_async4(in + r * T::SIN + c,
              inside ? plane + (size_t)gy * W + gx : plane, inside ? 4 : 0);
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  // 2. row pass: mid[r][c] = sum_t row[t] * in[r][c + t]
  for (int task = tid; task < T::IH * (TW / RR); task += THREADS) {
    const int r = task % T::IH, c0 = task / T::IH * RR;
    const float* src = in + r * T::SIN + c0;
    float v[RR + K - 1];
#pragma unroll
    for (int k = 0; k < RR + K - 1; ++k) v[k] = src[k];
#pragma unroll
    for (int j = 0; j < RR; ++j) {
      float acc = 0.f;
#pragma unroll
      for (int t = 0; t < K; ++t) acc = fmaf(taps.row[t], v[j + t], acc);
      mid[r * T::SMID + c0 + j] = acc;
    }
  }
  __syncthreads();

  // 3. column pass: out[r][c] = sum_t col[t] * mid[r + t][c]
  const int c = tid % TW, r0 = tid / TW * RC;
  float v[RC + K - 1];
#pragma unroll
  for (int k = 0; k < RC + K - 1; ++k) v[k] = mid[(r0 + k) * T::SMID + c];
  const int gx = x0 + c;
#pragma unroll
  for (int j = 0; j < RC; ++j) {
    float acc = 0.f;
#pragma unroll
    for (int t = 0; t < K; ++t) acc = fmaf(taps.col[t], v[j + t], acc);
    const int gy = y0 + r0 + j;
    if (gy < H && gx < W) out[plane_off + (size_t)gy * W + gx] = acc;
  }
}

template <int K>
cudaError_t launch(const float* x, float* out, const float* col,
                   const float* row, int n, int h, int w, cudaStream_t st) {
  Taps<K> taps;
  for (int t = 0; t < K; ++t) {
    taps.col[t] = col[t];
    taps.row[t] = row[t];
  }
  constexpr size_t smem = Tile<K>::SMEM;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        blur_kernel<K>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((w + TW - 1) / TW, (h + TH - 1) / TH, n);
  blur_kernel<K><<<grid, THREADS, smem, st>>>(x, out, h, w, taps);
  return cudaGetLastError();
}

// The instantiation for klen, one per odd klen up to MAX_KLEN.
template <int K>
cudaError_t dispatch(int klen, const float* x, float* out, const float* col,
                     const float* row, int n, int h, int w, cudaStream_t st) {
  if constexpr (K > MAX_KLEN) {
    return cudaErrorInvalidValue;
  } else {
    if (klen == K) return launch<K>(x, out, col, row, n, h, w, st);
    return dispatch<K + 2>(klen, x, out, col, row, n, h, w, st);
  }
}

}  // namespace

extern "C" {

const char* xai_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// x, out: [n, h, w] float32 on the device, contiguous; col, row: [klen]
// float32 taps in host memory.  The caller checks shapes and klen (odd,
// <= MAX_KLEN).
int xai_blur_planes(const void* x, void* out, const void* col,
                    const void* row, int n, int h, int w, int klen,
                    int device, void* stream) {
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  return dispatch<1>(klen, static_cast<const float*>(x),
                     static_cast<float*>(out), static_cast<const float*>(col),
                     static_cast<const float*>(row), n, h, w,
                     static_cast<cudaStream_t>(stream));
}

}  // extern "C"

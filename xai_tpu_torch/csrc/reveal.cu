// Ranked-reveal image batch: out[b, s, c, p] = flip[b, p] <= steps[s]
//                                              ? finish[b, c, p]
//                                              : start[b, c, p]
// with start, finish [B, C, H*W] float32, flip [B, H*W] int32, steps [S]
// int32 and out [B, S, C, H*W] float32 (NCHW, the model's input layout, so
// the battery never transposes it).  The single-image battery is B = 1.
//
// Replaces the Pallas TPU kernel pallas_reveal_batch / _reveal_kernel
// (xai_tpu/kernels/reveal.py), which ran one program per step with
// start, finish and flip resident in VMEM, one image at a time.
//
// Bound on the H100: bytes.  A 45-step chunk at 224x224x3 writes 27.1 MB
// an image and reads 1.4 MB, ~8.5 us at 3.35 TB/s, against one integer
// compare per element.  So the design spends nothing but stores: one
// thread per 4 consecutive pixels of one channel (16-byte loads and
// stores, neighbouring threads on neighbouring addresses), grid.y over
// steps, grid.z over images.  An image's start, finish and flip are
// re-read per step, but they are 1.4 MB and stay in the 50 MB L2.  Plain
// (not streaming) stores: the model's first convolution reads the batch
// right after; one image's chunk fits in L2, four images' (108 MB) do not.
// A scalar variant serves planes whose size is not a multiple of 4 or
// pointers that are not 16-byte aligned.
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

// n4: quads of one image (C * HW / 4), also its stride in start, finish
// and each output step; hw4: quads of one flip plane, also its stride.
__global__ void __launch_bounds__(THREADS)
reveal_vec4_kernel(const float4* __restrict__ start,
                   const float4* __restrict__ finish,
                   const int4* __restrict__ flip,
                   const int* __restrict__ steps, float4* __restrict__ out,
                   int n4, int hw4) {
  const int i = blockIdx.x * THREADS + threadIdx.x;   // quad in [C, HW/4]
  if (i >= n4) return;
  const size_t img = (size_t)blockIdx.z * n4;
  const int s = steps[blockIdx.y];
  const int4 f = flip[(size_t)blockIdx.z * hw4 + i % hw4];
  const float4 a = start[img + i];
  const float4 b = finish[img + i];
  float4 o;
  o.x = f.x <= s ? b.x : a.x;
  o.y = f.y <= s ? b.y : a.y;
  o.z = f.z <= s ? b.z : a.z;
  o.w = f.w <= s ? b.w : a.w;
  out[((size_t)blockIdx.z * gridDim.y + blockIdx.y) * n4 + i] = o;
}

// n: elements of one image (C * HW) and its stride; hw: one flip plane's.
__global__ void __launch_bounds__(THREADS)
reveal_scalar_kernel(const float* __restrict__ start,
                     const float* __restrict__ finish,
                     const int* __restrict__ flip,
                     const int* __restrict__ steps, float* __restrict__ out,
                     int n, int hw) {
  const int i = blockIdx.x * THREADS + threadIdx.x;   // element in [C, HW]
  if (i >= n) return;
  const size_t img = (size_t)blockIdx.z * n;
  const int s = steps[blockIdx.y];
  out[((size_t)blockIdx.z * gridDim.y + blockIdx.y) * n + i] =
      flip[(size_t)blockIdx.z * hw + i % hw] <= s ? finish[img + i]
                                                  : start[img + i];
}

bool aligned16(const void* p) {
  return (reinterpret_cast<std::uintptr_t>(p) & 15u) == 0;
}

}  // namespace

extern "C" {

const char* xai_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// The caller checks shapes, types, contiguity, s_count <= 65535,
// b <= 65535 and c * hw < 2^31.
int xai_reveal_batch(const void* start, const void* finish, const void* flip,
                     const void* steps, void* out, int b, int s_count, int c,
                     int hw, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* stp = static_cast<const int*>(steps);
  if (hw % 4 == 0 && aligned16(start) && aligned16(finish) &&
      aligned16(flip) && aligned16(out)) {
    const int n4 = c * hw / 4;
    const dim3 grid((n4 + THREADS - 1) / THREADS, s_count, b);
    reveal_vec4_kernel<<<grid, THREADS, 0, st>>>(
        static_cast<const float4*>(start), static_cast<const float4*>(finish),
        static_cast<const int4*>(flip), stp, static_cast<float4*>(out), n4,
        hw / 4);
  } else {
    const int n = c * hw;
    const dim3 grid((n + THREADS - 1) / THREADS, s_count, b);
    reveal_scalar_kernel<<<grid, THREADS, 0, st>>>(
        static_cast<const float*>(start), static_cast<const float*>(finish),
        static_cast<const int*>(flip), stp, static_cast<float*>(out), n, hw);
  }
  return cudaGetLastError();
}

}  // extern "C"

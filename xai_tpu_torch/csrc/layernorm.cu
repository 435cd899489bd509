// LayerNorm over the last axis of a contiguous float32 [rows, C] tensor,
// flax.linen.LayerNorm's formula as models/common.py states it:
//   mean = E[x],  var = max(0, E[x^2] - mean^2),
//   mul  = rsqrt(var + eps) * scale[c],  y = (x - mean) * mul + bias[c].
//
// Replaces no TPU kernel: XLA fused LayerNorm into one pass on the TPU; in
// eager PyTorch it was ten separate passes (two means, x * x, the variance,
// the rsqrt and its product with scale broadcast to [rows, C], x - mean,
// the product, the bias add), which read about seven and write about five
// tensors of the input's size.  This kernel is that fusion by hand.
//
// Bound on the H100: bytes.  It reads each row once and writes it once
// (2 * rows * C * 4 bytes, plus scale and bias), against ~10 FP32
// operations an element.  So the design keeps a row in registers between
// its statistics and its output: a row is one warp, each lane holding V
// float4 quads of it (V = ceil(C / 128), a template parameter the launch
// picks from C), neighbouring lanes on neighbouring quads.  Sum and sum of
// squares are each pairwise: a quad's four values, then a lane's quads,
// then one warp-shuffle tree over the lanes (xor, so every lane ends with
// the same bits), so their rounding grows with log2 C, as in torch's
// reductions; no shared memory, no second read.  At C <= 256 a lane holds
// so little that a warp takes R = 4 / V rows, all loaded before any is
// reduced, to keep enough bytes in flight per SM.  Scale and bias come
// through the read-only cache (C floats, resident in L1).
//
// Rounding: the elementwise part is the module's ops in the module's
// order, each rounded as the PyTorch op rounds (__fmul_rn, __fadd_rn and
// __fsub_rn: nvcc would otherwise contract into FMAs), the means as
// torch's CUDA mean takes them (the sum times the float 1/C), the clamp
// as torch's clamp_min (NaN passes through) and rsqrtf as torch's rsqrt.
// The result differs from the separate ops only by the order of the two
// sums.
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
constexpr unsigned FULL = 0xffffffffu;
// the widest row: 16 quads a lane
constexpr int MAX_QUADS = 16;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v = __fadd_rn(v, __shfl_xor_sync(FULL, v, off));
  }
  return v;
}

// p[0] + ... + p[N - 1], pairwise
template <int N>
__device__ __forceinline__ float pairwise(float (&p)[N]) {
#pragma unroll
  for (int w = 1; w < N; w *= 2) {
#pragma unroll
    for (int j = 0; j + w < N; j += 2 * w) p[j] = __fadd_rn(p[j], p[j + w]);
  }
  return p[0];
}

__device__ __forceinline__ float affine(float x, float mean, float rs,
                                        float s, float b) {
  return __fadd_rn(__fmul_rn(__fsub_rn(x, mean), __fmul_rn(rs, s)), b);
}

// rows: rows of the tensor; c4: quads a row (C / 4); inv_c: the float
// 1 / C.  Warp w of block k takes rows (k * WARPS + w) * R .. + R - 1.
template <int V, int R>
__global__ void __launch_bounds__(THREADS)
layernorm_kernel(const float4* __restrict__ x,
                 const float4* __restrict__ scale,
                 const float4* __restrict__ bias, float4* __restrict__ out,
                 int rows, int c4, float inv_c, float eps) {
  const int lane = threadIdx.x & 31;
  const int64_t first =
      (static_cast<int64_t>(blockIdx.x) * WARPS + threadIdx.x / 32) * R;
  float4 v[R][V];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int64_t row = first + r;
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const int q = lane + 32 * j;
      v[r][j] = (row < rows && q < c4) ? x[row * c4 + q]
                                       : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
  }
  float mean[R], rs[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    float s[V], ss[V];
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const float4 e = v[r][j];
      s[j] = __fadd_rn(__fadd_rn(e.x, e.y), __fadd_rn(e.z, e.w));
      ss[j] = __fadd_rn(
          __fadd_rn(__fmul_rn(e.x, e.x), __fmul_rn(e.y, e.y)),
          __fadd_rn(__fmul_rn(e.z, e.z), __fmul_rn(e.w, e.w)));
    }
    mean[r] = __fmul_rn(warp_sum(pairwise(s)), inv_c);
    float var = __fsub_rn(__fmul_rn(warp_sum(pairwise(ss)), inv_c),
                          __fmul_rn(mean[r], mean[r]));
    var = isnan(var) ? var : fmaxf(var, 0.0f);
    rs[r] = rsqrtf(__fadd_rn(var, eps));
  }
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const int q = lane + 32 * j;
    if (q >= c4) break;
    const float4 s = __ldg(scale + q);
    const float4 b = __ldg(bias + q);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int64_t row = first + r;
      if (row >= rows) break;
      const float4 e = v[r][j];
      float4 y;
      y.x = affine(e.x, mean[r], rs[r], s.x, b.x);
      y.y = affine(e.y, mean[r], rs[r], s.y, b.y);
      y.z = affine(e.z, mean[r], rs[r], s.z, b.z);
      y.w = affine(e.w, mean[r], rs[r], s.w, b.w);
      out[row * c4 + q] = y;
    }
  }
}

template <int V>
void launch(const void* x, const void* scale, const void* bias, void* out,
            int rows, int c4, float inv_c, float eps, cudaStream_t st) {
  constexpr int R = V >= 4 ? 1 : 4 / V;
  const int per_block = WARPS * R;
  layernorm_kernel<V, R><<<(rows + per_block - 1) / per_block, THREADS, 0,
                           st>>>(
      static_cast<const float4*>(x), static_cast<const float4*>(scale),
      static_cast<const float4*>(bias), static_cast<float4*>(out), rows, c4,
      inv_c, eps);
}

bool aligned16(const void* p) {
  return (reinterpret_cast<std::uintptr_t>(p) & 15u) == 0;
}

}  // namespace

extern "C" {

const char* xai_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// x, out [rows, c] and scale, bias [c], float32, contiguous, 16-byte
// aligned; c a multiple of 4 up to 4 * 32 * MAX_QUADS = 2048.  The caller
// checks shapes, types and contiguity.
int xai_layernorm(const void* x, const void* scale, const void* bias,
                  void* out, int rows, int c, float eps, int device,
                  void* stream) {
  if (c <= 0 || c % 4 != 0 || c > 4 * 32 * MAX_QUADS || rows < 0 ||
      !aligned16(x) || !aligned16(scale) || !aligned16(bias) ||
      !aligned16(out)) {
    return cudaErrorInvalidValue;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (rows == 0) return cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int c4 = c / 4;
  const float inv_c = 1.0f / static_cast<float>(c);
  switch ((c4 + 31) / 32) {
#define XAI_LN_CASE(V)                                                   \
  case V:                                                                \
    launch<V>(x, scale, bias, out, rows, c4, inv_c, eps, st);            \
    break;
    XAI_LN_CASE(1) XAI_LN_CASE(2) XAI_LN_CASE(3) XAI_LN_CASE(4)
    XAI_LN_CASE(5) XAI_LN_CASE(6) XAI_LN_CASE(7) XAI_LN_CASE(8)
    XAI_LN_CASE(9) XAI_LN_CASE(10) XAI_LN_CASE(11) XAI_LN_CASE(12)
    XAI_LN_CASE(13) XAI_LN_CASE(14) XAI_LN_CASE(15) XAI_LN_CASE(16)
#undef XAI_LN_CASE
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // extern "C"

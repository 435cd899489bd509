// ResNet post-convolution epilogue in one pass, NCHW float32:
//   form 0: out = relu(x * s[c] + b[c])                          (stem, bn1, bn2)
//   form 1: out = relu((x * s[c] + b[c]) + r)                    (bn3 + identity)
//   form 2: out = relu((x * s[c] + b[c]) + (d * sd[c] + bd[c]))  (bn3 + downsample)
// with x, r, d, out [N, C, H*W] and s, b, sd, bd [C].
//
// Replaces no TPU kernel: XLA fused these passes into the convolutions'
// consumers on the TPU; in eager PyTorch they were two to six separate
// elementwise passes (FoldedBN's multiply and add, the residual add, the
// ReLU clamp) of models/resnet.py.  This kernel is that fusion by hand.
//
// Bit-exact with the op sequence it replaces: every step rounds as the
// PyTorch op does, __fmul_rn then __fadd_rn (nvcc would otherwise contract
// x * s + b into an FMA), and the ReLU is torch.relu's clamp_min: NaN
// passes through, otherwise fmaxf(v, 0).
//
// Bound on the H100: bytes.  A pass reads x (and r or d) once and writes
// out once, against two to five FP32 operations an element.  So the
// design spends nothing but loads and stores: the tensor is one flat run
// of 16-byte quads, one a thread, neighbouring threads on neighbouring
// quads.  One quad a thread keeps a block's work small, so the grid's last
// wave is short: on an H100, 2 or 4 quads a thread ran 1-4 points further
// from the bound on each R101 pass of a 180-row forward, the most on the
// small 14x14 and 7x7 ones.  A quad's first element e lies in plane e / hw,
// channel (e / hw) % C; where H*W is a multiple of 4 (112^2 to 14^2
// planes) its four lanes share that channel, and on other planes (7^2)
// the lanes from hw - e % hw on lie in the next plane, whose scale and
// bias are read only then (a quad spans at most two planes: H*W >= 4).
// The scalar variant serves tensors whose element count is no multiple
// of 4, planes under 4 elements, and pointers that are not 16-byte
// aligned.  Scales and biases come through the read-only cache (C floats,
// resident in L1).
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

__device__ __forceinline__ float relu(float v) {
  return isnan(v) ? v : fmaxf(v, 0.0f);
}

// One channel's operands: its scale and bias, and in form 2 those of the
// downsample's FoldedBN.
struct Channel {
  float s, b, sd, bd;
};

template <int FORM>
__device__ __forceinline__ Channel channel(const float* __restrict__ s,
                                           const float* __restrict__ b,
                                           const float* __restrict__ sd,
                                           const float* __restrict__ bd,
                                           int c) {
  return {__ldg(s + c), __ldg(b + c), FORM == 2 ? __ldg(sd + c) : 0.0f,
          FORM == 2 ? __ldg(bd + c) : 0.0f};
}

template <int FORM>
__device__ __forceinline__ float epilogue(float x, float r, const Channel& k) {
  float y = __fadd_rn(__fmul_rn(x, k.s), k.b);
  if (FORM == 1) y = __fadd_rn(y, r);
  if (FORM == 2) y = __fadd_rn(y, __fadd_rn(__fmul_rn(r, k.sd), k.bd));
  return relu(y);
}

// n4: quads of the tensor (its elements / 4); hw: elements of one plane
// (>= 4); c: channels.  r is the residual (form 1) or the downsample
// conv's output (form 2), unread in form 0.
template <int FORM>
__global__ void __launch_bounds__(THREADS)
bn_act_vec4_kernel(const float4* __restrict__ x, const float* __restrict__ s,
                   const float* __restrict__ b, const float4* __restrict__ r,
                   const float* __restrict__ sd, const float* __restrict__ bd,
                   float4* __restrict__ out, int n4, int hw, int c) {
  const int i = blockIdx.x * THREADS + threadIdx.x;
  if (i >= n4) return;
  const float4 xq = x[i];
  const float4 rq = FORM ? r[i] : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  const int e = 4 * i;
  const int plane = e / hw;
  // lanes from `split` on lie in the next plane (split >= 4: none)
  const int split = hw - (e - plane * hw);
  const int ch = plane % c;
  const Channel k0 = channel<FORM>(s, b, sd, bd, ch);
  const Channel k1 =
      split < 4 ? channel<FORM>(s, b, sd, bd, ch + 1 == c ? 0 : ch + 1) : k0;
  float4 o;
  o.x = epilogue<FORM>(xq.x, rq.x, k0);
  o.y = epilogue<FORM>(xq.y, rq.y, split > 1 ? k0 : k1);
  o.z = epilogue<FORM>(xq.z, rq.z, split > 2 ? k0 : k1);
  o.w = epilogue<FORM>(xq.w, rq.w, split > 3 ? k0 : k1);
  out[i] = o;
}

// n: elements of the tensor; hw: one plane's; c: channels.
template <int FORM>
__global__ void __launch_bounds__(THREADS)
bn_act_scalar_kernel(const float* __restrict__ x, const float* __restrict__ s,
                     const float* __restrict__ b, const float* __restrict__ r,
                     const float* __restrict__ sd,
                     const float* __restrict__ bd, float* __restrict__ out,
                     int n, int hw, int c) {
  const int i = blockIdx.x * THREADS + threadIdx.x;
  if (i >= n) return;
  out[i] = epilogue<FORM>(x[i], FORM ? r[i] : 0.0f,
                          channel<FORM>(s, b, sd, bd, (i / hw) % c));
}

bool aligned16(const void* p) {
  return (reinterpret_cast<std::uintptr_t>(p) & 15u) == 0;
}

template <int FORM>
void launch(const void* x, const void* s, const void* b, const void* r,
            const void* sd, const void* bd, void* out, int n, int c, int hw,
            cudaStream_t st) {
  const float* sf = static_cast<const float*>(s);
  const float* bf = static_cast<const float*>(b);
  const float* sdf = static_cast<const float*>(sd);
  const float* bdf = static_cast<const float*>(bd);
  const int total = n * c * hw;
  if (total % 4 == 0 && hw >= 4 && aligned16(x) && aligned16(out) &&
      (FORM == 0 || aligned16(r))) {
    const int n4 = total / 4;
    bn_act_vec4_kernel<FORM><<<(n4 + THREADS - 1) / THREADS, THREADS, 0,
                               st>>>(
        static_cast<const float4*>(x), sf, bf, static_cast<const float4*>(r),
        sdf, bdf, static_cast<float4*>(out), n4, hw, c);
  } else {
    bn_act_scalar_kernel<FORM><<<(total + THREADS - 1) / THREADS, THREADS,
                                 0, st>>>(
        static_cast<const float*>(x), sf, bf, static_cast<const float*>(r),
        sdf, bdf, static_cast<float*>(out), total, hw, c);
  }
}

}  // namespace

extern "C" {

const char* xai_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// form 0, 1 or 2 as above; r, sd and bd may be null where the form does
// not read them.  The caller checks shapes, types, contiguity and
// n * c * hw < 2^31.
int xai_bn_act(const void* x, const void* s, const void* b, const void* r,
               const void* sd, const void* bd, void* out, int form, int n,
               int c, int hw, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (form == 0) {
    launch<0>(x, s, b, r, sd, bd, out, n, c, hw, st);
  } else if (form == 1) {
    launch<1>(x, s, b, r, sd, bd, out, n, c, hw, st);
  } else if (form == 2) {
    launch<2>(x, s, b, r, sd, bd, out, n, c, hw, st);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // extern "C"

// Fused bilinear resize + int8 quantize for Hopper (sm_90a): kernel K3.
//
// K3 resize_quantize_kernel
//   Replaces floodseg_tpu/ops/pallas_resize.py::resize_quantize_int8
//   (kernel _kernel, bf16 rounding _round_to_bf16_grid). It computes
//     clip(rint(resize_bilinear(x, (H, W), align, fast_lowp=True) / s), +-127)
//   for x (B, h, w, C) in float32 or bfloat16 -> int8 (B, H, W, C): the
//   H-axis interpolation in float32, rounded to the input dtype (round to
//   nearest even); the W-axis interpolation of those values in float32,
//   rounded to the input dtype again; IEEE division by the scale, rint
//   (half to even), clip to +-127. Each interpolation is the two taps of
//   a row of the interpolation matrix cast to the input dtype
//   (ops/resize.py::interp_taps): v0 * w0 + v1 * w1, one rounded multiply
//   each and one rounded add, no fused multiply-add, so the plain PyTorch
//   version (ops/resize_kernels.py::resize_quantize_int8_plain) gives the
//   same int8 values to the bit. The scale is read from device memory, so
//   the host never waits for it. A NaN input quantizes to -127 here.
//   Bound on an H100 SXM (3.35 TB/s): bytes. At the flow-predict shape
//   (x 24x32x32x4096 bf16 = 201.3 MB in, 24x65x65x4096 int8 = 415.3 MB
//   out) that is 0.184 ms; the arithmetic (about 3 GFLOP of float32) is a
//   quarter of that at the 67 TFLOP/s float32 rate.
//   Design: the TPU kernel does both contractions as dense matrix products
//   in VMEM because the TPU has a matrix unit and gathers badly. On Hopper
//   the resize is a stream: the grid covers (map, output row) x channel
//   chunks, and each thread owns 16 channels (one 16-byte int8 store) of
//   one output row and walks along it. The row's two source rows are fixed,
//   so the thread forms the H-interpolated value of a source column once,
//   keeps the last two in registers, and reuses them for every output
//   pixel that taps that column: a source pixel vector is loaded once for
//   each output row that taps it (about four times at the flow-predict
//   shape, the repeats mostly from the L2), and the full-resolution
//   intermediate never reaches device memory. Loads and stores are 16
//   bytes a thread, neighbouring threads on neighbouring channels, so
//   every warp access is coalesced. A channel count that is not a
//   multiple of 16 (or an unaligned pointer) takes a one-channel-a-thread
//   instantiation of the same code.
//
// C interface for ctypes: the entry returns cudaGetLastError() after its
// launch, as an int; 0 is success. The launch goes on the caller's stream
// and never synchronises. dtype: 0 = float32, 1 = bfloat16. vec: 1 = 16
// channels a thread (C a multiple of 16, pointers 16-byte aligned),
// 0 = one channel a thread. Tap tables: int32 (size, 2) source indices and
// float32 (size, 2) weights for the H axis (size H) and the W axis (size W).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;

template <typename T>
struct Num;

template <>
struct Num<float> {
  static __device__ __forceinline__ float load(const float* p) { return *p; }
  static __device__ __forceinline__ float round(float v) { return v; }
};

template <>
struct Num<__nv_bfloat16> {
  static __device__ __forceinline__ float load(const __nv_bfloat16* p) {
    return __bfloat162float(*p);
  }
  static __device__ __forceinline__ float round(float v) {
    return __bfloat162float(__float2bfloat16_rn(v));
  }
};

// V consecutive channels of one pixel as float32. V = 16 loads 16-byte
// words (2 for bf16, 4 for float32) and unpacks them with bit operations,
// so the values stay in registers.
template <typename T, int V>
__device__ __forceinline__ void load_vec(const T* p, float (&f)[V]) {
  if constexpr (V == 16) {
    constexpr int kWords = 16 * sizeof(T) / 16;
    uint32_t u[4 * kWords];
#pragma unroll
    for (int i = 0; i < kWords; ++i) {
      const uint4 w = reinterpret_cast<const uint4*>(p)[i];
      u[4 * i] = w.x;
      u[4 * i + 1] = w.y;
      u[4 * i + 2] = w.z;
      u[4 * i + 3] = w.w;
    }
    if constexpr (sizeof(T) == 2) {
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        f[2 * i] = __uint_as_float(u[i] << 16);
        f[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
      }
    } else {
#pragma unroll
      for (int i = 0; i < 16; ++i) f[i] = __uint_as_float(u[i]);
    }
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) f[i] = Num<T>::load(p + i);
  }
}

// t = round_to_T(a * wa + b * wb), channel by channel.
template <typename T, int V>
__device__ __forceinline__ void lerp(const float (&a)[V], float wa,
                                     const float (&b)[V], float wb,
                                     float (&t)[V]) {
#pragma unroll
  for (int e = 0; e < V; ++e) {
    t[e] = Num<T>::round(__fadd_rn(__fmul_rn(a[e], wa), __fmul_rn(b[e], wb)));
  }
}

__device__ __forceinline__ int quantize(float v, float s) {
  const float q = fminf(fmaxf(rintf(__fdiv_rn(v, s)), -127.0f), 127.0f);
  return __float2int_rn(q);
}

template <int V>
__device__ __forceinline__ void store_int8(int8_t* o, const int (&q)[V]) {
  if constexpr (V == 16) {
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      w[i] = (uint32_t)(q[4 * i] & 0xff) | ((uint32_t)(q[4 * i + 1] & 0xff) << 8) |
             ((uint32_t)(q[4 * i + 2] & 0xff) << 16) |
             ((uint32_t)(q[4 * i + 3] & 0xff) << 24);
    }
    *reinterpret_cast<uint4*>(o) = make_uint4(w[0], w[1], w[2], w[3]);
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) o[i] = (int8_t)q[i];
  }
}

template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
resize_quantize_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                       const int* __restrict__ h_idx, const float* __restrict__ h_w,
                       const int* __restrict__ w_idx, const float* __restrict__ w_w,
                       int8_t* __restrict__ out, int h, int w, int c, int hh,
                       int ww) {
  const int nv = c / V;
  const int v = blockIdx.y * kThreads + threadIdx.x;
  if (v >= nv) return;
  const int bi = blockIdx.x / hh;
  const int y = blockIdx.x - bi * hh;
  const float s = *scale;
  const float wy0 = h_w[2 * y], wy1 = h_w[2 * y + 1];
  const size_t ch = (size_t)v * V;
  const T* row0 = x + ((size_t)bi * h + h_idx[2 * y]) * w * c + ch;
  const T* row1 = x + ((size_t)bi * h + h_idx[2 * y + 1]) * w * c + ch;
  int8_t* o = out + ((size_t)bi * hh + y) * ww * c + ch;

  // the H-interpolated values of the last two source columns used
  float ta[V], tb[V];
  int ca = -1, cb = -1;
  for (int X = 0; X < ww; ++X) {
    const int c0 = w_idx[2 * X], c1 = w_idx[2 * X + 1];
    if (c0 != ca) {
      if (c0 == cb) {
#pragma unroll
        for (int e = 0; e < V; ++e) ta[e] = tb[e];
      } else {
        float a[V], b[V];
        load_vec<T, V>(row0 + (size_t)c0 * c, a);
        load_vec<T, V>(row1 + (size_t)c0 * c, b);
        lerp<T, V>(a, wy0, b, wy1, ta);
      }
      ca = c0;
    }
    if (c1 != cb) {
      if (c1 == ca) {
#pragma unroll
        for (int e = 0; e < V; ++e) tb[e] = ta[e];
      } else {
        float a[V], b[V];
        load_vec<T, V>(row0 + (size_t)c1 * c, a);
        load_vec<T, V>(row1 + (size_t)c1 * c, b);
        lerp<T, V>(a, wy0, b, wy1, tb);
      }
      cb = c1;
    }
    float r[V];
    lerp<T, V>(ta, w_w[2 * X], tb, w_w[2 * X + 1], r);
    int q[V];
#pragma unroll
    for (int e = 0; e < V; ++e) q[e] = quantize(r[e], s);
    store_int8<V>(o + (size_t)X * c, q);
  }
}

struct Args {
  const void* x;
  const float* scale;
  const int* h_idx;
  const float* h_w;
  const int* w_idx;
  const float* w_w;
  int8_t* out;
  int b, h, w, c, hh, ww;
  cudaStream_t stream;
};

template <typename T, int V>
cudaError_t launch(const Args& a) {
  const int nv = a.c / V;
  const dim3 grid((unsigned)(a.b * a.hh), (unsigned)((nv + kThreads - 1) / kThreads));
  resize_quantize_kernel<T, V><<<grid, kThreads, 0, a.stream>>>(
      static_cast<const T*>(a.x), a.scale, a.h_idx, a.h_w, a.w_idx, a.w_w,
      a.out, a.h, a.w, a.c, a.hh, a.ww);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_vec(int vec, const Args& a) {
  return vec ? launch<T, 16>(a) : launch<T, 1>(a);
}

}  // namespace

extern "C" int floodseg_resize_quantize(const void* x, const void* scale,
                                        const void* h_idx, const void* h_w,
                                        const void* w_idx, const void* w_w,
                                        void* out, int b, int h, int w, int c,
                                        int hh, int ww, int dtype, int vec,
                                        void* stream) {
  const Args a{x,
               static_cast<const float*>(scale),
               static_cast<const int*>(h_idx),
               static_cast<const float*>(h_w),
               static_cast<const int*>(w_idx),
               static_cast<const float*>(w_w),
               static_cast<int8_t*>(out),
               b, h, w, c, hh, ww,
               static_cast<cudaStream_t>(stream)};
  switch (dtype) {
    case 0: return (int)launch_vec<float>(vec, a);
    case 1: return (int)launch_vec<__nv_bfloat16>(vec, a);
    default: return (int)cudaErrorInvalidValue;
  }
}

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
//   the host never waits for it.
//
//   Bound on an H100 SXM (3.35 TB/s): bytes. At the flow-predict shape
//   (x 24x32x32x4096 bf16 = 201.3 MB in, 24x65x65x4096 int8 = 415.3 MB
//   out) that is 0.184 ms. The instructions come close to it: about 19 an
//   output element (the W blend, the bf16 round, the quantize and the
//   packing, about 15, and a share of the H blend) are 0.24 ms of issue for
//   the card's 132 SMs at 128 a clock and 1.98 GHz.
//
//   Design: the grid covers (map, output row) x 128-thread channel chunks;
//   each thread owns 16 channels (one 16-byte int8 store) of one output
//   row and walks along it. The row's two source rows are fixed, so the
//   thread forms the H-interpolated values of a source column once, keeps
//   the last two in registers and reuses them for every output pixel that
//   taps that column: a source pixel vector is loaded once for each output
//   row that taps it (about four times at the flow-predict shape, the
//   repeats mostly from the L2), and the full-resolution intermediate never
//   reaches device memory. Loads and stores are 16 bytes a thread,
//   neighbouring threads on neighbouring channels, so every warp access is
//   coalesced. A channel count that is not a multiple of 16 (or an
//   unaligned pointer) takes a one-channel-a-thread instantiation.
//
//   What held the first version of this kernel at 17% of its bound was the
//   arithmetic, not the walk: four operations an element on the slow
//   conversion / multi-function pipe (the IEEE divide __fdiv_rn, rintf,
//   __float2int_rn and the float to bf16 round), and the divide's FCHK
//   test, which by the SASS and the timings sends a zero dividend down a
//   called slow path, so that the post-ReLU features of the flow-predict
//   stack (many zeros) took longer than random data. The walk was not the limit: on an H100, a design that
//   issues every load before any arithmetic (two passes through a shared
//   tile) and a walk that loads one column ahead were both slower than this
//   one, and are not kept. Every element now takes full-rate operations
//   only, and no path depends on the data:
//   - The round to bf16 is integer arithmetic on the float's bits,
//     (u + 0x7fff + ((u >> 16) & 1)) & 0xffff0000, the Pallas kernel's own
//     _round_to_bf16_grid: equal to __float2bfloat16_rn on every value
//     that is not a NaN.
//   - The quotient: r = __frcp_rn(s) once a thread (s >= FLT_MIN, as
//     ops/quant.py::scale_from_absmax clamps it, so r is finite); per
//     element q0 = v * r, e = fma(-q0, s, v), q = fma(e, r, q0): the
//     correctly rounded v / s (Markstein's correction step;
//     tests/test_torch_kernels.py replays it in exact arithmetic against
//     IEEE division on every finite bf16 value at several scales).
//   - Range guard and clip in one: v is first clamped to +-b, b = 127 * s
//     rounded (at most FLT_MAX), so q0 is finite and |q| < 127.5: the clip
//     after rounding is a no-op, and a value beyond b gives +-127 as the
//     clip would.
//   - rint and the int8: q + 1.5 * 2^23 (one rounded add) holds rint(q)
//     in its low mantissa bits for |q| < 2^22, so its low byte is the
//     two's-complement int8 (ptxas packs four into a word with three byte
//     permutes).
//   NaN: the integer round turns the card's NaN, 0x7fffffff, into -0.0,
//   so in bf16 a NaN from either blend counts as -0 from there on; in
//   float32 a NaN output reaches the clamp and quantizes to -127. The plain
//   version casts NaN to int8, which PyTorch leaves undefined. Bit equality
//   with it holds for finite inputs and a finite scale s in
//   [FLT_MIN, FLT_MAX / 128].
//
// C interface for ctypes: the entry returns cudaGetLastError() after its
// launch, as an int; 0 is success. The launch goes on the caller's stream
// and never synchronises. dtype: 0 = float32, 1 = bfloat16. vec: 1 = 16
// channels a thread (C a multiple of 16, pointers 16-byte aligned),
// 0 = one channel a thread. Tap tables: int32 (size, 2) source indices and
// float32 (size, 2) weights for the H axis (size H) and the W axis (size W).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cfloat>
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
  // round to nearest even on the float's bits (the note above)
  static __device__ __forceinline__ float round(float v) {
    const uint32_t u = __float_as_uint(v);
    return __uint_as_float((u + 0x7fffu + ((u >> 16) & 1u)) & 0xffff0000u);
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

// clip(rint(v / s), +-127) with full-rate operations only (the note
// above): s, its correctly rounded reciprocal r, the clamp bound b.
struct Quantizer {
  float s, r, b;
  // -> an int whose low byte is the int8
  __device__ __forceinline__ int operator()(float v) const {
    v = fminf(fmaxf(v, -b), b);
    const float q0 = __fmul_rn(v, r);
    const float q = __fmaf_rn(__fmaf_rn(-q0, s, v), r, q0);
    return (int)__float_as_uint(__fadd_rn(q, 12582912.0f));  // + 1.5 * 2^23
  }
};

__device__ __forceinline__ Quantizer make_quantizer(float s) {
  Quantizer qz;
  qz.s = s;
  qz.r = __frcp_rn(s);
  qz.b = fminf(__fmul_rn(127.0f, s), FLT_MAX);
  return qz;
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
  const Quantizer qz = make_quantizer(*scale);
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
    for (int e = 0; e < V; ++e) q[e] = qz(r[e]);
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

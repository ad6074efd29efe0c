// Bilinear block-MV warps for Hopper (sm_90a): kernels K1 and K2.
//
// K1 grid_sample_kernel
//   Replaces floodseg_tpu/ops/pallas_warp.py::grid_sample_pallas
//   (kernel _warp_kernel, taps _taps). One bilinear warp with border
//   padding in either align mode: x (B, H, W, C) sampled at grid
//   (B, gh, gw, 2) -> (B, gh, gw, C). float32 weights, float32
//   accumulation, one rounding to the output dtype.
//   Bound on an H100 SXM (3.35 TB/s): bytes. At the flow-predict shape
//   (x 1x65x65x4096 bf16 = 34.6 MB in, 1x32x32x4096 bf16 = 8.4 MB out)
//   that is about 13 us; the arithmetic (4 multiply-adds per output
//   element, 34 MFLOP) is negligible. The block-MV and identity grids of
//   that path tap nearly every pixel of x; a sparser grid needs only the
//   pixels its taps touch, and its bound is lower.
//   Design: the TPU kernel builds a one-hot (P, H*W) matrix because the TPU
//   gathers badly; a Hopper SM gathers well, so each thread computes its
//   point's taps and makes four 16-byte channel-contiguous loads (8 bf16 or
//   4 float32 channels), neighbouring threads on neighbouring channels, so
//   every load and store of a warp is coalesced. Nothing is staged in
//   shared memory: each source row is read by at most a few points.
//
// K2 warp_chain_kernel
//   Replaces floodseg_tpu/ops/pallas_warp.py::warp_chain_pallas
//   (kernel _chain_kernel). T chained warps at grid resolution
//   (align_corners=False): out = [y0, w(y0,g0), w(w(y0,g0),g1), ...].
//   The one-hot weights of taps that coincide are summed in float32 (as the
//   TPU kernel's one-hot sum does), rounded to the state dtype, applied with
//   float32 accumulation, and the carry is rounded to the state dtype after
//   every step.
//   Bound on an H100 SXM: bytes. At the flow-predict shape (T = 23,
//   32x32 points, C = 4096, bf16) the output is 24 x 8.4 MB = 201 MB,
//   about 60 us.
//   Design: Pallas walks the T axis in order on one core and keeps the
//   carry in VMEM. Hopper blocks run in no order, so the grid covers
//   channel tiles only and a loop over T runs inside each block. The block
//   keeps its (P, c_tile) carry in shared memory for all T steps, so the
//   carry never goes back to device memory: device memory sees y0 read
//   once and every step written once. Each step gathers into registers,
//   synchronises, then writes the registers to the single shared buffer and
//   to out[t+1]. A single buffer lets the reference's 67x120 grid (8040
//   points) fit: c_tile is chosen by the host from P so the tile fits the
//   227 KB a block may use.
//
// C interface for ctypes. Every entry returns cudaGetLastError() after its
// launch, as an int; 0 is success. Launches go on the caller's stream and
// never synchronise. dtype: 0 = float32, 1 = bfloat16. vec: 1 = 16-byte
// vectors (C * itemsize a multiple of 16, pointers 16-byte aligned),
// 0 = one element at a time.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int kSampleThreads = 256;
constexpr int kChainThreads = 512;

template <typename T>
struct Num;

template <>
struct Num<float> {
  static __device__ __forceinline__ float load(float v) { return v; }
  static __device__ __forceinline__ float store(float v) { return v; }
};

template <>
struct Num<__nv_bfloat16> {
  static __device__ __forceinline__ float load(__nv_bfloat16 v) {
    return __bfloat162float(v);
  }
  static __device__ __forceinline__ __nv_bfloat16 store(float v) {
    return __float2bfloat16_rn(v);
  }
};

template <typename T, int V>
struct alignas(sizeof(T) * V) Vec {
  T v[V];
};

struct Taps {
  int idx[4];   // flat (y * w + x) source indices: (y0,x0) (y0,x1) (y1,x0) (y1,x1)
  float w[4];   // bilinear weights in the same order
};

// The tap rules of pallas_warp.py::_taps: float32 coordinates, floor, cast
// to int, clamp to the border. Every operation is rounded on its own (no
// fused multiply-add) so the plain PyTorch version reproduces it bit for bit.
__device__ __forceinline__ Taps make_taps(float gx, float gy, int h, int w,
                                          bool align) {
  float fx, fy;
  if (align) {
    fx = __fmul_rn(__fmul_rn(__fadd_rn(gx, 1.0f), 0.5f), (float)(w - 1));
    fy = __fmul_rn(__fmul_rn(__fadd_rn(gy, 1.0f), 0.5f), (float)(h - 1));
  } else {
    fx = __fmul_rn(__fsub_rn(__fmul_rn(__fadd_rn(gx, 1.0f), (float)w), 1.0f), 0.5f);
    fy = __fmul_rn(__fsub_rn(__fmul_rn(__fadd_rn(gy, 1.0f), (float)h), 1.0f), 0.5f);
  }
  const float x0f = floorf(fx);
  const float y0f = floorf(fy);
  const float wx = __fsub_rn(fx, x0f);
  const float wy = __fsub_rn(fy, y0f);
  // clamping the integer to [-1, size-1] before the +1 gives the same taps
  // as clamping after it, and the +1 cannot overflow
  const int xs = min(max((int)x0f, -1), w - 1);
  const int ys = min(max((int)y0f, -1), h - 1);
  const int x0 = max(xs, 0), x1 = min(xs + 1, w - 1);
  const int y0 = max(ys, 0), y1 = min(ys + 1, h - 1);
  const float ux = __fsub_rn(1.0f, wx);
  const float uy = __fsub_rn(1.0f, wy);
  Taps t;
  t.idx[0] = y0 * w + x0;
  t.idx[1] = y0 * w + x1;
  t.idx[2] = y1 * w + x0;
  t.idx[3] = y1 * w + x1;
  t.w[0] = __fmul_rn(ux, uy);
  t.w[1] = __fmul_rn(wx, uy);
  t.w[2] = __fmul_rn(ux, wy);
  t.w[3] = __fmul_rn(wx, wy);
  return t;
}

// ((v0*w0 + v1*w1) + v2*w2) + v3*w3 in float32, rounded once.
template <typename T, int V>
__device__ __forceinline__ Vec<T, V> blend(const Vec<T, V> (&a)[4],
                                           const float (&w)[4]) {
  Vec<T, V> r;
#pragma unroll
  for (int e = 0; e < V; ++e) {
    float acc = __fmul_rn(Num<T>::load(a[0].v[e]), w[0]);
#pragma unroll
    for (int k = 1; k < 4; ++k) {
      acc = __fadd_rn(acc, __fmul_rn(Num<T>::load(a[k].v[e]), w[k]));
    }
    r.v[e] = Num<T>::store(acc);
  }
  return r;
}

// -------------------------------------------------------------------- K1

template <typename T, int V>
__global__ void __launch_bounds__(kSampleThreads)
grid_sample_kernel(const T* __restrict__ x, const float* __restrict__ grid,
                   T* __restrict__ out, int h, int w, int c, int points,
                   long long total, bool align) {
  using VT = Vec<T, V>;
  const long long item = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (item >= total) return;
  const int nv = c / V;
  const long long bp = item / nv;  // b * points + p
  const int v = (int)(item - bp * nv);
  const int b = (int)(bp / points);
  const Taps t = make_taps(grid[2 * bp], grid[2 * bp + 1], h, w, align);
  const T* src = x + (size_t)b * h * w * c + (size_t)v * V;
  VT a[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    a[k] = *reinterpret_cast<const VT*>(src + (size_t)t.idx[k] * c);
  }
  *reinterpret_cast<VT*>(out + bp * c + (size_t)v * V) = blend<T, V>(a, t.w);
}

template <typename T, int V>
cudaError_t launch_grid_sample(const void* x, const void* grid, void* out,
                               int b, int h, int w, int c, int gh, int gw,
                               bool align, cudaStream_t stream) {
  const int points = gh * gw;
  const long long total = (long long)b * points * (c / V);
  const long long blocks = (total + kSampleThreads - 1) / kSampleThreads;
  grid_sample_kernel<T, V><<<(unsigned)blocks, kSampleThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(grid),
      static_cast<T*>(out), h, w, c, points, total, align);
  return cudaGetLastError();
}

// -------------------------------------------------------------------- K2

// Sum the weights of coinciding taps into the first of them, then round to
// the state dtype: the TPU kernel's one-hot row sum, cast to state.dtype.
template <typename T>
__device__ __forceinline__ void merged_weights(const Taps& t, float (&wq)[4]) {
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    float s = 0.0f;
    bool first = true;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const bool same = t.idx[j] == t.idx[k];
      s = __fadd_rn(s, same ? t.w[j] : 0.0f);
      if (j < k && same) first = false;
    }
    wq[k] = first ? Num<T>::load(Num<T>::store(s)) : 0.0f;
  }
}

template <typename T, int V, int ITEMS>
__global__ void __launch_bounds__(kChainThreads)
warp_chain_kernel(const T* __restrict__ y0, const float* __restrict__ grids,
                  T* __restrict__ out, int steps, int gh, int gw, int c,
                  int c_tile) {
  using VT = Vec<T, V>;
  extern __shared__ __align__(16) unsigned char smem[];
  VT* carry = reinterpret_cast<VT*>(smem);  // [points][nv]
  const int points = gh * gw;
  const int nv = c_tile / V;
  const int items = points * nv;
  const size_t c0 = (size_t)blockIdx.x * c_tile;
  const size_t plane = (size_t)points * c;

  for (int it = threadIdx.x; it < items; it += blockDim.x) {
    const int p = it / nv, v = it - p * nv;
    const size_t off = (size_t)p * c + c0 + (size_t)v * V;
    const VT val = *reinterpret_cast<const VT*>(y0 + off);
    carry[it] = val;
    *reinterpret_cast<VT*>(out + off) = val;
  }
  __syncthreads();

  for (int s = 0; s < steps; ++s) {
    const float* g = grids + (size_t)s * points * 2;
    VT res[ITEMS];
#pragma unroll
    for (int i = 0; i < ITEMS; ++i) {
      const int it = threadIdx.x + i * kChainThreads;
      if (it < items) {
        const int p = it / nv, v = it - p * nv;
        const Taps t = make_taps(g[2 * p], g[2 * p + 1], gh, gw, false);
        float wq[4];
        merged_weights<T>(t, wq);
        VT a[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) a[k] = carry[t.idx[k] * nv + v];
        res[i] = blend<T, V>(a, wq);
      }
    }
    __syncthreads();
    T* o = out + (size_t)(s + 1) * plane;
#pragma unroll
    for (int i = 0; i < ITEMS; ++i) {
      const int it = threadIdx.x + i * kChainThreads;
      if (it < items) {
        const int p = it / nv, v = it - p * nv;
        carry[it] = res[i];
        *reinterpret_cast<VT*>(o + (size_t)p * c + c0 + (size_t)v * V) = res[i];
      }
    }
    __syncthreads();
  }
}

struct ChainArgs {
  const void* y0;
  const void* grids;
  void* out;
  int steps, gh, gw, c, c_tile;
  cudaStream_t stream;
};

template <typename T, int V, int ITEMS>
cudaError_t launch_chain(const ChainArgs& a) {
  const size_t smem = (size_t)a.gh * a.gw * a.c_tile * sizeof(T);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        warp_chain_kernel<T, V, ITEMS>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  warp_chain_kernel<T, V, ITEMS><<<a.c / a.c_tile, kChainThreads, smem, a.stream>>>(
      static_cast<const T*>(a.y0), static_cast<const float*>(a.grids),
      static_cast<T*>(a.out), a.steps, a.gh, a.gw, a.c, a.c_tile);
  return cudaGetLastError();
}

template <typename T, int V>
cudaError_t chain_items(int items, const ChainArgs& a) {
  switch (items) {
    case 1: return launch_chain<T, V, 1>(a);
    case 2: return launch_chain<T, V, 2>(a);
    case 4: return launch_chain<T, V, 4>(a);
    case 8: return launch_chain<T, V, 8>(a);
    case 16: return launch_chain<T, V, 16>(a);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t chain_vec(int vec, int items, const ChainArgs& a) {
  return vec ? chain_items<T, static_cast<int>(16 / sizeof(T))>(items, a)
             : chain_items<T, 1>(items, a);
}

template <typename T>
cudaError_t sample_vec(int vec, const void* x, const void* grid, void* out,
                       int b, int h, int w, int c, int gh, int gw, bool align,
                       cudaStream_t stream) {
  return vec ? launch_grid_sample<T, static_cast<int>(16 / sizeof(T))>(x, grid, out, b, h, w, c,
                                                      gh, gw, align, stream)
             : launch_grid_sample<T, 1>(x, grid, out, b, h, w, c, gh, gw,
                                        align, stream);
}

}  // namespace

extern "C" int floodseg_grid_sample(const void* x, const void* grid, void* out,
                                    int b, int h, int w, int c, int gh, int gw,
                                    int align, int dtype, int vec,
                                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return (int)sample_vec<float>(vec, x, grid, out, b, h, w, c, gh,
                                          gw, align != 0, s);
    case 1: return (int)sample_vec<__nv_bfloat16>(vec, x, grid, out, b, h, w,
                                                  c, gh, gw, align != 0, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" int floodseg_warp_chain(const void* y0, const void* grids,
                                   void* out, int steps, int gh, int gw,
                                   int c, int c_tile, int items, int dtype,
                                   int vec, void* stream) {
  const ChainArgs a{y0, grids, out, steps, gh, gw, c, c_tile,
                    static_cast<cudaStream_t>(stream)};
  switch (dtype) {
    case 0: return (int)chain_vec<float>(vec, items, a);
    case 1: return (int)chain_vec<__nv_bfloat16>(vec, items, a);
    default: return (int)cudaErrorInvalidValue;
  }
}

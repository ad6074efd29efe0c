// Bilinear block-MV warps for Hopper (sm_90a): kernels K1, K1-bwd and K2.
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
//   32x32 points, C = 4096, bf16) y0, the grids and the 24 output planes of
//   8.4 MB are 209.9 MB, 62.7 us at 3.35 TB/s. Dispatching the blend's
//   instructions (about 11.5 an output element) takes some 35 us over 128
//   SMs; the design has to overlap the two.
//   Design: Pallas walks the T axis in order on one core and keeps the
//   carry in VMEM. Hopper blocks run in no order, so the grid covers
//   channel tiles only and a loop over T runs inside each block. The block
//   keeps its (P, c_tile) carry in shared memory for all T steps, so device
//   memory sees y0 read once and every step written once.
//   The first design, on one carry, took 4.3 times the bound. What held
//   it back, and what this one does about each:
//   - Two barriers a step (gather into registers, barrier, write, barrier),
//     nothing of one phase overlapping the next, and 32 registers a thread
//     of staging. Here: two carries, read from carry[s & 1] and written to
//     carry[(s + 1) & 1]; each item's result goes from registers straight
//     to the other carry and to out[s + 1] (16-byte stores), and a step
//     ends with one barrier.
//   - Taps recomputed by each of the c_tile / V threads that share a point,
//     from a grid entry loaded from device memory right after the barrier:
//     about half of an item's instructions, and an L2 round trip on the
//     critical path. Here: a tap table a step, in shared memory: each point's
//     four source points (uint16) and merged weights (in the state dtype,
//     exact, since they are rounded to it), built once a point by one
//     thread with the same make_taps and merged_weights. The grid of step
//     s + 1 is loaded at the start of step s and its table written after
//     step s's gather, into the other of two tables. The threads of a point
//     read its entry as a shared-memory broadcast. The arithmetic is the
//     same, so the result is bit-equal.
//   - One 512-thread block a SM at the 128-register cap. Here: 1024
//     threads (at most 64 registers; a 16-channel bf16 tile at two blocks
//     a SM, 512 threads, measured slower, PERF.md).
//   One barrier a step is enough: step s writes carry[(s + 1) & 1] and
//   table[(s + 1) & 1], which were last read in step s - 1, before the
//   barrier that closed it; and what step s writes is read only in step
//   s + 1, after the barrier that closes step s. The prologue fills
//   carry[0], out[0] and table[0], then one barrier.
//   At the flow-predict shape: a 32-channel bf16 tile (16 in float32), 128
//   blocks, 2 x 128 KB of carries and 2 x 16 KB of tables (24 KB in
//   float32). The ping-pong design is taken wherever two carries and two
//   tables fit a block's 227 KB for some channel tile (up to a few
//   thousand points; uint16 indices need fewer than 65536). Larger grids,
//   such as the reference's 67x120 (8040 points, 257 KB for the narrowest
//   bf16 pair), take warp_chain_single_kernel: one carry, the taps per
//   item, and a step that writes out[s + 1], then after a barrier copies
//   each thread's items of it back into the carry, and a second barrier.
//
// K1-bwd grid_sample_backward_kernel
//   The gradient of K1 with respect to x, for training. No TPU kernel has
//   it: the JAX package trains through floodseg_tpu/ops/grid_sample.py::
//   grid_sample (the XLA gather) and lets XLA differentiate it, which
//   scatters each output point's gradient back to its four taps. Here:
//   grad_x (B, H, W, C) = sum over output points p and taps k of
//   w_k(p) * grad_out[p], added at the tap's source pixel; the grid gets no
//   gradient. The taps are K1's (make_taps), so the kernel and its plain
//   version (ops/grid_sample.py::grid_sample_backward) scatter the same
//   products; only the order of the float32 sums differs.
//   Bound on an H100 SXM (3.35 TB/s): bytes. At the training shape
//   (grad_out 2x27x27x4096 float32 = 23.9 MB in, grad_x 2x55x55x4096
//   float32 = 99.1 MB out) about 37 us; at 27x27 -> 27x27 (47.8 MB) about
//   14 us. The arithmetic (4 multiplies and 4 adds per element of grad_out)
//   is negligible.
//   Design (simple first): one thread per (output point, 16-byte channel
//   vector of grad_out), taps computed as in K1, and the four weighted
//   vectors added into a float32 accumulator with vector atomics (float4,
//   sm_90), after a cudaMemsetAsync of the accumulator. The accumulator is
//   grad_x itself in float32; in bf16 a float32 scratch buffer, rounded
//   into grad_x by one more pass (cast_kernel). The atomics make the order
//   of the sums, and so the last bits of float32 results, change from run
//   to run; a deterministic design (gather by source pixel over an
//   inverted tap list) is a later redesign.
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
constexpr int kChainThreads = 1024;

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

// ---------------------------------------------------------------- K1-bwd

// acc[0..V) += s[0..V) in device memory: float4 atomics where the vector
// allows them (16-byte aligned by the caller's vec rule), else one float.
template <int V>
__device__ __forceinline__ void atomic_add_vec(float* acc, const float (&s)[V]) {
  if constexpr (V % 4 == 0) {
#pragma unroll
    for (int e = 0; e < V; e += 4) {
      atomicAdd(reinterpret_cast<float4*>(acc + e),
                make_float4(s[e], s[e + 1], s[e + 2], s[e + 3]));
    }
  } else {
#pragma unroll
    for (int e = 0; e < V; ++e) atomicAdd(acc + e, s[e]);
  }
}

template <typename T, int V>
__global__ void __launch_bounds__(kSampleThreads)
grid_sample_backward_kernel(const T* __restrict__ grad_out,
                            const float* __restrict__ grid,
                            float* __restrict__ acc, int h, int w, int c,
                            int points, long long total, bool align) {
  using VT = Vec<T, V>;
  const long long item = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (item >= total) return;
  const int nv = c / V;
  const long long bp = item / nv;  // b * points + p
  const int v = (int)(item - bp * nv);
  const int b = (int)(bp / points);
  const Taps t = make_taps(grid[2 * bp], grid[2 * bp + 1], h, w, align);
  const VT g = *reinterpret_cast<const VT*>(grad_out + bp * c + (size_t)v * V);
  float* dst = acc + (size_t)b * h * w * c + (size_t)v * V;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    float s[V];
#pragma unroll
    for (int e = 0; e < V; ++e) s[e] = __fmul_rn(Num<T>::load(g.v[e]), t.w[k]);
    atomic_add_vec<V>(dst + (size_t)t.idx[k] * c, s);
  }
}

// out[i] = round(acc[i]) to T, V elements a thread.
template <typename T, int V>
__global__ void __launch_bounds__(kSampleThreads)
cast_kernel(const float* __restrict__ acc, T* __restrict__ out, long long n) {
  const long long i = ((long long)blockIdx.x * blockDim.x + threadIdx.x) * V;
  if (i >= n) return;
  const Vec<float, V> a = *reinterpret_cast<const Vec<float, V>*>(acc + i);
  Vec<T, V> r;
#pragma unroll
  for (int e = 0; e < V; ++e) r.v[e] = Num<T>::store(a.v[e]);
  *reinterpret_cast<Vec<T, V>*>(out + i) = r;
}

// acc: grad_x itself for float32, a float32 scratch buffer of grad_x's
// size for bf16 (then rounded into grad_x).
template <typename T, int V>
cudaError_t launch_grid_sample_backward(const void* grad_out, const void* grid,
                                        void* grad_x, void* scratch, int b,
                                        int h, int w, int c, int gh, int gw,
                                        bool align, cudaStream_t stream) {
  const bool direct = sizeof(T) == sizeof(float);
  float* acc = static_cast<float*>(direct ? grad_x : scratch);
  const long long n = (long long)b * h * w * c;
  cudaError_t e = cudaMemsetAsync(acc, 0, (size_t)n * sizeof(float), stream);
  if (e != cudaSuccess) return e;
  const int points = gh * gw;
  const long long total = (long long)b * points * (c / V);
  if (total > 0) {
    const long long blocks = (total + kSampleThreads - 1) / kSampleThreads;
    grid_sample_backward_kernel<T, V><<<(unsigned)blocks, kSampleThreads, 0, stream>>>(
        static_cast<const T*>(grad_out), static_cast<const float*>(grid), acc,
        h, w, c, points, total, align);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  if (!direct) {
    constexpr int CV = V == 1 ? 1 : 4;  // vec: C is a multiple of 8
    const long long threads = n / CV;
    const long long blocks = (threads + kSampleThreads - 1) / kSampleThreads;
    cast_kernel<T, CV><<<(unsigned)blocks, kSampleThreads, 0, stream>>>(
        acc, static_cast<T*>(grad_x), n);
  }
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

// The grid coordinates of a thread's table points for one step: points
// threadIdx.x + j * blockDim.x, j < TPT.
template <int TPT>
struct GridPoints {
  float x[TPT], y[TPT];
};

template <int TPT>
__device__ __forceinline__ void load_grid(const float* __restrict__ g,
                                          int points, GridPoints<TPT>& gp) {
#pragma unroll
  for (int j = 0; j < TPT; ++j) {
    const int p = threadIdx.x + j * blockDim.x;
    if (p < points) {
      gp.x[j] = __ldg(g + 2 * p);
      gp.y[j] = __ldg(g + 2 * p + 1);
    }
  }
}

// One table entry a point: its four source points (uint16) and their
// merged weights, already rounded to the state dtype, so storing them as T
// loses nothing.
template <typename T, int TPT>
__device__ __forceinline__ void write_taps(const GridPoints<TPT>& gp,
                                           int points, int gh, int gw,
                                           ushort4* __restrict__ idx,
                                           Vec<T, 4>* __restrict__ wgt) {
#pragma unroll
  for (int j = 0; j < TPT; ++j) {
    const int p = threadIdx.x + j * blockDim.x;
    if (p < points) {
      const Taps t = make_taps(gp.x[j], gp.y[j], gh, gw, false);
      float wq[4];
      merged_weights<T>(t, wq);
      idx[p] = make_ushort4((unsigned short)t.idx[0], (unsigned short)t.idx[1],
                            (unsigned short)t.idx[2], (unsigned short)t.idx[3]);
      Vec<T, 4> w;
#pragma unroll
      for (int k = 0; k < 4; ++k) w.v[k] = Num<T>::store(wq[k]);
      wgt[p] = w;
    }
  }
}

// The ping-pong design. Shared memory: weights [2][points], indices
// [2][points], carries [2][points][nv]. Thread i owns vector i % nv of
// points i / nv, i / nv + blockDim.x / nv, ...; blockDim.x is a multiple of
// nv. Step s reads carry[s & 1] and table[s & 1] and writes
// carry[(s + 1) & 1] and table[(s + 1) & 1].
template <typename T, int V, int TPT>
__global__ void __launch_bounds__(kChainThreads)
warp_chain_kernel(const T* __restrict__ y0, const float* __restrict__ grids,
                  T* __restrict__ out, int steps, int gh, int gw, int c,
                  int c_tile) {
  using VT = Vec<T, V>;
  using WT = Vec<T, 4>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int points = gh * gw;
  const int nv = c_tile / V;
  const int items = points * nv;
  WT* const wgt = reinterpret_cast<WT*>(smem);
  ushort4* const idx = reinterpret_cast<ushort4*>(wgt + 2 * points);
  VT* const carry = reinterpret_cast<VT*>(idx + 2 * points);
  const int v = threadIdx.x % nv;
  const int first = threadIdx.x / nv;
  const int stride = blockDim.x / nv;
  const size_t plane = (size_t)points * c;
  const T* src = y0 + (size_t)blockIdx.x * c_tile + v * V;
  T* dst = out + (size_t)blockIdx.x * c_tile + v * V;

  for (int p = first; p < points; p += stride) {
    const VT val = *reinterpret_cast<const VT*>(src + (size_t)p * c);
    carry[p * nv + v] = val;
    *reinterpret_cast<VT*>(dst + (size_t)p * c) = val;
  }
  {
    GridPoints<TPT> gp;
    load_grid<TPT>(grids, points, gp);
    write_taps<T, TPT>(gp, points, gh, gw, idx, wgt);
  }
  __syncthreads();

  for (int s = 0; s < steps; ++s) {
    const int cur = s & 1, nxt = cur ^ 1;
    // the next step's grid, loaded now so that its latency hides behind
    // this step's gather
    const bool ahead = s + 1 < steps;
    GridPoints<TPT> gp;
    if (ahead) load_grid<TPT>(grids + (size_t)(s + 1) * points * 2, points, gp);
    const VT* cin = carry + cur * items;
    VT* cnext = carry + nxt * items;
    const ushort4* ic = idx + cur * points;
    const WT* wc = wgt + cur * points;
    T* o = dst + (size_t)(s + 1) * plane;
    for (int p = first; p < points; p += stride) {
      const ushort4 ix = ic[p];  // a broadcast to the nv threads of point p
      const WT wt = wc[p];
      const float w[4] = {Num<T>::load(wt.v[0]), Num<T>::load(wt.v[1]),
                          Num<T>::load(wt.v[2]), Num<T>::load(wt.v[3])};
      VT a[4];
      a[0] = cin[ix.x * nv + v];
      a[1] = cin[ix.y * nv + v];
      a[2] = cin[ix.z * nv + v];
      a[3] = cin[ix.w * nv + v];
      const VT r = blend<T, V>(a, w);
      cnext[p * nv + v] = r;
      *reinterpret_cast<VT*>(o + (size_t)p * c) = r;
    }
    if (ahead) write_taps<T, TPT>(gp, points, gh, gw, idx + nxt * points,
                                  wgt + nxt * points);
    __syncthreads();
  }
}

// The single-buffer design, for grids whose two carries and tables do not
// fit. The threads own vectors and points as in warp_chain_kernel. Each step
// gathers from the carry and writes out[s + 1]; after a barrier, each thread
// copies its own items of out[s + 1] (just written, so in L2) back into the
// carry; a second barrier closes the step.
template <typename T, int V>
__global__ void __launch_bounds__(kChainThreads)
warp_chain_single_kernel(const T* __restrict__ y0,
                         const float* __restrict__ grids, T* __restrict__ out,
                         int steps, int gh, int gw, int c, int c_tile) {
  using VT = Vec<T, V>;
  extern __shared__ __align__(16) unsigned char smem[];
  VT* carry = reinterpret_cast<VT*>(smem);  // [points][nv]
  const int points = gh * gw;
  const int nv = c_tile / V;
  const int v = threadIdx.x % nv;
  const int first = threadIdx.x / nv;
  const int stride = blockDim.x / nv;
  const size_t plane = (size_t)points * c;
  const T* src = y0 + (size_t)blockIdx.x * c_tile + v * V;
  T* dst = out + (size_t)blockIdx.x * c_tile + v * V;

  for (int p = first; p < points; p += stride) {
    const VT val = *reinterpret_cast<const VT*>(src + (size_t)p * c);
    carry[p * nv + v] = val;
    *reinterpret_cast<VT*>(dst + (size_t)p * c) = val;
  }
  __syncthreads();

  for (int s = 0; s < steps; ++s) {
    const float* g = grids + (size_t)s * points * 2;
    T* o = dst + (size_t)(s + 1) * plane;
    for (int p = first; p < points; p += stride) {
      const Taps t = make_taps(g[2 * p], g[2 * p + 1], gh, gw, false);
      float wq[4];
      merged_weights<T>(t, wq);
      VT a[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) a[k] = carry[t.idx[k] * nv + v];
      *reinterpret_cast<VT*>(o + (size_t)p * c) = blend<T, V>(a, wq);
    }
    __syncthreads();
    for (int p = first; p < points; p += stride) {
      carry[p * nv + v] = *reinterpret_cast<const VT*>(o + (size_t)p * c);
    }
    __syncthreads();
  }
}

struct ChainArgs {
  const void* y0;
  const void* grids;
  void* out;
  int steps, gh, gw, c, c_tile, threads;
  cudaStream_t stream;
};

template <typename T, typename K>
cudaError_t launch_chain(K kernel, const ChainArgs& a, size_t smem) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  kernel<<<a.c / a.c_tile, a.threads, smem, a.stream>>>(
      static_cast<const T*>(a.y0), static_cast<const float*>(a.grids),
      static_cast<T*>(a.out), a.steps, a.gh, a.gw, a.c, a.c_tile);
  return cudaGetLastError();
}

template <typename T, int V, int TPT>
cudaError_t launch_pingpong(const ChainArgs& a) {
  const size_t per_point =
      sizeof(Vec<T, 4>) + sizeof(ushort4) + (size_t)a.c_tile * sizeof(T);
  return launch_chain<T>(warp_chain_kernel<T, V, TPT>, a,
                         2 * (size_t)a.gh * a.gw * per_point);
}

// table_points: 0 takes the single-buffer design; 1, 2, 4 or 8 the
// ping-pong design with that many tap-table points a thread.
template <typename T, int V>
cudaError_t chain_design(int table_points, const ChainArgs& a) {
  const int nv = a.c_tile / V;
  if (a.threads < nv || a.threads > kChainThreads || a.threads % nv) {
    return cudaErrorInvalidValue;
  }
  switch (table_points) {
    case 0:
      return launch_chain<T>(warp_chain_single_kernel<T, V>, a,
                             (size_t)a.gh * a.gw * a.c_tile * sizeof(T));
    case 1: return launch_pingpong<T, V, 1>(a);
    case 2: return launch_pingpong<T, V, 2>(a);
    case 4: return launch_pingpong<T, V, 4>(a);
    case 8: return launch_pingpong<T, V, 8>(a);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t chain_vec(int vec, int table_points, const ChainArgs& a) {
  return vec ? chain_design<T, static_cast<int>(16 / sizeof(T))>(table_points, a)
             : chain_design<T, 1>(table_points, a);
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

template <typename T>
cudaError_t sample_backward_vec(int vec, const void* grad_out, const void* grid,
                                void* grad_x, void* scratch, int b, int h, int w,
                                int c, int gh, int gw, bool align,
                                cudaStream_t stream) {
  return vec ? launch_grid_sample_backward<T, static_cast<int>(16 / sizeof(T))>(
                   grad_out, grid, grad_x, scratch, b, h, w, c, gh, gw, align, stream)
             : launch_grid_sample_backward<T, 1>(grad_out, grid, grad_x, scratch, b,
                                                 h, w, c, gh, gw, align, stream);
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
                                   int c, int c_tile, int threads,
                                   int table_points, int dtype, int vec,
                                   void* stream) {
  const ChainArgs a{y0, grids, out, steps, gh, gw, c, c_tile, threads,
                    static_cast<cudaStream_t>(stream)};
  switch (dtype) {
    case 0: return (int)chain_vec<float>(vec, table_points, a);
    case 1: return (int)chain_vec<__nv_bfloat16>(vec, table_points, a);
    default: return (int)cudaErrorInvalidValue;
  }
}

// K1-bwd. scratch: a float32 buffer of grad_x's size for bf16 (dtype 1),
// unused (may be null) for float32.
extern "C" int floodseg_grid_sample_backward(const void* grad_out,
                                             const void* grid, void* grad_x,
                                             void* scratch, int b, int h, int w,
                                             int c, int gh, int gw, int align,
                                             int dtype, int vec, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return (int)sample_backward_vec<float>(vec, grad_out, grid, grad_x,
                                                   scratch, b, h, w, c, gh, gw,
                                                   align != 0, s);
    case 1: return (int)sample_backward_vec<__nv_bfloat16>(
                vec, grad_out, grid, grad_x, scratch, b, h, w, c, gh, gw,
                align != 0, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

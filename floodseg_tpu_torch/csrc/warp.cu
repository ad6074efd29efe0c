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
// K1-bwd grid_sample_backward_index_kernel + grid_sample_backward_gather_kernel
//   The gradient of K1 with respect to x, for training. No TPU kernel has
//   it: the JAX package trains through floodseg_tpu/ops/grid_sample.py::
//   grid_sample (the XLA gather) and lets XLA differentiate it, which
//   scatters each output point's gradient back to its four taps. Here:
//   grad_x (B, H, W, C) = sum over output points p and taps k of
//   w_k(p) * grad_out[p], added at the tap's source pixel; the grid gets no
//   gradient. The taps are K1's (make_taps).
//   Contract: bit-equal to the plain version (ops/grid_sample.py::
//   grid_sample_backward, index_add_ on the CPU), and so the same from run
//   to run. The plain version adds tap 0, 1, 2 and 3 in turn, each over
//   the points in order: for a source pixel, its entries e = k * P + p
//   (P points an image) in ascending order, each product w * g rounded
//   once, summed from +0.0 with one rounding an add (from +0.0, not from
//   the first product: index_add_ into zeros turns a -0.0 product into
//   +0.0), in float32; bf16 rounds the float32 sum once.
//   Bound on an H100 SXM (3.35 TB/s): bytes. grad_out read once, grad_x
//   written once, the grid read once: at the training head shape (grad_out
//   2x27x27x4096 float32 = 23.9 MB, grad_x 2x55x55x4096 = 99.1 MB) 36.7 us;
//   at 27x27 -> 27x27 (47.8 MB) 14.3 us. The arithmetic (a multiply and an
//   add for each of the four taps of an element of grad_out) is far below
//   the float32 rate.
//   Design: a gather by source pixel over an inverted tap list.
//   1. Index build, work in O(P) and nothing that scales with C. Each
//      point's taps (make_taps) give its four entries e = k * P + p, each
//      with its source pixel s and weight w_k(p). They are ordered by
//      (s, e) by a counting sort: a count per source pixel, an exclusive
//      scan into CSR offsets (H * W + 1 an image), each entry placed in its
//      pixel's bucket through an integer cursor, and then its rank inside
//      the bucket computed without atomics, as the number of the bucket's
//      entries with a smaller e. The cursors' order of placement changes
//      from run to run; the ranks, and so the list of (p, w) the gather
//      reads, do not. One block an image does all of it
//      (grid_sample_backward_index_kernel) with 7 barriers, its working
//      arrays in shared memory where they fit (up to 227 KB, some 4300
//      points onto 3000 pixels, every training shape of the repository),
//      else in a device workspace of the same layout, one slot an image:
//      the same steps, so also deterministic, and never atomics on the
//      gradient, the plain version or a raise.
//   2. Gather (grid_sample_backward_gather_kernel): one thread for each
//      16-byte vector of channels of a few consecutive pixels, neighbouring
//      threads on neighbouring channels, so loads and stores coalesce, and
//      the pixels in raster order, so the four taps of a point read its
//      grad_out row while it is in L2. A thread loads its pixels' offsets,
//      then the first entries of all its pixels and their gradient vectors
//      at once (the entries are the same for every thread of a pixel:
//      broadcast loads), before it adds any; then it sums each pixel's
//      entries in order, __fmul_rn(g[p], w) and __fadd_rn from +0.0f, and
//      stores float32, or __float2bfloat16_rn of the float32 sum, once. An
//      empty bucket stores zeros, so nothing is cleared first.
//   3. The gather is launched as a programmatic dependent of the index
//      build (cudaLaunchKernelEx, griddepcontrol): it is resident while the
//      build runs, its first 2 blocks an SM bring grad_out into L2 with one
//      bulk prefetch each (cp.async.bulk.prefetch.L2; only where grad_out
//      is 16-byte aligned, as the bulk copy needs), and every block waits
//      (griddepcontrol.wait) until the build's writes are visible. This
//      hides the launch gap between the two kernels, and grad_out's first
//      read from device memory, behind the build: 0.8-1.2 us a call for
//      the dependent launch, up to 1.9 us for the prefetch (PERF.md).
//   What still holds it back (PERF.md): the index build, 5 us of latency
//   on one SM an image whatever the channel count, which is most of the
//   ViT's time; and at the steps (4 entries a pixel) the gather reads
//   each grad_out row four times, from L2, with a chain of three loads
//   (offsets, entries, grad_out) before its first add.
//   The first design scattered each weighted vector with float4
//   atomics into a float32 accumulator cleared by cudaMemsetAsync; bf16
//   took a float32 scratch buffer and one more pass to round it. At the
//   head shape the accumulator is twice the L2, so it moved the memset's
//   99 MB, a read and a write of the accumulator for its atomics and
//   grad_out: about 321 MB against the bound's 123 MB, 0.1261 ms against
//   36.7 us. Its sums' order changed from run to run.
//
// C interface for ctypes. Every entry returns cudaGetLastError() after its
// launch, as an int; 0 is success. Launches go on the caller's stream and
// never synchronise. dtype: 0 = float32, 1 = bfloat16. vec: 1 = 16-byte
// vectors (C * itemsize a multiple of 16, pointers 16-byte aligned),
// 0 = one element at a time.

#include <cstdint>
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

constexpr int kIndexThreads = 1024;
constexpr int kGatherThreads = 256;

// One entry of the inverted tap list: an output point and its tap's weight.
struct alignas(8) BwdEntry {
  int p;
  float w;
};

// The index the gather reads. offsets: (B, S + 1) CSR offsets into
// entries: (B, 4P), ordered by (source pixel, e).
struct BwdIndex {
  int* offsets;
  BwdEntry* entries;
};

// The index build's working arrays for one image of S pixels and P
// points, in this order: source[4P], weight[4P], placed[4P] (ints and
// floats), cnt[S] (counts, then cursors), off[S + 1]. They lie in shared
// memory where they fit one block, else in a device workspace, one
// 16-byte aligned slot of this size an image.
size_t backward_layout_bytes(int points, int pixels) {
  return ((size_t)12 * 4 * points + (size_t)8 * pixels + 4 + 15) / 16 * 16;
}

// The build's scan sums: static shared memory beside the layout.
constexpr int kScanSums = 32;

// The device workspace an image for an image of S pixels and P points on
// the current device: 0 where the layout fits one block's shared memory.
size_t backward_workspace_bytes(int points, int pixels) {
  int dev = 0, optin = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) !=
          cudaSuccess) {
    optin = 0;
  }
  const size_t bytes = backward_layout_bytes(points, pixels);
  return bytes + kScanSums * sizeof(int) <= (size_t)optin ? 0 : bytes;
}

// off[i] = cnt[0] + ... + cnt[i - 1] for i in [0, n], in place if off is
// cnt. Every thread of the block calls it (blockDim.x a multiple of 32);
// sums: 32 ints of shared memory. Ends with a barrier.
__device__ void block_exclusive_scan(const int* cnt, int* off, int n, int* sums) {
  const int per = (n + blockDim.x - 1) / blockDim.x;
  const int lo = min(n, (int)threadIdx.x * per), hi = min(n, lo + per);
  int own = 0;
  for (int i = lo; i < hi; ++i) own += cnt[i];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int inc = own;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, inc, d);
    if (lane >= d) inc += y;
  }
  if (lane == 31) sums[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    const int warps = blockDim.x >> 5;
    int v = lane < warps ? sums[lane] : 0;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, v, d);
      if (lane >= d) v += y;
    }
    if (lane < warps) sums[lane] = v;
  }
  __syncthreads();
  int run = inc - own + (warp ? sums[warp - 1] : 0);
  for (int i = lo; i < hi; ++i) {  // off may be cnt
    const int t = cnt[i];
    off[i] = run;
    run += t;
  }
  if (threadIdx.x == blockDim.x - 1) off[n] = run;  // its chunk ends at n
  __syncthreads();
}

// Entry e's rank inside its bucket placed[lo, hi): the number of the
// bucket's entries with a smaller e. Its place in the ordered list is lo
// plus its rank, whatever order the cursor placed the bucket in.
__device__ __forceinline__ int bucket_rank(const int* placed, int lo, int hi, int e) {
  int r = 0;
#pragma unroll 4
  for (int i = lo; i < hi; ++i) r += placed[i] < e;
  return r;
}

// Block b builds image b's index in its working arrays
// (backward_layout_bytes): in dynamic shared memory (kShared), or in its
// slot of the device workspace. A barrier makes either visible to the
// whole block.
template <bool kShared>
__global__ void __launch_bounds__(kIndexThreads)
grid_sample_backward_index_kernel(const float* __restrict__ grid, int h, int w, int points,
                                  bool align, BwdIndex index, unsigned char* workspace,
                                  size_t slot) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int sums[kScanSums];
  asm volatile("griddepcontrol.launch_dependents;");  // the gather may launch
  const int S = h * w, E = 4 * points;
  unsigned char* base = kShared ? smem : workspace + blockIdx.x * slot;
  int* source = reinterpret_cast<int*>(base);
  float* weight = reinterpret_cast<float*>(source + E);
  int* placed = reinterpret_cast<int*>(weight + E);
  int* cnt = placed + E;
  int* off = cnt + S;
  const float* g = grid + (size_t)blockIdx.x * points * 2;
  for (int s = threadIdx.x; s < S; s += blockDim.x) cnt[s] = 0;
  for (int p = threadIdx.x; p < points; p += blockDim.x) {
    const Taps t = make_taps(g[2 * p], g[2 * p + 1], h, w, align);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      source[k * points + p] = t.idx[k];
      weight[k * points + p] = t.w[k];
    }
  }
  __syncthreads();
  for (int e = threadIdx.x; e < E; e += blockDim.x) atomicAdd(&cnt[source[e]], 1);
  __syncthreads();
  block_exclusive_scan(cnt, off, S, sums);
  int* goff = index.offsets + (size_t)blockIdx.x * (S + 1);
  for (int s = threadIdx.x; s <= S; s += blockDim.x) {
    goff[s] = off[s];
    if (s < S) cnt[s] = off[s];
  }
  __syncthreads();
  for (int e = threadIdx.x; e < E; e += blockDim.x) {
    placed[atomicAdd(&cnt[source[e]], 1)] = e;
  }
  __syncthreads();
  BwdEntry* out = index.entries + (size_t)blockIdx.x * E;
  for (int q = threadIdx.x; q < E; q += blockDim.x) {
    const int e = placed[q];
    const int s = source[e];
    out[off[s] + bucket_rank(placed, off[s], off[s + 1], e)] = BwdEntry{e % points, weight[e]};
  }
}

// The gather. A thread owns one 16-byte vector of channels of PPT
// consecutive pixels of an image; it loads the first D entries of each of
// them, and their gradient vectors, before it adds any (PPT * D loads in
// flight a thread), then sums each pixel in entry order and stores it.
// Launched as a programmatic dependent of the index build: until the
// build's writes are visible (griddepcontrol.wait), the first prefetchers
// blocks bring grad_out into L2, where its address is 16-byte aligned, as
// a bulk prefetch needs (the one-element route's grad_out may not be).
template <typename T, int V, int PPT, int D>
__global__ void __launch_bounds__(kGatherThreads)
grid_sample_backward_gather_kernel(const T* __restrict__ grad_out,
                                   const int* __restrict__ offsets,
                                   const BwdEntry* __restrict__ entries,
                                   T* __restrict__ grad_x, int pixels, int c,
                                   int points, int groups, long long total,
                                   int prefetchers, unsigned prefetch_bytes,
                                   long long grad_out_bytes) {
  using VT = Vec<T, V>;
  const bool aligned = (reinterpret_cast<uintptr_t>(grad_out) & 15) == 0;
  if (aligned && (int)blockIdx.x < prefetchers) {
    const long long at = (long long)blockIdx.x * prefetch_bytes;  // a multiple of 16
    const unsigned n = (unsigned)min((long long)prefetch_bytes, grad_out_bytes - at) & ~15u;
    if (threadIdx.x == 0 && at < grad_out_bytes && n > 0) {
      asm volatile("cp.async.bulk.prefetch.L2.global [%0], %1;"
                   :: "l"(reinterpret_cast<const char*>(grad_out) + at), "r"(n) : "memory");
    }
  }
  asm volatile("griddepcontrol.wait;" ::: "memory");
  const long long item = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (item >= total) return;
  const int nv = c / V;
  const long long bg = item / nv;  // b * groups + group
  const int v = (int)(item - bg * nv);
  const long long b = bg / groups;
  const int s0 = (int)(bg - b * groups) * PPT;
  const int n = min(PPT, pixels - s0);
  const int* off = offsets + b * (pixels + 1) + s0;
  int bound[PPT + 1];
#pragma unroll
  for (int j = 0; j <= PPT; ++j) bound[j] = __ldg(off + min(j, n));
  const BwdEntry* ent = entries + b * 4 * points;
  const T* g = grad_out + b * points * c + (size_t)v * V;
  T* dst = grad_x + (b * pixels + s0) * c + (size_t)v * V;
  int2 pw[PPT][D];
  VT x[PPT][D];
#pragma unroll
  for (int j = 0; j < PPT; ++j) {
#pragma unroll
    for (int d = 0; d < D; ++d) {
      if (bound[j] + d < bound[j + 1]) {
        pw[j][d] = __ldg(reinterpret_cast<const int2*>(ent + bound[j] + d));
      }
    }
  }
#pragma unroll
  for (int j = 0; j < PPT; ++j) {
#pragma unroll
    for (int d = 0; d < D; ++d) {
      if (bound[j] + d < bound[j + 1]) {
        x[j][d] = *reinterpret_cast<const VT*>(g + (size_t)pw[j][d].x * c);
      }
    }
  }
#pragma unroll
  for (int j = 0; j < PPT; ++j) {
    if (j < n) {
      float acc[V];
#pragma unroll
      for (int e = 0; e < V; ++e) acc[e] = 0.0f;
#pragma unroll
      for (int d = 0; d < D; ++d) {
        if (bound[j] + d < bound[j + 1]) {
          const float wt = __int_as_float(pw[j][d].y);
#pragma unroll
          for (int e = 0; e < V; ++e) {
            acc[e] = __fadd_rn(acc[e], __fmul_rn(Num<T>::load(x[j][d].v[e]), wt));
          }
        }
      }
#pragma unroll 4
      for (int i = bound[j] + D; i < bound[j + 1]; ++i) {
        const int2 q = __ldg(reinterpret_cast<const int2*>(ent + i));
        const float wt = __int_as_float(q.y);
        const VT y = *reinterpret_cast<const VT*>(g + (size_t)q.x * c);
#pragma unroll
        for (int e = 0; e < V; ++e) acc[e] = __fadd_rn(acc[e], __fmul_rn(Num<T>::load(y.v[e]), wt));
      }
      VT r;
#pragma unroll
      for (int e = 0; e < V; ++e) r.v[e] = Num<T>::store(acc[e]);
      *reinterpret_cast<VT*>(dst + (size_t)j * c) = r;
    }
  }
}

// One block an image; the working arrays in shared memory, or, where
// backward_workspace_bytes is not 0, in workspace (that many bytes an
// image).
cudaError_t build_backward_index(const float* grid, int b, int h, int w, int points,
                                 bool align, const BwdIndex& index, void* workspace,
                                 cudaStream_t stream) {
  const size_t slot = backward_workspace_bytes(points, h * w);
  if (slot > 0) {
    if (workspace == nullptr) return cudaErrorInvalidValue;
    grid_sample_backward_index_kernel<false><<<b, kIndexThreads, 0, stream>>>(
        grid, h, w, points, align, index, static_cast<unsigned char*>(workspace), slot);
    return cudaGetLastError();
  }
  const size_t smem = backward_layout_bytes(points, h * w);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(grid_sample_backward_index_kernel<true>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               (int)smem);
    if (e != cudaSuccess) return e;
  }
  grid_sample_backward_index_kernel<true><<<b, kIndexThreads, smem, stream>>>(
      grid, h, w, points, align, index, nullptr, 0);
  return cudaGetLastError();
}

int sm_count() {
  static int count = 0;
  if (count == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) {
      count = 132;
    }
  }
  return count;
}

template <typename T, int V, int PPT, int D>
cudaError_t launch_gather(const T* grad_out, const BwdIndex& index, T* grad_x, int b,
                          int pixels, int c, int points, cudaStream_t stream) {
  const int groups = (pixels + PPT - 1) / PPT;
  const long long total = (long long)b * groups * (c / V);
  const long long bytes = (long long)b * points * c * sizeof(T);
  // two blocks an SM share the prefetch, each a multiple of 16 bytes
  const int prefetchers = 2 * sm_count();
  const unsigned chunk = (unsigned)(((bytes + prefetchers - 1) / prefetchers + 15) / 16 * 16);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)((total + kGatherThreads - 1) / kGatherThreads));
  cfg.blockDim = dim3(kGatherThreads);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, grid_sample_backward_gather_kernel<T, V, PPT, D>, grad_out,
                            (const int*)index.offsets, (const BwdEntry*)index.entries, grad_x,
                            pixels, c, points, groups, total, prefetchers, chunk, bytes);
}

// The gather's pixels a thread, PPT, and entries of each loaded ahead, D,
// from k, the entries a pixel on average (4P / S): 4 pixels, 1 entry each,
// at the training heads (k about 1); 2 pixels, 1 entry each, at the steps
// (k = 4; the rest in the loop: more registers a thread cost more
// occupancy than they won on the card); 1 pixel, 4 entries, at the ViT's
// up-sampling head (k = 16).
template <typename T, int V>
cudaError_t launch_grid_sample_backward(const void* grad_out, const void* grid,
                                        void* grad_x, const BwdIndex& index,
                                        void* workspace, int b, int h, int w, int c,
                                        int gh, int gw, bool align, cudaStream_t stream) {
  const int points = gh * gw, pixels = h * w;
  const T* go = static_cast<const T*>(grad_out);
  T* gx = static_cast<T*>(grad_x);
  cudaError_t e = build_backward_index(static_cast<const float*>(grid), b, h, w, points,
                                       align, index, workspace, stream);
  if (e != cudaSuccess) return e;
  const long long k = (4LL * points + pixels - 1) / pixels;
  if (k <= 1) e = launch_gather<T, V, 4, 1>(go, index, gx, b, pixels, c, points, stream);
  else if (k <= 4) e = launch_gather<T, V, 2, 1>(go, index, gx, b, pixels, c, points, stream);
  else e = launch_gather<T, V, 1, 4>(go, index, gx, b, pixels, c, points, stream);
  if (e != cudaSuccess) return e;
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
                                void* grad_x, const BwdIndex& index, void* workspace,
                                int b, int h, int w, int c, int gh, int gw, bool align,
                                cudaStream_t stream) {
  return vec ? launch_grid_sample_backward<T, static_cast<int>(16 / sizeof(T))>(
                   grad_out, grid, grad_x, index, workspace, b, h, w, c, gh, gw, align,
                   stream)
             : launch_grid_sample_backward<T, 1>(grad_out, grid, grad_x, index, workspace,
                                                 b, h, w, c, gh, gw, align, stream);
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

// K1-bwd's device workspace in bytes for B images of H x W pixels and
// gh x gw points: 0 where the index build's working arrays fit one
// block's shared memory on the current device.
extern "C" long long floodseg_grid_sample_backward_workspace(int b, int h, int w, int gh,
                                                             int gw) {
  return (long long)b * (long long)backward_workspace_bytes(gh * gw, h * w);
}

// K1-bwd. offsets: int32 (B, H * W + 1); entries: int32 (B, 4 * gh * gw, 2),
// 8-byte aligned; workspace: floodseg_grid_sample_backward_workspace's
// bytes, 16-byte aligned (null where that is 0).
extern "C" int floodseg_grid_sample_backward(const void* grad_out, const void* grid,
                                             void* grad_x, void* offsets, void* entries,
                                             void* workspace, int b, int h, int w, int c,
                                             int gh, int gw, int align, int dtype, int vec,
                                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const BwdIndex index{static_cast<int*>(offsets), static_cast<BwdEntry*>(entries)};
  switch (dtype) {
    case 0: return (int)sample_backward_vec<float>(vec, grad_out, grid, grad_x, index,
                                                   workspace, b, h, w, c, gh, gw,
                                                   align != 0, s);
    case 1: return (int)sample_backward_vec<__nv_bfloat16>(
                vec, grad_out, grid, grad_x, index, workspace, b, h, w, c, gh, gw,
                align != 0, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

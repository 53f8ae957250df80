// MATCHA gossip-axpy for Hopper (sm_90a):  out = x + alpha * (y - x).
//
// Replaces src/repro/kernels/gossip_axpy.py::gossip_axpy, the Pallas TPU
// kernel that lands the consensus update of every decentralized train step
// (x: a node's parameters, y: its fp32 gossip target, alpha: the plan's
// constant from MATCHA's Lemma 1).
//
// What bounds it on this card: device memory. Each element is read once
// from x and once from y and written once: 12 bytes for fp32 x and y,
// 8 for bf16 x and y, 10 for bf16 x with an fp32 y, against 3 flops and no
// tensor-core work, far below the H100's ~295 flops per byte ridge.
//
// The design: each block takes one contiguous tile of kThreads x kUnroll
// 16-byte vectors (a float4, or 8 bf16 values, per operand and thread),
// and the grid has as many blocks as there are tiles, so the blocks that
// run at one time stream through one contiguous stretch of memory. Each
// thread issues all kUnroll loads of x and y of its tile before any
// arithmetic or store (kUnroll vectors per operand in flight however out
// aliases x), with the streaming hint (ld.global.cs / st.global.cs: every
// byte is touched once); x is never read through the non-coherent path
// (ld.global.nc), since the in-place update writes it. Neighbouring
// threads touch neighbouring vectors.
//
// What the card showed (NVIDIA H100 80GB HBM3, 700 W;
// tools/gossip_axpy_designs.py, numbers in PERF.md): the first design, a
// grid-stride loop over 8 resident blocks per SM, reached 86-88% of the
// byte bound against torch.lerp's 91-92%, and more vectors in flight per
// thread or TMA bulk copies through shared memory did not close the gap
// while the grid stayed persistent; one tile per block did, at 1, 2, 4 or
// 8 vectors a thread alike.
//
// Numerics: the update is computed in fp32 with __fsub_rn, __fmul_rn and
// __fadd_rn, so nvcc cannot contract it into an FMA. The result therefore
// equals the plain PyTorch version, (x.float() + alpha * (y.float() -
// x.float())).to(x.dtype), bit for bit; the bf16 store rounds to nearest
// even, as torch's cast does.
//
// Shapes and alignment: no padding to tiles (the TPU kernel's pad and
// slice are not carried over). A scalar head runs up to x's first 16-byte
// boundary and a scalar tail after the last whole vector; if y or out is
// misaligned differently from x, the kernel runs a scalar loop instead.
// out may alias x (the in-place consensus update): every element is read
// and then written by the same thread, and no pointer is __restrict__.

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "launch_config.cuh"

namespace {

template <typename T>
struct Elem;

template <>
struct Elem<float> {
  static __device__ __forceinline__ float load(float v) { return v; }
  static __device__ __forceinline__ float store(float v) { return v; }
};

template <>
struct Elem<__nv_bfloat16> {
  static __device__ __forceinline__ float load(__nv_bfloat16 v) {
    return __bfloat162float(v);
  }
  static __device__ __forceinline__ __nv_bfloat16 store(float v) {
    return __float2bfloat16_rn(v);
  }
};

__device__ __forceinline__ float axpy(float x, float y, float alpha) {
  return __fadd_rn(x, __fmul_rn(alpha, __fsub_rn(y, x)));
}

// N elements starting at a 16-byte aligned p, as 16-byte chunks.
template <typename T, int N>
__device__ __forceinline__ void load_vec(const T* p, float (&v)[N]) {
  constexpr int kPer = 16 / sizeof(T);
  static_assert(N % kPer == 0, "vector must be whole 16-byte chunks");
#pragma unroll
  for (int c = 0; c < N / kPer; ++c) {
    const uint4 raw = __ldcs(reinterpret_cast<const uint4*>(p + c * kPer));
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int k = 0; k < kPer; ++k) v[c * kPer + k] = Elem<T>::load(e[k]);
  }
}

template <typename T, int N>
__device__ __forceinline__ void store_vec(T* p, const float (&v)[N]) {
  constexpr int kPer = 16 / sizeof(T);
#pragma unroll
  for (int c = 0; c < N / kPer; ++c) {
    uint4 raw;
    T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
    for (int k = 0; k < kPer; ++k) e[k] = Elem<T>::store(v[c * kPer + k]);
    __stcs(reinterpret_cast<uint4*>(p + c * kPer), raw);
  }
}

constexpr int kThreads = 256;
constexpr int kUnroll = 4;   // vectors in flight per operand and thread

// Elements per vector: one 16-byte vector of the narrower operand (8 when
// either is bf16, else 4).
template <typename TX, typename TY>
struct VecWidth {
  static constexpr int value = (sizeof(TX) == 2 || sizeof(TY) == 2) ? 8 : 4;
};

// How the kernel splits the n elements, and which a block takes; the tile
// probe calls the same functions. The scalar head: elements up to x's first
// 16-byte boundary.
template <typename TX>
__device__ __forceinline__ int64_t scalar_head(const TX* x, int64_t n) {
  const uintptr_t xa = reinterpret_cast<uintptr_t>(x);
  int64_t head = static_cast<int64_t>(((16 - (xa & 15)) & 15) / sizeof(TX));
  if (head > n) head = n;
  return head;
}

// Whether y and out are 16-byte aligned where x is after its head: if not,
// the whole of n runs through the scalar loop.
template <typename TX, typename TY>
__device__ __forceinline__ bool vectors_aligned(const TY* y, const TX* out, int64_t head) {
  return (reinterpret_cast<uintptr_t>(y + head) & 15) == 0 &&
         (reinterpret_cast<uintptr_t>(out + head) & 15) == 0;
}

// The whole vectors after the head; a scalar tail follows them.
template <int kVec>
__device__ __forceinline__ int64_t whole_vectors(int64_t n, int64_t head) {
  return (n - head) / kVec;
}

// Tiles of kThreads x kUnroll vectors: the block's first tile and the step
// to its next (one tile a block, unless the grid is capped).
constexpr int64_t kTileVecs = static_cast<int64_t>(kThreads) * kUnroll;

__device__ __forceinline__ int64_t first_tile_vec() {
  return static_cast<int64_t>(blockIdx.x) * kTileVecs;
}

__device__ __forceinline__ int64_t tile_step_vecs() {
  return static_cast<int64_t>(gridDim.x) * kTileVecs;
}

template <typename TX, typename TY>
__global__ void __launch_bounds__(kThreads)
gossip_axpy_kernel(const TX* x, const TY* y, TX* out, int64_t n, float alpha) {
  constexpr int kVec = VecWidth<TX, TY>::value;
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;

  const int64_t head = scalar_head(x, n);
  const bool aligned = vectors_aligned(y, out, head);
  if (!aligned) {
    for (int64_t i = tid; i < n; i += stride) {
      out[i] = Elem<TX>::store(
          axpy(Elem<TX>::load(x[i]), Elem<TY>::load(y[i]), alpha));
    }
    return;
  }
  for (int64_t i = tid; i < head; i += stride) {
    out[i] = Elem<TX>::store(
        axpy(Elem<TX>::load(x[i]), Elem<TY>::load(y[i]), alpha));
  }
  const int64_t nvec = whole_vectors<kVec>(n, head);
  const TX* xv = x + head;
  const TY* yv = y + head;
  TX* ov = out + head;
  for (int64_t base = first_tile_vec() + threadIdx.x; base < nvec; base += tile_step_vecs()) {
    float xs[kUnroll][kVec];
    float ys[kUnroll][kVec];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t v = base + u * kThreads;
      if (v < nvec) {
        load_vec<TX, kVec>(xv + v * kVec, xs[u]);
        load_vec<TY, kVec>(yv + v * kVec, ys[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t v = base + u * kThreads;
      if (v < nvec) {
#pragma unroll
        for (int k = 0; k < kVec; ++k) xs[u][k] = axpy(xs[u][k], ys[u][k], alpha);
        store_vec<TX, kVec>(ov + v * kVec, xs[u]);
      }
    }
  }
  for (int64_t i = head + nvec * kVec + tid; i < n; i += stride) {
    out[i] = Elem<TX>::store(
        axpy(Elem<TX>::load(x[i]), Elem<TY>::load(y[i]), alpha));
  }
}

// One thread a block, on the launch's grid: the boxes of elements the
// block's threads store, through the kernel's own split. Its scalar loops
// give element lo + i to thread i % stride, so a block's runs of threads
// [t0, t0 + threads) repeat every stride; its vector tiles end where the
// whole vectors do (the kernel's v < nvec), and the scalar tail follows.
__device__ void emit_runs(int64_t lo, int64_t hi, int64_t t0, int64_t stride, int threads,
                          TileBox* boxes, int capacity, unsigned int* count) {
  for (int64_t i = lo + t0; i < hi; i += stride) {
    const int64_t end = i + threads < hi ? i + threads : hi;
    emit_box(boxes, capacity, count, blockIdx.x, 0, 0, i, 0, 0, end, 1, 1);
  }
}

template <typename TX, typename TY>
__global__ void gossip_tile_probe_kernel(const TX* x, const TY* y, const TX* out, int64_t n,
                                         int threads, TileBox* boxes, int capacity,
                                         unsigned int* count) {
  constexpr int kVec = VecWidth<TX, TY>::value;
  const int64_t t0 = static_cast<int64_t>(blockIdx.x) * threads;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * threads;
  const int64_t head = scalar_head(x, n);
  if (!vectors_aligned(y, out, head)) {
    emit_runs(0, n, t0, stride, threads, boxes, capacity, count);
    return;
  }
  emit_runs(0, head, t0, stride, threads, boxes, capacity, count);
  const int64_t nvec = whole_vectors<kVec>(n, head);
  for (int64_t v0 = first_tile_vec(); v0 < nvec; v0 += tile_step_vecs()) {
    const int64_t v1 = v0 + kTileVecs < nvec ? v0 + kTileVecs : nvec;
    emit_box(boxes, capacity, count, blockIdx.x, 0, 0, head + v0 * kVec, 0, 0,
             head + v1 * kVec, 1, 1);
  }
  emit_runs(head + nvec * kVec, n, t0, stride, threads, boxes, capacity, count);
}

// One tile of kThreads x kUnroll vectors per block; the kernel loops over
// tiles, which only matters past 2^31 - 1 blocks (the grid then covers all
// n through the loop).
template <typename TX, typename TY>
LaunchConfig config(int64_t n) {
  constexpr int kVec = VecWidth<TX, TY>::value;
  const int64_t tile = kTileVecs;
  int64_t blocks = ((n + kVec - 1) / kVec + tile - 1) / tile;
  int64_t cover = blocks * tile * kVec;
  if (blocks > 0x7fffffff) {
    blocks = 0x7fffffff;
    cover = n;
  }
  LaunchConfig c{{blocks, 1, 1}, {cover, 1, 1}, kThreads, 0, 0, 4};
  return c;
}

template <typename TX, typename TY>
cudaError_t launch(const void* x, const void* y, void* out, int64_t n,
                   float alpha, cudaStream_t stream) {
  const LaunchConfig c = config<TX, TY>(n);
  gossip_axpy_kernel<TX, TY>
      <<<static_cast<unsigned>(c.grid[0]), c.threads, c.smem_bytes, stream>>>(
          static_cast<const TX*>(x), static_cast<const TY*>(y),
          static_cast<TX*>(out), n, alpha);
  return cudaGetLastError();
}

template <typename TX, typename TY>
cudaError_t probe(const void* x, const void* y, const void* out, int64_t n, TileBox* boxes,
                  int capacity, unsigned int* count, cudaStream_t stream) {
  const LaunchConfig c = config<TX, TY>(n);
  gossip_tile_probe_kernel<TX, TY><<<static_cast<unsigned>(c.grid[0]), 1, 0, stream>>>(
      static_cast<const TX*>(x), static_cast<const TY*>(y), static_cast<const TX*>(out), n,
      c.threads, boxes, capacity, count);
  return cudaGetLastError();
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16. Returns a cudaError_t (0: ok).
extern "C" int gossip_axpy_launch(int x_dtype, int y_dtype, const void* x,
                                  const void* y, void* out, int64_t n,
                                  float alpha, void* stream) {
  if (n <= 0) return 0;
  cudaError_t err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_dtype == 0 && y_dtype == 0)
    err = launch<float, float>(x, y, out, n, alpha, s);
  else if (x_dtype == 1 && y_dtype == 1)
    err = launch<__nv_bfloat16, __nv_bfloat16>(x, y, out, n, alpha, s);
  else if (x_dtype == 1 && y_dtype == 0)
    err = launch<__nv_bfloat16, float>(x, y, out, n, alpha, s);
  else if (x_dtype == 0 && y_dtype == 1)
    err = launch<float, __nv_bfloat16>(x, y, out, n, alpha, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

// The launch configuration gossip_axpy_launch uses for n elements of these
// dtypes. Returns 0, or cudaErrorInvalidValue for an unknown dtype pair.
extern "C" int gossip_axpy_launch_config(int x_dtype, int y_dtype, int64_t n,
                                         LaunchConfig* out) {
  if (x_dtype == 0 && y_dtype == 0)
    *out = config<float, float>(n);
  else if (x_dtype == 1 && y_dtype == 1)
    *out = config<__nv_bfloat16, __nv_bfloat16>(n);
  else if (x_dtype == 1 && y_dtype == 0)
    *out = config<__nv_bfloat16, float>(n);
  else if (x_dtype == 0 && y_dtype == 1)
    *out = config<float, __nv_bfloat16>(n);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return 0;
}

// The boxes of elements gossip_axpy_launch's blocks store for these
// operands (their addresses decide the split): TileBoxes into boxes
// (device memory, room for capacity), the number found in *count (device
// memory, zeroed by the caller). Returns a cudaError_t.
extern "C" int gossip_axpy_tile_probe(int x_dtype, int y_dtype, const void* x, const void* y,
                                      const void* out, int64_t n, void* boxes, int capacity,
                                      void* count, void* stream) {
  if (n <= 0) return 0;
  TileBox* b = static_cast<TileBox*>(boxes);
  unsigned int* c = static_cast<unsigned int*>(count);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (x_dtype == 0 && y_dtype == 0)
    err = probe<float, float>(x, y, out, n, b, capacity, c, s);
  else if (x_dtype == 1 && y_dtype == 1)
    err = probe<__nv_bfloat16, __nv_bfloat16>(x, y, out, n, b, capacity, c, s);
  else if (x_dtype == 1 && y_dtype == 0)
    err = probe<__nv_bfloat16, float>(x, y, out, n, b, capacity, c, s);
  else if (x_dtype == 0 && y_dtype == 1)
    err = probe<float, __nv_bfloat16>(x, y, out, n, b, capacity, c, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

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

template <typename TX, typename TY>
__global__ void __launch_bounds__(kThreads)
gossip_axpy_kernel(const TX* x, const TY* y, TX* out, int64_t n, float alpha) {
  constexpr int kVec = VecWidth<TX, TY>::value;
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;

  const uintptr_t xa = reinterpret_cast<uintptr_t>(x);
  int64_t head = static_cast<int64_t>(((16 - (xa & 15)) & 15) / sizeof(TX));
  if (head > n) head = n;
  const bool aligned =
      (reinterpret_cast<uintptr_t>(y + head) & 15) == 0 &&
      (reinterpret_cast<uintptr_t>(out + head) & 15) == 0;
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
  const int64_t nvec = (n - head) / kVec;
  const TX* xv = x + head;
  const TY* yv = y + head;
  TX* ov = out + head;
  const int64_t tile = static_cast<int64_t>(kThreads) * kUnroll;
  for (int64_t base = static_cast<int64_t>(blockIdx.x) * tile + threadIdx.x; base < nvec;
       base += static_cast<int64_t>(gridDim.x) * tile) {
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

template <typename TX, typename TY>
cudaError_t launch(const void* x, const void* y, void* out, int64_t n,
                   float alpha, cudaStream_t stream) {
  constexpr int kVec = VecWidth<TX, TY>::value;
  // one tile of kThreads x kUnroll vectors per block (the loop over tiles
  // only matters past 2^31 - 1 blocks)
  const int64_t tile = static_cast<int64_t>(kThreads) * kUnroll;
  int64_t blocks = ((n + kVec - 1) / kVec + tile - 1) / tile;
  if (blocks > 0x7fffffff) blocks = 0x7fffffff;
  gossip_axpy_kernel<TX, TY><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      static_cast<const TX*>(x), static_cast<const TY*>(y),
      static_cast<TX*>(out), n, alpha);
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

// Designs of the fp32 gossip update out = x + alpha (y - x), kept to time
// against each other and torch.lerp on the card (tools/gossip_axpy_designs.py).
// src/repro_torch/csrc/gossip_axpy.cu ships the one that won; the others are
// the designs it was measured against. All round as the shipped kernel does
// (__fsub_rn, __fmul_rn, __fadd_rn), so each is bit-equal to the plain
// version. Operands: fp32, 16-byte aligned, n a multiple of 4.
#include <cstdint>
#include <cuda_runtime.h>
#include "hopper.cuh"

namespace {

__host__ __device__ __forceinline__ int64_t lmin(int64_t a, int64_t b) { return a < b ? a : b; }

__device__ __forceinline__ float axpy(float x, float y, float a) {
  return __fadd_rn(x, __fmul_rn(a, __fsub_rn(y, x)));
}
__device__ __forceinline__ float4 axpy4(float4 x, float4 y, float a) {
  return make_float4(axpy(x.x, y.x, a), axpy(x.y, y.y, a), axpy(x.z, y.z, a), axpy(x.w, y.w, a));
}

template <bool HINT>
__device__ __forceinline__ float4 ld(const float4* p) {
  if constexpr (HINT) return __ldcs(p); else return *p;
}
template <bool HINT>
__device__ __forceinline__ void st(float4* p, float4 v) {
  if constexpr (HINT) __stcs(p, v); else *p = v;
}

// Several vectors per thread, all loads first: U vectors of 16 bytes per
// operand and thread; PERSIST: tiles looped over a grid of the resident
// blocks, else one tile per block; HINT: ld/st.global.cs.
template <int U, bool HINT, bool PERSIST>
__global__ void __launch_bounds__(256) unroll_kernel(const float4* x, const float4* y, float4* o,
                                                     int64_t nvec, float a) {
  const int64_t tile = 256 * U;
  const int64_t step = PERSIST ? static_cast<int64_t>(gridDim.x) * tile : nvec;
  for (int64_t base = blockIdx.x * tile + threadIdx.x; base < nvec; base += step) {
    float4 xs[U], ys[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int64_t v = base + u * 256;
      if (v < nvec) { xs[u] = ld<HINT>(x + v); ys[u] = ld<HINT>(y + v); }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int64_t v = base + u * 256;
      if (v < nvec) st<HINT>(o + v, axpy4(xs[u], ys[u], a));
    }
  }
}

// The first design: one vector per thread, grid-stride over 8 blocks per SM.
__global__ void __launch_bounds__(256) stride_kernel(const float4* x, const float4* y, float4* o,
                                                     int64_t nvec, float a) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * 256;
  for (int64_t v = blockIdx.x * 256 + threadIdx.x; v < nvec; v += stride)
    o[v] = axpy4(x[v], y[v], a);
}

// TMA bulk copies (cp.async.bulk, 1-D) of x and y tiles into a ring of
// STAGES shared-memory stages under mbarriers; the result is written over
// the x tile and stored with a bulk copy; one resident block per SM walks
// its tiles. The next load into a stage waits until the bulk store of its
// previous tile has read it.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
          hopper::smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(hopper::smem_u32(bar))
      : "memory");
}
__device__ __forceinline__ void bulk_store(void* dst, const void* src, uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(dst),
               "r"(hopper::smem_u32(src)), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void bulk_commit() { asm volatile("cp.async.bulk.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}
template <int N>
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

template <int STAGES, int TILE>
__global__ void __launch_bounds__(256) tma_kernel(const float* x, const float* y, float* o,
                                                  int64_t n, float a) {
  extern __shared__ __align__(128) float sm[];
  float* xs = sm;
  float* ys = sm + STAGES * TILE;
  uint64_t* bar = reinterpret_cast<uint64_t*>(ys + STAGES * TILE);
  const int tid = threadIdx.x;
  const int64_t ntiles = (n + TILE - 1) / TILE;
  const int64_t first = blockIdx.x, stride = gridDim.x;
  const int64_t my = first < ntiles ? (ntiles - 1 - first) / stride + 1 : 0;
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) hopper::mbar_init(&bar[s], 1);
    hopper::mbar_fence_init();
  }
  __syncthreads();
  auto issue = [&](int64_t i) {
    const int s = static_cast<int>(i % STAGES);
    const int64_t e0 = (first + i * stride) * TILE;
    const uint32_t bytes = static_cast<uint32_t>(lmin(TILE, n - e0) * 4);
    hopper::mbar_arrive_expect_tx(&bar[s], 2 * bytes);
    bulk_load(xs + s * TILE, x + e0, bytes, &bar[s]);
    bulk_load(ys + s * TILE, y + e0, bytes, &bar[s]);
  };
  if (tid == 0)
    for (int64_t i = 0; i < STAGES && i < my; ++i) issue(i);
  for (int64_t i = 0; i < my; ++i) {
    const int s = static_cast<int>(i % STAGES);
    hopper::mbar_wait(&bar[s], static_cast<uint32_t>((i / STAGES) & 1));
    const int64_t e0 = (first + i * stride) * TILE;
    const int cnt = static_cast<int>(lmin(TILE, n - e0));
    float4* xv = reinterpret_cast<float4*>(xs + s * TILE);
    const float4* yv = reinterpret_cast<const float4*>(ys + s * TILE);
    for (int k = tid; k < cnt / 4; k += 256) xv[k] = axpy4(xv[k], yv[k], a);
    fence_proxy_async();
    __syncthreads();
    if (tid == 0) {
      bulk_store(o + e0, xs + s * TILE, cnt * 4);
      bulk_commit();
      if (i >= 1 && i - 1 + STAGES < my) {
        bulk_wait_read<1>();
        issue(i - 1 + STAGES);
      }
    }
  }
  if (tid == 0) bulk_wait<0>();
}

template <class K>
int resident(K k, int smem) {
  int per = 0, sms = 0, dev = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per, k, 256, smem);
  return per * sms;
}

template <int U, bool HINT, bool PERSIST>
int run_unroll(const float* x, const float* y, float* o, int64_t n, float a, cudaStream_t s) {
  const int64_t nvec = n / 4, tiles = (nvec + 256 * U - 1) / (256 * U);
  int64_t blocks = tiles;
  if (PERSIST) blocks = lmin(tiles, resident(unroll_kernel<U, HINT, PERSIST>, 0));
  unroll_kernel<U, HINT, PERSIST><<<static_cast<unsigned>(blocks), 256, 0, s>>>(
      reinterpret_cast<const float4*>(x), reinterpret_cast<const float4*>(y),
      reinterpret_cast<float4*>(o), nvec, a);
  return cudaGetLastError();
}

template <int STAGES, int TILE>
int run_tma(const float* x, const float* y, float* o, int64_t n, float a, cudaStream_t s) {
  const int smem = 2 * STAGES * TILE * 4 + STAGES * 8;
  cudaFuncSetAttribute(tma_kernel<STAGES, TILE>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  const int64_t tiles = (n + TILE - 1) / TILE;
  const int64_t blocks = lmin(tiles, resident(tma_kernel<STAGES, TILE>, smem));
  tma_kernel<STAGES, TILE><<<static_cast<unsigned>(blocks), 256, smem, s>>>(x, y, o, n, a);
  return cudaGetLastError();
}

}  // namespace

// design: see DESIGNS in gossip_axpy_designs.py. Returns a cudaError_t.
extern "C" int exp_launch(int design, const float* x, const float* y, float* o, int64_t n,
                          float a, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (design) {
    case 0: {
      int dev = 0, sms = 0;
      cudaGetDevice(&dev);
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
      const int64_t nvec = n / 4;
      int64_t blocks = lmin((nvec + 255) / 256, sms * 8);
      stride_kernel<<<static_cast<unsigned>(blocks), 256, 0, s>>>(
          reinterpret_cast<const float4*>(x), reinterpret_cast<const float4*>(y),
          reinterpret_cast<float4*>(o), nvec, a);
      return cudaGetLastError();
    }
    case 1: return run_unroll<4, true, true>(x, y, o, n, a, s);
    case 2: return run_unroll<4, false, true>(x, y, o, n, a, s);
    case 3: return run_unroll<4, false, false>(x, y, o, n, a, s);
    case 4: return run_unroll<4, true, false>(x, y, o, n, a, s);
    case 5: return run_unroll<2, false, false>(x, y, o, n, a, s);
    case 6: return run_unroll<8, false, false>(x, y, o, n, a, s);
    case 7: return run_unroll<8, true, true>(x, y, o, n, a, s);
    case 8: return run_tma<4, 4096>(x, y, o, n, a, s);
    case 9: return run_tma<3, 8192>(x, y, o, n, a, s);
    case 10: return run_tma<6, 2048>(x, y, o, n, a, s);
    case 11: return run_unroll<1, false, false>(x, y, o, n, a, s);
    default: return 1;
  }
}

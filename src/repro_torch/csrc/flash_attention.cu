// Flash attention (forward) for Hopper (sm_90a): causal / sliding-window /
// GQA, online softmax, fp32 running statistics.
//
// Replaces src/repro/kernels/flash_attention.py::flash_attention (the Pallas
// TPU kernel, pallas_call at line 202; body _flash_kernel at line 80):
//
//   out[b, i, h] = sum_j softmax_j(q_i . k_j / sqrt(hd)) v_j
//
// over the keys j that are live for query i: j < kv_len, j <= i when
// causal, i - j < window when a window is set. Query head h reads kv head
// h / (Hq / Hkv). A row with no live key is written as 0 (the TPU kernel's
// denom == 0 rule).
//
// What bounds it on this card: arithmetic. A causal prefill at the serving
// path's shapes (B 8, S 2048, 16 query heads, hd 128) does 4 * hd flops per
// live (query, key) pair, ~137 GFLOP, against ~200 MB of q, k, v and out:
// ~680 flops per byte, above the H100's ridge. This first kernel does its
// products as scalar fp32 FMAs on the CUDA cores (67 TFLOP/s peak, not the
// 989 TFLOP/s of the bf16 tensor cores; wgmma is later work), so its floor
// is ~2 ms per call, and shared-memory traffic is what keeps it above that.
//
// What the design does about it:
//   * one block of 256 threads per (q tile of 64 rows, q head, batch); the
//     block walks the k tiles itself from the window's first live tile to
//     the causal diagonal (and kv_len), which replaces the TPU's sequential
//     k grid axis and its pl.when tile skip. Blocks of the costliest q
//     tiles (the last, under a causal mask) are launched first;
//   * the Q tile stays in shared memory for the whole walk (fp32, scaled by
//     1/sqrt(hd) once, stored transposed); each k tile's K (transposed) and
//     V are loaded once into shared memory as fp32;
//   * each thread owns a 4 x 4 block of the 64 x 64 score tile and a 4 x
//     (hd/16) block of the output: 16 (resp. 4 * hd/16) FMAs per pair of
//     vector loads from shared memory. Its four rows' running max and sum
//     live in registers; a row's reductions run over the 16 lanes that
//     share it with warp shuffles;
//   * masking is per element against the row's and column's absolute
//     index, so there is no padding: the ragged q and k edges, kv_len,
//     causal and window masks all take the same path. A masked score never
//     reaches exp(): its probability is set to 0 outright, and the running
//     max starts at the finite NEG_INF, so a row that is fully masked in a
//     tile (or everywhere) stays at sum 0 and writes 0, never NaN.
//
// Shared memory: (2 * hd * 64 + 64 * hd + 64 * 64) * 4 bytes, 112 KB at
// hd 128, so the kernel opts in to more than 48 KB of dynamic shared
// memory. Head widths 32, 64 and 128 are compiled; any other width is
// refused with cudaErrorInvalidValue (the Python wrapper raises first).

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBQ = 64;
constexpr int kBK = 64;
constexpr int kThreads = 256;
constexpr float kNegInf = -1073741824.0f;  // -2**30, as in the JAX kernel

template <typename T>
struct Elem;

template <>
struct Elem<float> {
  static __device__ __forceinline__ float load(float v) { return v; }
  static __device__ __forceinline__ float store(float v) { return v; }
  // 16 bytes of T as 4 floats
  static constexpr int kPer16 = 4;
};

template <>
struct Elem<__nv_bfloat16> {
  static __device__ __forceinline__ float load(__nv_bfloat16 v) {
    return __bfloat162float(v);
  }
  static __device__ __forceinline__ __nv_bfloat16 store(float v) {
    return __float2bfloat16_rn(v);
  }
  static constexpr int kPer16 = 8;
};

// Load kPer16 consecutive elements starting at p (16-byte aligned) as
// floats; zeros when !valid.
template <typename T>
__device__ __forceinline__ void load16(const T* p, bool valid,
                                       float (&out)[Elem<T>::kPer16]) {
  constexpr int kPer = Elem<T>::kPer16;
  if (!valid) {
#pragma unroll
    for (int e = 0; e < kPer; ++e) out[e] = 0.f;
    return;
  }
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const T* v = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int e = 0; e < kPer; ++e) out[e] = Elem<T>::load(v[e]);
}

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  int B, Sq, Sk, Hq, Hkv;
  int causal, window, kv_len;  // kv_len in [0, Sk]; keys >= kv_len masked
  float sm_scale;
};

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(Params prm) {
  constexpr int kPer = Elem<T>::kPer16;
  constexpr int kCols = HD / 16;  // output columns per thread

  extern __shared__ float smem[];
  float* Qs = smem;                 // [HD][kBQ], q^T, pre-scaled
  float* Ks = Qs + HD * kBQ;        // [HD][kBK], k^T
  float* Vs = Ks + HD * kBK;        // [kBK][HD]
  float* Ps = Vs + kBK * HD;        // [kBK][kBQ], p^T

  const T* q = static_cast<const T*>(prm.q);
  const T* k = static_cast<const T*>(prm.k);
  const T* v = static_cast<const T*>(prm.v);
  T* out = static_cast<T*>(prm.out);

  const int tid = threadIdx.x;
  const int num_qt = gridDim.x;
  const int qt = num_qt - 1 - blockIdx.x;   // costliest tiles first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int group = prm.Hq / prm.Hkv;
  const int hk = h / group;
  const int q0 = qt * kBQ;

  const int64_t q_row = static_cast<int64_t>(prm.Hq) * HD;   // elements per s
  const int64_t k_row = static_cast<int64_t>(prm.Hkv) * HD;
  const T* qb = q + static_cast<int64_t>(b) * prm.Sq * q_row + h * HD;
  const T* kb = k + static_cast<int64_t>(b) * prm.Sk * k_row + hk * HD;
  const T* vb = v + static_cast<int64_t>(b) * prm.Sk * k_row + hk * HD;
  T* ob = out + static_cast<int64_t>(b) * prm.Sq * q_row + h * HD;

  // ---- Q tile -> Qs (transposed, scaled). Consecutive threads take
  // consecutive rows, so the transposed shared stores hit distinct banks.
  constexpr int kChunks = HD / kPer;  // 16-byte chunks per row
  for (int c = tid; c < kBQ * kChunks; c += kThreads) {
    const int r = c % kBQ;
    const int d0 = (c / kBQ) * kPer;
    const int qi = q0 + r;
    float vals[kPer];
    load16<T>(qb + static_cast<int64_t>(qi) * q_row + d0, qi < prm.Sq, vals);
#pragma unroll
    for (int e = 0; e < kPer; ++e) Qs[(d0 + e) * kBQ + r] = vals[e] * prm.sm_scale;
  }

  // ---- k range of this q tile
  const int kv_len = prm.kv_len;
  const int q_last = min(q0 + kBQ, prm.Sq) - 1;
  int k_end = kv_len;                            // exclusive
  if (prm.causal) k_end = min(k_end, q_last + 1);
  int k_begin = 0;
  if (prm.window > 0) k_begin = max(0, q0 - prm.window + 1);
  k_begin = (k_begin / kBK) * kBK;

  // thread's score block: rows r0..r0+3, columns c0..c0+3
  const int lane16 = tid & 15;
  const int r0 = (tid >> 4) * 4;
  const int c0 = lane16 * 4;

  float m[4], l[4], acc[4][kCols];
#pragma unroll
  for (int rr = 0; rr < 4; ++rr) {
    m[rr] = kNegInf;
    l[rr] = 0.f;
#pragma unroll
    for (int cc = 0; cc < kCols; ++cc) acc[rr][cc] = 0.f;
  }

  for (int kt0 = k_begin; kt0 < k_end; kt0 += kBK) {
    __syncthreads();  // the previous tile's readers of Ks / Vs / Ps are done
    // K tile -> Ks (transposed), rows beyond Sk as zeros
    for (int c = tid; c < kBK * kChunks; c += kThreads) {
      const int j = c % kBK;
      const int d0 = (c / kBK) * kPer;
      const int kj = kt0 + j;
      float vals[kPer];
      load16<T>(kb + static_cast<int64_t>(kj) * k_row + d0, kj < prm.Sk, vals);
#pragma unroll
      for (int e = 0; e < kPer; ++e) Ks[(d0 + e) * kBK + j] = vals[e];
    }
    // V tile -> Vs (row-major): consecutive threads along a row
    for (int c = tid; c < kBK * kChunks; c += kThreads) {
      const int j = c / kChunks;
      const int d0 = (c % kChunks) * kPer;
      const int kj = kt0 + j;
      float vals[kPer];
      load16<T>(vb + static_cast<int64_t>(kj) * k_row + d0, kj < prm.Sk, vals);
#pragma unroll
      for (int e = 0; e < kPer; ++e) Vs[j * HD + d0 + e] = vals[e];
    }
    __syncthreads();

    // ---- scores s = (q / sqrt(hd)) k^T for the thread's 4 x 4 block
    float s[4][4];
#pragma unroll
    for (int rr = 0; rr < 4; ++rr)
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) s[rr][cc] = 0.f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      const float4 qa = *reinterpret_cast<const float4*>(&Qs[d * kBQ + r0]);
      const float4 kb4 = *reinterpret_cast<const float4*>(&Ks[d * kBK + c0]);
      const float qv[4] = {qa.x, qa.y, qa.z, qa.w};
      const float kv[4] = {kb4.x, kb4.y, kb4.z, kb4.w};
#pragma unroll
      for (int rr = 0; rr < 4; ++rr)
#pragma unroll
        for (int cc = 0; cc < 4; ++cc) s[rr][cc] = fmaf(qv[rr], kv[cc], s[rr][cc]);
    }

    // ---- mask, online softmax update, p -> Ps
#pragma unroll
    for (int rr = 0; rr < 4; ++rr) {
      const int qi = q0 + r0 + rr;
      bool live[4];
      float tmax = kNegInf;
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        const int kj = kt0 + c0 + cc;
        bool ok = kj < kv_len;
        if (prm.causal) ok = ok && kj <= qi;
        if (prm.window > 0) ok = ok && (qi - kj < prm.window);
        live[cc] = ok;
        if (ok) tmax = fmaxf(tmax, s[rr][cc]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, off));
      const float m_new = fmaxf(m[rr], tmax);
      const float alpha = __expf(m[rr] - m_new);   // 1 while nothing is live
      float psum = 0.f;
      float p[4];
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        p[cc] = live[cc] ? __expf(s[rr][cc] - m_new) : 0.f;
        psum += p[cc];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        psum += __shfl_xor_sync(0xffffffffu, psum, off);
      l[rr] = l[rr] * alpha + psum;
      m[rr] = m_new;
#pragma unroll
      for (int cc = 0; cc < kCols; ++cc) acc[rr][cc] *= alpha;
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) Ps[(c0 + cc) * kBQ + r0 + rr] = p[cc];
    }
    __syncthreads();

    // ---- acc += p v: rows r0..r0+3, columns lane16 + 16 * cc
    const int j_end = min(kBK, k_end - kt0);
    for (int j = 0; j < j_end; ++j) {
      const float4 pa = *reinterpret_cast<const float4*>(&Ps[j * kBQ + r0]);
      const float pv[4] = {pa.x, pa.y, pa.z, pa.w};
      float vv[kCols];
#pragma unroll
      for (int cc = 0; cc < kCols; ++cc) vv[cc] = Vs[j * HD + lane16 + 16 * cc];
#pragma unroll
      for (int rr = 0; rr < 4; ++rr)
#pragma unroll
        for (int cc = 0; cc < kCols; ++cc) acc[rr][cc] = fmaf(pv[rr], vv[cc], acc[rr][cc]);
    }
  }

  // ---- out = acc / l; a row with no live key (l == 0) writes 0
#pragma unroll
  for (int rr = 0; rr < 4; ++rr) {
    const int qi = q0 + r0 + rr;
    if (qi >= prm.Sq) continue;
    const float inv = l[rr] == 0.f ? 0.f : 1.f / l[rr];
    T* orow = ob + static_cast<int64_t>(qi) * q_row;
#pragma unroll
    for (int cc = 0; cc < kCols; ++cc)
      orow[lane16 + 16 * cc] = Elem<T>::store(acc[rr][cc] * inv);
  }
}

template <typename T, int HD>
cudaError_t launch(const Params& prm, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(2 * HD * kBQ + kBK * HD + kBK * kBQ) *
                      sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((prm.Sq + kBQ - 1) / kBQ, prm.Hq, prm.B);
  flash_fwd_kernel<T, HD><<<grid, kThreads, smem, stream>>>(prm);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_hd(int hd, const Params& prm, cudaStream_t stream) {
  switch (hd) {
    case 32: return launch<T, 32>(prm, stream);
    case 64: return launch<T, 64>(prm, stream);
    case 128: return launch<T, 128>(prm, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype code: 0 = float32, 1 = bfloat16 (q, k, v and out alike). Tensors
// are contiguous (B, S, H, hd). kv_len <= 0 means Sk. Returns a
// cudaError_t (0: ok).
extern "C" int flash_attention_launch(int dtype, const void* q, const void* k,
                                      const void* v, void* out, int B, int Sq,
                                      int Sk, int Hq, int Hkv, int hd,
                                      int causal, int window, int kv_len,
                                      float sm_scale, void* stream) {
  if (B <= 0 || Sq <= 0 || Hq <= 0) return 0;
  if (Hkv <= 0 || Hq % Hkv != 0 || Sk < 0 || kv_len > Sk)
    return static_cast<int>(cudaErrorInvalidValue);
  Params prm{q, k, v, out, B, Sq, Sk, Hq, Hkv, causal, window,
             kv_len <= 0 ? Sk : kv_len, sm_scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return static_cast<int>(dispatch_hd<float>(hd, prm, s));
  if (dtype == 1) return static_cast<int>(dispatch_hd<__nv_bfloat16>(hd, prm, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

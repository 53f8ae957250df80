// Mamba2 SSD chunk scan for Hopper (sm_90a).
//
// Replaces src/repro/kernels/ssm_scan.py::ssm_scan (the Pallas TPU kernel,
// pallas_call at line 154; body _ssd_kernel at line 75). For each (batch b,
// head h) it runs the selective state-space recurrence chunk by chunk,
// with an fp32 (N, P) state carried from chunk to chunk. Per chunk of Q
// steps, with La_i the cumulative sum of dt * A over the chunk:
//
//   intra:  y_i  = sum_{j<=i} (C_i . B_j) exp(La_i - La_j) dt_j x_j
//   inter:  y_i += exp(La_i) (C_i . h_in)
//   state:  h_out = exp(La_Q) h_in + sum_j exp(La_Q - La_j) dt_j B_j (x) x_j
//
// Outputs: y (B, S, H, P) in x's dtype and the final state (B, H, N, P) in
// fp32. The state before the first chunk is zero.
//
// What bounds it on this card: at the serving path's shapes (B 8, S 2048,
// H 32, P 64, N 128, chunk 128) the work the function needs is ~7.4 MFLOP
// per (b, h, chunk), ~30 GFLOP per call, against ~153 MB of x, dt, B, C, y
// and the final state. Measured against the bf16 tensor-core rate that is
// bound by the bytes (~0.05 ms); this first kernel does its products as
// scalar fp32 FMAs on the CUDA cores (67 TFLOP/s peak), whose floor is
// ~0.45 ms, and shared-memory traffic keeps it above that. wgmma is later
// work.
//
// What the design does about it:
//   * one block of 256 threads per (b, h) walks the chunks in order
//     itself: on the TPU the chunk grid axis runs in order on one core,
//     on Hopper blocks run in no order, so the sequential dependency stays
//     inside one block and the state never leaves shared memory until the
//     final write. B * H blocks (256 at the serving shapes) fill 132 SMs in
//     two waves, one block per SM (its shared memory is ~211 KB);
//   * the chunk's x, B, C and dt are read once from device memory into
//     shared memory as fp32; B and C are shared by all heads, so the other
//     heads' blocks find them in L2;
//   * C B^T is built in strips of 32 rows (the full Q x Q matrix would
//     not fit beside B, C, x and the state) and only up to the strip's
//     diagonal; each strip's y rows (inter + intra) are finished before
//     the next strip;
//   * exp(La_i - La_j) is evaluated only where j <= i, so its argument is
//     never positive: no inf, and no inf * 0 = NaN where a mask would have
//     been multiplied in. A decay that underflows gives 0;
//   * every product is a small register-tiled loop (2 x 4 or 4 x 4 outputs
//     per thread), with the tile's rows and columns strided so that
//     neighbouring threads read neighbouring shared-memory words; B, C and
//     the C B^T strip have odd row strides to keep transposed reads free of
//     bank conflicts.

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxChunk = 128;
constexpr int kStrip = 32;

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

__host__ __device__ inline int odd_stride(int n) { return (n % 2 == 0) ? n + 1 : n; }

struct Dims {
  int Bsz, S, H, P, N, Q;
  int ldn;  // row stride of Bs / Cs
  int ldm;  // row stride of the C B^T strip
};

__host__ __device__ inline size_t smem_floats(const Dims& d) {
  const int rs = d.Q < kStrip ? d.Q : kStrip;
  return static_cast<size_t>(d.N) * d.P + static_cast<size_t>(d.Q) * d.P +
         2 * static_cast<size_t>(d.Q) * d.ldn + static_cast<size_t>(rs) * d.ldm +
         3 * static_cast<size_t>(d.Q);
}

// acc[r][c] += sum_k A[m_r, k] * B[k, n_c] over k < K, with rows
// m_r = mt + r * ntm (< M) and columns n_c = nt + c * ntn (< Nn); out-of-
// range rows and columns read a clamped element and are dropped by the
// caller.
template <int TM, int TN>
__device__ __forceinline__ void gemm_acc(float (&acc)[TM][TN], int mt, int nt,
                                         int ntm, int ntn, int M, int Nn, int K,
                                         const float* A, int lda_m, int lda_k,
                                         const float* Bm, int ldb_k, int ldb_n) {
  int a_off[TM], b_off[TN];
#pragma unroll
  for (int r = 0; r < TM; ++r) a_off[r] = min(mt + r * ntm, M - 1) * lda_m;
#pragma unroll
  for (int c = 0; c < TN; ++c) b_off[c] = min(nt + c * ntn, Nn - 1) * ldb_n;
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    float a[TM], b[TN];
#pragma unroll
    for (int r = 0; r < TM; ++r) a[r] = A[a_off[r] + k * lda_k];
#pragma unroll
    for (int c = 0; c < TN; ++c) b[c] = Bm[k * ldb_k + b_off[c]];
#pragma unroll
    for (int r = 0; r < TM; ++r)
#pragma unroll
      for (int c = 0; c < TN; ++c) acc[r][c] = fmaf(a[r], b[c], acc[r][c]);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_chunk_scan_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                      const float* __restrict__ A, const T* __restrict__ Bmat,
                      const T* __restrict__ Cmat, T* __restrict__ y,
                      float* __restrict__ hout, Dims d) {
  extern __shared__ float smem[];
  const int P = d.P, N = d.N, Q = d.Q, H = d.H, S = d.S;
  const int ldn = d.ldn, ldm = d.ldm;
  const int rs_max = Q < kStrip ? Q : kStrip;
  float* hs = smem;                  // [N][P]   carried state
  float* xs = hs + N * P;            // [Q][P]
  float* Bs = xs + Q * P;            // [Q][ldn]
  float* Cs = Bs + Q * ldn;          // [Q][ldn]
  float* Ms = Cs + Q * ldn;          // [rs][ldm] strip of (C B^T) o decay o dt
  float* cum = Ms + rs_max * ldm;    // [Q]  La
  float* dts = cum + Q;              // [Q]
  float* wt = dts + Q;               // [Q]  exp(La_Q - La_j) dt_j

  const int tid = threadIdx.x;
  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const float a_h = A[h];

  for (int o = tid; o < N * P; o += kThreads) hs[o] = 0.f;

  const int num_chunks = S / Q;
  for (int c = 0; c < num_chunks; ++c) {
    const int64_t s0 = static_cast<int64_t>(b) * S + static_cast<int64_t>(c) * Q;
    __syncthreads();  // the previous chunk is done with xs / Bs / Cs / dts
    for (int o = tid; o < Q * P; o += kThreads) {
      const int j = o / P, p = o % P;
      xs[o] = Elem<T>::load(x[((s0 + j) * H + h) * P + p]);
    }
    for (int o = tid; o < Q * N; o += kThreads) {
      const int j = o / N, n = o % N;
      Bs[j * ldn + n] = Elem<T>::load(Bmat[s0 * N + o]);
      Cs[j * ldn + n] = Elem<T>::load(Cmat[s0 * N + o]);
    }
    for (int j = tid; j < Q; j += kThreads) dts[j] = dt[(s0 + j) * H + h];
    __syncthreads();

    // La = cumsum(dt * A) over the chunk: one warp, ceil(Q/32) per lane
    if (tid < 32) {
      const int per = (Q + 31) / 32;
      const int j0 = tid * per;
      float run = 0.f;
      for (int e = 0; e < per; ++e) {
        const int j = j0 + e;
        if (j < Q) {
          run += dts[j] * a_h;
          cum[j] = run;
        }
      }
      float incl = run;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float up = __shfl_up_sync(0xffffffffu, incl, off);
        if (tid >= off) incl += up;
      }
      const float before = incl - run;
      for (int e = 0; e < per; ++e) {
        const int j = j0 + e;
        if (j < Q) cum[j] += before;
      }
    }
    __syncthreads();
    const float la_last = cum[Q - 1];
    for (int j = tid; j < Q; j += kThreads) wt[j] = expf(la_last - cum[j]) * dts[j];

    // ---- y, in strips of rows
    for (int r0 = 0; r0 < Q; r0 += kStrip) {
      const int rows = min(kStrip, Q - r0);
      const int jn = r0 + rows;  // keys j <= i < jn
      {  // Ms[m][j] = (C_i . B_j) exp(La_i - La_j) dt_j for j <= i, else 0
        constexpr int TM = 4, TN = 4;
        const int ntm = (rows + TM - 1) / TM, ntn = (jn + TN - 1) / TN;
        for (int t = tid; t < ntm * ntn; t += kThreads) {
          const int mt = t / ntn, nt = t % ntn;
          float acc[TM][TN] = {};
          gemm_acc<TM, TN>(acc, mt, nt, ntm, ntn, rows, jn, N,
                           Cs + r0 * ldn, ldn, 1, Bs, 1, ldn);
#pragma unroll
          for (int r = 0; r < TM; ++r) {
            const int m = mt + r * ntm;
            if (m >= rows) continue;
            const int i = r0 + m;
#pragma unroll
            for (int cc = 0; cc < TN; ++cc) {
              const int j = nt + cc * ntn;
              if (j >= jn) continue;
              Ms[m * ldm + j] =
                  j <= i ? acc[r][cc] * expf(cum[i] - cum[j]) * dts[j] : 0.f;
            }
          }
        }
      }
      __syncthreads();
      {  // y_i = exp(La_i) (C_i . h_in) + sum_j Ms[i][j] x_j
        constexpr int TM = 2, TN = 4;
        const int ntm = (rows + TM - 1) / TM, ntn = (P + TN - 1) / TN;
        for (int t = tid; t < ntm * ntn; t += kThreads) {
          const int mt = t / ntn, nt = t % ntn;
          float acc[TM][TN] = {};
          gemm_acc<TM, TN>(acc, mt, nt, ntm, ntn, rows, P, N,
                           Cs + r0 * ldn, ldn, 1, hs, P, 1);
#pragma unroll
          for (int r = 0; r < TM; ++r) {
            const int m = min(mt + r * ntm, rows - 1);
            const float e = expf(cum[r0 + m]);
#pragma unroll
            for (int cc = 0; cc < TN; ++cc) acc[r][cc] *= e;
          }
          gemm_acc<TM, TN>(acc, mt, nt, ntm, ntn, rows, P, jn,
                           Ms, ldm, 1, xs, P, 1);
#pragma unroll
          for (int r = 0; r < TM; ++r) {
            const int m = mt + r * ntm;
            if (m >= rows) continue;
            T* yrow = y + ((s0 + r0 + m) * H + h) * P;
#pragma unroll
            for (int cc = 0; cc < TN; ++cc) {
              const int p = nt + cc * ntn;
              if (p < P) yrow[p] = Elem<T>::store(acc[r][cc]);
            }
          }
        }
      }
      __syncthreads();  // Ms is rewritten by the next strip
    }

    // ---- state: h = exp(La_Q) h + sum_j (wt_j B_j) (x) x_j
    for (int o = tid; o < Q * N; o += kThreads) {
      const int j = o / N, n = o % N;
      Bs[j * ldn + n] *= wt[j];
    }
    __syncthreads();
    {
      constexpr int TM = 4, TN = 4;
      const float dec = expf(la_last);
      const int ntm = (N + TM - 1) / TM, ntn = (P + TN - 1) / TN;
      for (int t = tid; t < ntm * ntn; t += kThreads) {
        const int mt = t / ntn, nt = t % ntn;
        float acc[TM][TN] = {};
        gemm_acc<TM, TN>(acc, mt, nt, ntm, ntn, N, P, Q, Bs, 1, ldn, xs, P, 1);
#pragma unroll
        for (int r = 0; r < TM; ++r) {
          const int n = mt + r * ntm;
          if (n >= N) continue;
#pragma unroll
          for (int cc = 0; cc < TN; ++cc) {
            const int p = nt + cc * ntn;
            if (p < P) hs[n * P + p] = dec * hs[n * P + p] + acc[r][cc];
          }
        }
      }
    }
  }
  __syncthreads();
  float* hb = hout + (static_cast<int64_t>(b) * H + h) * N * P;
  for (int o = tid; o < N * P; o += kThreads) hb[o] = hs[o];
}

template <typename T>
cudaError_t launch(const void* x, const float* dt, const float* A,
                   const void* Bm, const void* Cm, void* y, float* hout,
                   const Dims& d, cudaStream_t stream) {
  const size_t smem = smem_floats(d) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_chunk_scan_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  ssd_chunk_scan_kernel<T><<<d.Bsz * d.H, kThreads, smem, stream>>>(
      static_cast<const T*>(x), dt, A, static_cast<const T*>(Bm),
      static_cast<const T*>(Cm), static_cast<T*>(y), hout, d);
  return cudaGetLastError();
}

}  // namespace

// Bytes of dynamic shared memory one block needs (the wrapper checks it
// against the card's limit before launching).
extern "C" long long ssm_scan_smem_bytes(int P, int N, int Q) {
  Dims d{1, Q, 1, P, N, Q, odd_stride(N), odd_stride(Q)};
  return static_cast<long long>(smem_floats(d) * sizeof(float));
}

// dtype code: 0 = float32, 1 = bfloat16 (x, B, C and y alike); dt and A
// are float32, hout float32. All tensors contiguous: x, y (B, S, H, P);
// dt (B, S, H); A (H,); B, C (B, S, N); hout (B, H, N, P). S % chunk == 0
// and chunk <= 128. Returns a cudaError_t (0: ok).
extern "C" int ssm_scan_launch(int dtype, const void* x, const void* dt,
                               const void* A, const void* Bm, const void* Cm,
                               void* y, void* hout, int Bsz, int S, int H,
                               int P, int N, int chunk, void* stream) {
  if (Bsz <= 0 || H <= 0 || S <= 0) return 0;
  if (chunk <= 0 || chunk > kMaxChunk || S % chunk != 0 || P <= 0 || N <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Dims d{Bsz, S, H, P, N, chunk, odd_stride(N), odd_stride(chunk)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* dtf = static_cast<const float*>(dt);
  const float* Af = static_cast<const float*>(A);
  float* hf = static_cast<float*>(hout);
  if (dtype == 0)
    return static_cast<int>(launch<float>(x, dtf, Af, Bm, Cm, y, hf, d, s));
  if (dtype == 1)
    return static_cast<int>(launch<__nv_bfloat16>(x, dtf, Af, Bm, Cm, y, hf, d, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

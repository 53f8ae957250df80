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
// H 32, P 64, N 128, chunk 128, bf16) the function needs ~7.4 MFLOP per
// (b, h, chunk), ~30 GFLOP per call, against ~153 MB of x, dt, B, C, y and
// the final state: ~200 flops per byte, below the bf16 tensor cores' ridge
// (~295), so the bound is the bytes (~0.046 ms at 3.35 TB/s). On the CUDA
// cores' fp32 FMAs alone (67 TFLOP/s) the floor would be ~0.45 ms.
//
// Two kernels, chosen by one rule (tc_path below):
//
// * bf16 with P one of 16, 32, 48, 64 or 128, N a multiple of 16 up to 128,
//   a chunk that is a multiple of 16 up to 128, 16-byte aligned x, B and C,
//   and a block that fits in shared memory (the serving path): the
//   tensor-core kernel. Only the (N, P) state is sequential from chunk to
//   chunk; the intra-chunk term and each chunk's own state contribution
//   s_c = sum_j w_j B_j (x) x_j are not. So one block of 512 threads (16
//   warps) takes one (b, chunk, group of HG heads; HG 2 for P <= 64, else
//   1): 2048 blocks at the serving shapes, where the first kernel had 256
//   that each walked 16 chunks. All warps load and build G; then they split
//   into one group per head (8 warps each when HG is 2), and each group
//   runs its head between barriers of its own, so that one head's waits
//   and stores overlap the other's products. Warp w of a group works on the
//   16-row strip w % 8 of the chunk and of the state, and on a share of the
//   columns of P. Per block:
//     - cp.async brings the chunk's B, C (bf16, Q x N) and dt, then the
//       heads' x (bf16, Q x P), into shared memory; rows are padded by 16
//       bytes so that ldmatrix reads them without bank conflicts;
//     - G = C B^T on the tensor cores (mma.sync m16n8k16, bf16 in, fp32
//       sums), only its 16 x 16 blocks on and below the diagonal, once for
//       all of the block's heads (B and C have no head dim: one group),
//       kept in shared memory as fp32 fragments;
//     - per head, its group builds M = G o exp(La_i - La_j) o dt_j in
//       shared memory, rounded to bf16 as the flash kernel rounds P; La is
//       kept in log2 units so that a decay is one ex2. Below the diagonal
//       block every j < i; on it j > i is selected to 0, never multiplied,
//       and the exponent is clamped at 0, so there is no inf * 0. Then
//       y = M x on the tensor cores;
//     - the chained state pass, per head: blocks take their work from an
//       atomic ticket in chunk-major order, so the block of chunk c - 1 of
//       the same (b, h) holds a smaller ticket and is already resident or
//       done: waiting on it cannot deadlock. The block of chunk c computes
//       its s_c = (B o w)^T x on the tensor cores (w_j = exp(La_Q - La_j)
//       dt_j, folded into the B^T fragments), then waits for chunk c - 1's
//       flag (an acquire load; a wait past 4 s traps instead of hanging the
//       card), forms H_c = exp(La_Q) H_{c-1} + s_c in fp32 and publishes it
//       (store, barrier, release store of the flag); the last chunk writes
//       the final state instead. H_{c-1} goes to shared memory as a bf16
//       hi + lo pair (H itself is never rounded to bf16 alone), and
//       y += exp(La_i) C_i . H_{c-1} runs as two tensor-core products; then
//       y is stored;
//     - H lives in a two-slot ring per (b, h) in device memory (16 MB at
//       the serving shapes, within the 50 MB L2): chunk c + 2 overwrites
//       slot c % 2 only after it has seen chunk c + 1's flag, and chunk
//       c + 1 read that slot before raising it;
//     - the ticket, a done counter and the flags are a small int32 scratch
//       that the wrapper allocates zeroed once per stream; the last block
//       to finish zeroes it again, so a call leaves it ready for the next
//       and no launch is added to clear it. The wrapper allocates the ring.
//   No float atomics: every output element is written once, by one thread.
//   What holds it now (tools/ssm_scan_phases.py on the card): one block of
//   16 warps a SM (its shared memory, ~215 KB), whose phases run one after
//   another between barriers, each bound by latency rather than by the
//   tensor cores or the bytes; the chained waits themselves are short.
// * fp32 (the parity runs) and every other shape (chunk 100 or 52, N 8 or
//   above 128, P 24): the scalar kernel. One block of 256 threads per
//   (b, h) walks the chunks in order itself (the TPU's sequential chunk grid
//   axis), the state in shared memory; the chunk's x, B, C and dt in shared
//   memory as fp32; C B^T in strips of 32 rows up to the diagonal; every
//   product a register-tiled fp32 FMA loop (2 x 4 or 4 x 4 outputs per
//   thread) with odd row strides against bank conflicts. Its decays are
//   evaluated only where j <= i, so their argument is never positive.

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper.cuh"
#include "launch_config.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxChunk = 128;
constexpr int kStrip = 32;
constexpr int kMaxSmem = 232448;  // what one sm_90 block may opt in to

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

// The scalar kernel's block -> work item: one (batch row, head) a block,
// walking all S positions of it. The tile probe calls it too.
struct ScanItem {
  int b, h;
};

__device__ __forceinline__ ScanItem scalar_item(int H) {
  ScanItem it;
  it.b = blockIdx.x / H;
  it.h = blockIdx.x % H;
  return it;
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
  const ScanItem item = scalar_item(H);
  const int b = item.b;
  const int h = item.h;
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

// One block per (batch row, head), walking all S positions; the output's
// dims are (S, H, B).
LaunchConfig scalar_config(const Dims& d) {
  const int smem = static_cast<int>(smem_floats(d) * sizeof(float));
  LaunchConfig c{{static_cast<long long>(d.Bsz) * d.H, 1, 1}, {d.S, d.H, d.Bsz},
                 kThreads, smem, 0, 4};
  return c;
}

template <typename T>
cudaError_t launch_scalar(const void* x, const float* dt, const float* A,
                          const void* Bm, const void* Cm, void* y, float* hout,
                          const Dims& d, cudaStream_t stream) {
  const LaunchConfig c = scalar_config(d);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_chunk_scan_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, c.smem_bytes);
  if (err != cudaSuccess) return err;
  ssd_chunk_scan_kernel<T><<<static_cast<unsigned>(c.grid[0]), c.threads, c.smem_bytes,
                             stream>>>(
      static_cast<const T*>(x), dt, A, static_cast<const T*>(Bm),
      static_cast<const T*>(Cm), static_cast<T*>(y), hout, d);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The tensor-core kernel
// ---------------------------------------------------------------------------
namespace tc {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(hopper::smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(hopper::smem_u32(p)));
}

// d += a b: mma.sync m16n8k16, bf16 in, fp32 sums. Fragments as in the PTX
// ISA: a0 (row g, k 2t..2t+1), a1 row g + 8, a2 k + 8, a3 both; b0 (k
// 2t..2t+1, col g), b1 k + 8; d0, d1 (row g, cols 2t, 2t+1), d2, d3 row
// g + 8, where g = lane / 4 and t = lane % 4.
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(hopper::smem_u32(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(hopper::smem_u32(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// (lo, hi) bf16 pair scaled by (w0, w1), rounded to bf16 again.
__device__ __forceinline__ uint32_t scale2(uint32_t v, float w0, float w1) {
  const float lo = __uint_as_float(v << 16), hi = __uint_as_float(v & 0xffff0000u);
  return hopper::pack_bf16(lo * w0, hi * w1);
}

// 2^x (ex2.approx: relative error ~2^-22; 0 for x below -126).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Barrier of the nthreads threads of one group of warps (id 1, 2, ...;
// 0 is __syncthreads).
__device__ __forceinline__ void group_sync(int id, int nthreads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(nthreads) : "memory");
}

__device__ __forceinline__ uint32_t ld_acquire(const uint32_t* p) {
  uint32_t v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release(uint32_t* p, uint32_t v) {
  asm volatile("st.release.gpu.global.u32 [%0], %1;\n" ::"l"(p), "r"(v) : "memory");
}

// Wait until the predecessor chunk has published its state. It is
// resident or done (it holds a smaller ticket), so the wait lasts
// microseconds; past 4 s it is a protocol fault and the kernel traps.
__device__ __forceinline__ void wait_flag(const uint32_t* flag) {
  if (ld_acquire(flag) != 0u) return;
  const uint64_t t0 = hopper::global_timer_ns();
  for (uint32_t n = 1;; ++n) {
    __nanosleep(32);
    if (ld_acquire(flag) != 0u) return;
    if ((n & 1023u) == 0 && hopper::global_timer_ns() - t0 > 4000000000ull) __trap();
  }
}

struct Args {
  const bf16* x;
  const float* dt;
  const float* A;
  const bf16* Bm;
  const bf16* Cm;
  bf16* y;
  float* hout;
  float* ring;        // [2][B][H][N][P] fp32
  uint32_t* scratch;  // [0] ticket, [1] done, [2 ..] flags [B][H][S / Q]
  int Bsz, S, H, P, N, Q;
};

constexpr int kTcThreads = 512;                 // 16 warps
constexpr int kTcWarps = kTcThreads / 32;
constexpr int kStrips = kMaxChunk / 16;         // 16-row strips of a chunk, at most

// Heads per block: 2 when P <= 64 (they share G), else 1.
__host__ __device__ constexpr int heads_per_block(int P) { return P <= 64 ? 2 : 1; }

// bf16 elements of the region that holds M (Q x Q + 8) during the
// intra-chunk term and H_{c-1} (hi and lo, N x P + 8 each) after it.
__host__ __device__ inline size_t hm_elems(int P, int N, int Q) {
  const size_t h = 2 * static_cast<size_t>(N) * (P + 8), m = static_cast<size_t>(Q) * (Q + 8);
  return h > m ? h : m;
}

__host__ __device__ inline size_t smem_bytes(int P, int N, int Q) {
  const size_t ldn = N + 8, ldp = P + 8, hg = heads_per_block(P), ns = Q / 16;
  return 2 * Q * ldn * 2                // C, B
         + hg * Q * ldp * 2             // x of each head
         + hg * hm_elems(P, N, Q) * 2   // per head: M, then H_{c-1} as bf16 hi and lo
         + ns * (ns + 1) / 2 * 256 * 4  // G: its 16 x 16 blocks on and below the diagonal
         + 3 * hg * Q * 4               // La, dt, w of each head
         + 16;                          // ticket, last-block flag
}

// Ticket t -> its work: chunk c, batch row b and heads h0 .. h0 + nh - 1,
// chunk-major, so that chunk c - 1 of a (b, h) always holds a smaller
// ticket. The tile probe calls it too.
struct Ticket {
  int c, b, h0, nh;
};

__device__ __forceinline__ Ticket decode_ticket(int t, int Bsz, int H, int HG) {
  const int groups = (H + HG - 1) / HG;
  Ticket k;
  k.c = t / (Bsz * groups);
  k.b = (t % (Bsz * groups)) / groups;
  k.h0 = (t % groups) * HG;
  k.nh = min(HG, H - k.h0);
  return k;
}

// Work split: warp w takes the 16-row strip w % 8 of the chunk (and of the
// state) and the column groups w / 8, w / 8 + kColWarps, ... of P, PW
// columns each.
template <int P, int HG>
__global__ void __launch_bounds__(kTcThreads, 1) ssd_tc_kernel(Args g) {
  // the warps of a head: group k of kGroupWarps warps works on head k
  constexpr int kGroupWarps = kTcWarps / HG;
  constexpr int kGroupThreads = kGroupWarps * 32;
  constexpr int kColWarps = kGroupWarps / kStrips;   // warps of a group that share a strip
  // columns of a task: P / kColWarps, at least 16 (one ldmatrix.x4.trans)
  constexpr int PW = (P / kColWarps) % 16 == 0 && P / kColWarps >= 16 ? P / kColWarps : 16;
  constexpr int kCG = P / PW;                              // column groups
  constexpr int kTasks = (kCG + kColWarps - 1) / kColWarps; // column groups a warp takes
  static_assert(P % PW == 0, "P must split into column groups");
  constexpr int kNB = PW / 8;                    // n8 blocks of a task
  constexpr int ldp = P + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int N = g.N, Q = g.Q, H = g.H, S = g.S;
  const int ldn = N + 8, ldm = Q + 8, nS = Q / 16;
  bf16* Cs = reinterpret_cast<bf16*>(smem_raw);
  bf16* Bs = Cs + Q * ldn;
  bf16* Xs = Bs + Q * ldn;
  bf16* HM = Xs + HG * Q * ldp;       // per head: M (rows of ldm), later H_{c-1}
  float* Gs = reinterpret_cast<float*>(HM + HG * hm_elems(P, N, Q));
  float* cum = Gs + nS * (nS + 1) / 2 * 256;
  float* dts = cum + HG * Q;
  float* wts = dts + HG * Q;
  int* shared_int = reinterpret_cast<int*>(wts + HG * Q);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, t4 = lane & 3;         // fragment row / column pair
  const int mi = lane >> 3, r8 = lane & 7;         // ldmatrix: matrix, row
  const int grp = warp / kGroupWarps, gw = warp % kGroupWarps;
  const int gtid = tid % kGroupThreads;
  const int strip = gw % kStrips, cg0 = gw / kStrips;

  uint32_t* ticket = g.scratch;
  uint32_t* done = g.scratch + 1;
  uint32_t* flags = g.scratch + 2;

  if (tid == 0) shared_int[0] = static_cast<int>(atomicAdd(ticket, 1u));
  __syncthreads();
  const int nc = S / Q;
  const Ticket work = decode_ticket(shared_int[0], g.Bsz, H, HG);
  const int c = work.c;
  const int b = work.b;
  const int h0 = work.h0;
  const int nh = work.nh;
  const int64_t s0 = static_cast<int64_t>(b) * S + static_cast<int64_t>(c) * Q;

  // ---- loads: B and C rows and dt (group 0), each head's x rows (group 1)
  {
    const int nv = N / 8;
    for (int o = tid; o < Q * nv; o += kTcThreads) {
      const int j = o / nv, v = o % nv;
      cp_async16(Cs + j * ldn + v * 8, g.Cm + (s0 + j) * N + v * 8);
      cp_async16(Bs + j * ldn + v * 8, g.Bm + (s0 + j) * N + v * 8);
    }
    for (int o = tid; o < nh * Q; o += kTcThreads) {
      const int k = o / Q, j = o % Q;
      cp_async4(dts + k * Q + j, g.dt + (s0 + j) * H + h0 + k);
    }
    cp_async_commit();
    constexpr int pv = P / 8;
    for (int o = tid; o < nh * Q * pv; o += kTcThreads) {
      const int k = o / (Q * pv), j = (o / pv) % Q, v = o % pv;
      cp_async16(Xs + (k * Q + j) * ldp + v * 8, g.x + ((s0 + j) * H + h0 + k) * P + v * 8);
    }
    cp_async_commit();
  }
  cp_async_wait<1>();   // B, C and dt have landed
  __syncthreads();
  // La = cumsum(dt * A) over the chunk, kept in log2 units (La log2(e)) so
  // that every decay is one ex2: warp k for head k, ceil(Q/32) a lane
  if (warp < nh) {
    const float a_h = g.A[h0 + warp] * 1.4426950408889634f;
    const float* dk = dts + warp * Q;
    float* ck = cum + warp * Q;
    const int per = (Q + 31) / 32;
    const int j0 = lane * per;
    float run = 0.f;
    for (int e = 0; e < per; ++e) {
      const int j = j0 + e;
      if (j < Q) {
        run += dk[j] * a_h;
        ck[j] = run;
      }
    }
    float incl = run;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float up = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane >= off) incl += up;
    }
    const float before = incl - run;
    for (int e = 0; e < per; ++e) {
      const int j = j0 + e;
      if (j < Q) ck[j] += before;
    }
  }
  __syncthreads();
  for (int o = tid; o < nh * Q; o += kTcThreads) {
    const int k = o / Q;
    wts[o] = ex2(cum[k * Q + Q - 1] - cum[o]) * dts[o];
  }

  // ---- G = C B^T, once for the block's heads: each warp takes 16 x 16
  // blocks on and below the diagonal (block (a, bb) is number a(a+1)/2 + bb)
  // and keeps them in shared memory as fp32 accumulator fragments
  for (int blk = warp; blk < nS * (nS + 1) / 2; blk += kTcWarps) {
    int a = 0;
    while ((a + 1) * (a + 2) / 2 <= blk) ++a;
    const int bb = blk - a * (a + 1) / 2;
    float acc[2][4] = {};
#pragma unroll 4
    for (int ks = 0; ks < N / 16; ++ks) {
      uint32_t af[4], bf[4];
      ldsm_x4(af, Cs + (a * 16 + (mi & 1) * 8 + r8) * ldn + ks * 16 + (mi >> 1) * 8);
      ldsm_x4(bf, Bs + (bb * 16 + (mi >> 1) * 8 + r8) * ldn + ks * 16 + (mi & 1) * 8);
      mma(acc[0], af, bf[0], bf[1]);
      mma(acc[1], af, bf[2], bf[3]);
    }
    float4* dst = reinterpret_cast<float4*>(Gs + blk * 256);
    dst[lane] = make_float4(acc[0][0], acc[0][1], acc[0][2], acc[0][3]);
    dst[32 + lane] = make_float4(acc[1][0], acc[1][1], acc[1][2], acc[1][3]);
  }
  cp_async_wait<0>();   // x has landed
  __syncthreads();      // G and w are written

  // ---- from here each group of warps works on its own head, between
  // barriers of its own (bar.sync 1 + group), so that one head's waits and
  // stores overlap the other's products.
  // ---- intra-chunk term: M = G o exp(La_i - La_j) o dt_j where j <= i,
  // else 0, built by the group into shared memory as bf16 (below the
  // diagonal block every j < i; on it j > i is selected to 0, never
  // multiplied, and the exponent is clamped at 0), then y = M x
  const int k = grp;
  if (k < nh) {
    const int h = h0 + k;
    const int64_t bh = static_cast<int64_t>(b) * H + h;
    const float* ck = cum + k * Q;
    const float* dk = dts + k * Q;
    bf16* Ms = HM + k * hm_elems(P, N, Q);
    bf16* Hhi = Ms;
    bf16* Hlo = Hhi + N * ldp;
    const int nblk = nS * (nS + 1) / 2;
    for (int item = gtid; item < nblk * 64; item += kGroupThreads) {
      const int blk = item >> 6, half = (item >> 5) & 1, ln = item & 31;
      int a = 0;
      while ((a + 1) * (a + 2) / 2 <= blk) ++a;
      const int bb = blk - a * (a + 1) / 2;
      const float4 gv = reinterpret_cast<const float4*>(Gs + blk * 256)[half * 32 + ln];
      const int i = a * 16 + (ln >> 2), j = bb * 16 + half * 8 + 2 * (ln & 3);
      const float ci = ck[i], ci8 = ck[i + 8];
      const float2 cj = *reinterpret_cast<const float2*>(ck + j);
      const float2 dj = *reinterpret_cast<const float2*>(dk + j);
      const bool diag = a == bb;
      auto m = [&](float g_, int ii, float c_i, int jj, float c_j, float d_j) {
        const float v = g_ * ex2(fminf(c_i - c_j, 0.f)) * d_j;
        return (!diag || jj <= ii) ? v : 0.f;
      };
      *reinterpret_cast<uint32_t*>(Ms + i * ldm + j) =
          hopper::pack_bf16(m(gv.x, i, ci, j, cj.x, dj.x), m(gv.y, i, ci, j + 1, cj.y, dj.y));
      *reinterpret_cast<uint32_t*>(Ms + (i + 8) * ldm + j) =
          hopper::pack_bf16(m(gv.z, i + 8, ci8, j, cj.x, dj.x), m(gv.w, i + 8, ci8, j + 1, cj.y, dj.y));
    }
    group_sync(1 + k, kGroupThreads);
    float yacc[kTasks][kNB][4];
#pragma unroll
    for (int tk = 0; tk < kTasks; ++tk)
#pragma unroll
      for (int nb = 0; nb < kNB; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) yacc[tk][nb][e] = 0.f;
    const int i0 = strip * 16, ir0 = i0 + gq, ir1 = ir0 + 8;
    if (strip < nS) {
      for (int kk = 0; kk <= strip; ++kk) {
        uint32_t a[4];
        ldsm_x4(a, Ms + (i0 + (mi & 1) * 8 + r8) * ldm + kk * 16 + (mi >> 1) * 8);
#pragma unroll
        for (int tk = 0; tk < kTasks; ++tk) {
          const int cg = cg0 + kColWarps * tk;
          if (cg >= kCG) break;
#pragma unroll
          for (int pp = 0; pp < kNB / 2; ++pp) {
            uint32_t bb[4];
            ldsm_x4_t(bb, Xs + (k * Q + kk * 16 + (mi & 1) * 8 + r8) * ldp + cg * PW + pp * 16 +
                              (mi >> 1) * 8);
            mma(yacc[tk][2 * pp], a, bb[0], bb[1]);
            mma(yacc[tk][2 * pp + 1], a, bb[2], bb[3]);
          }
        }
      }
    }

    // ---- the chained state pass. Warp w of the group also owns rows 16
    // (w % 8) .. + 15 of the (N, P) state (N <= 128) in its column groups.
    // Its share of s_c = (B o w)^T x is computed before the wait; after it,
    // only the load of H_{c-1} (a thread's loads issued together), the
    // update, the store and the flag stand between one chunk and the next.
    const int64_t slot = static_cast<int64_t>(g.Bsz) * H * N * P;
    const bool has_state = strip < N / 16;
    const int n0 = strip * 16;
    float s[kTasks][kNB][4];
#pragma unroll
    for (int tk = 0; tk < kTasks; ++tk)
#pragma unroll
      for (int nb = 0; nb < kNB; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[tk][nb][e] = 0.f;
    if (has_state) {
      const float* wk = wts + k * Q;
      for (int ks = 0; ks < Q / 16; ++ks) {
        uint32_t a[4];
        ldsm_x4_t(a, Bs + (ks * 16 + (mi >> 1) * 8 + r8) * ldn + n0 + (mi & 1) * 8);
        const int j0 = ks * 16 + 2 * t4;
        const float w0 = wk[j0], w1 = wk[j0 + 1], w8 = wk[j0 + 8], w9 = wk[j0 + 9];
        a[0] = scale2(a[0], w0, w1);
        a[1] = scale2(a[1], w0, w1);
        a[2] = scale2(a[2], w8, w9);
        a[3] = scale2(a[3], w8, w9);
#pragma unroll
        for (int tk = 0; tk < kTasks; ++tk) {
          const int cg = cg0 + kColWarps * tk;
          if (cg >= kCG) break;
#pragma unroll
          for (int pp = 0; pp < kNB / 2; ++pp) {
            uint32_t bb[4];
            ldsm_x4_t(bb, Xs + (k * Q + ks * 16 + (mi & 1) * 8 + r8) * ldp + cg * PW + pp * 16 +
                              (mi >> 1) * 8);
            mma(s[tk][2 * pp], a, bb[0], bb[1]);
            mma(s[tk][2 * pp + 1], a, bb[2], bb[3]);
          }
        }
      }
    }
    // M is done with (its space holds H next), and chunk c - 1 has
    // published H_{c-1}
    if (c > 0 && gtid == 0) wait_flag(flags + bh * nc + c - 1);
    group_sync(1 + k, kGroupThreads);
    if (has_state) {
      // H_c = exp(La_Q) H_{c-1} + s_c; H_{c-1} to shared memory as hi + lo
      const float* prev = g.ring + ((c - 1) & 1) * slot + bh * N * P;
      float* next = (c == nc - 1 ? g.hout : g.ring + (c & 1) * slot) + bh * N * P;
      const float dec = ex2(ck[Q - 1]);
      float2 hp[kTasks][kNB][2];
#pragma unroll
      for (int tk = 0; tk < kTasks; ++tk)
#pragma unroll
        for (int nb = 0; nb < kNB; ++nb)
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int cg = cg0 + kColWarps * tk;
            const int n = n0 + gq + half * 8, p = cg * PW + nb * 8 + 2 * t4;
            hp[tk][nb][half] = make_float2(0.f, 0.f);
            if (c > 0 && cg < kCG)
              hp[tk][nb][half] = __ldcg(reinterpret_cast<const float2*>(prev + n * P + p));
          }
#pragma unroll
      for (int tk = 0; tk < kTasks; ++tk) {
        const int cg = cg0 + kColWarps * tk;
        if (cg >= kCG) break;
#pragma unroll
        for (int nb = 0; nb < kNB; ++nb)
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int n = n0 + gq + half * 8, p = cg * PW + nb * 8 + 2 * t4;
            const float2 v = hp[tk][nb][half];
            __stcg(reinterpret_cast<float2*>(next + n * P + p),
                   make_float2(dec * v.x + s[tk][nb][2 * half], dec * v.y + s[tk][nb][2 * half + 1]));
            if (c > 0) {
              const uint32_t hi = hopper::pack_bf16(v.x, v.y);
              const float hx = __uint_as_float(hi << 16), hy = __uint_as_float(hi & 0xffff0000u);
              *reinterpret_cast<uint32_t*>(Hhi + n * ldp + p) = hi;
              *reinterpret_cast<uint32_t*>(Hlo + n * ldp + p) = hopper::pack_bf16(v.x - hx, v.y - hy);
            }
          }
      }
    }
    // publish: the barrier orders the group's stores before its thread 0's
    // release store at gpu scope, which is cumulative over them
    group_sync(1 + k, kGroupThreads);
    if (c < nc - 1 && gtid == 0) st_release(flags + bh * nc + c, 1u);

    // y += exp(La_i) C_i . H_{c-1} (bf16 hi + lo of H), then y is stored
    if (strip < nS) {
      const float e0 = ex2(ck[ir0]), e1 = ex2(ck[ir1]);
#pragma unroll
      for (int tk = 0; tk < kTasks; ++tk) {
        const int cg = cg0 + kColWarps * tk;
        if (cg >= kCG) break;
        if (c > 0) {
          float tacc[kNB][4];
#pragma unroll
          for (int nb = 0; nb < kNB; ++nb)
#pragma unroll
            for (int e = 0; e < 4; ++e) tacc[nb][e] = 0.f;
          for (int ks = 0; ks < N / 16; ++ks) {
            uint32_t a[4];
            ldsm_x4(a, Cs + (i0 + (mi & 1) * 8 + r8) * ldn + ks * 16 + (mi >> 1) * 8);
#pragma unroll
            for (int pp = 0; pp < kNB / 2; ++pp) {
              const int off = (ks * 16 + (mi & 1) * 8 + r8) * ldp + cg * PW + pp * 16 + (mi >> 1) * 8;
              uint32_t bh4[4], bl4[4];
              ldsm_x4_t(bh4, Hhi + off);
              ldsm_x4_t(bl4, Hlo + off);
              mma(tacc[2 * pp], a, bh4[0], bh4[1]);
              mma(tacc[2 * pp], a, bl4[0], bl4[1]);
              mma(tacc[2 * pp + 1], a, bh4[2], bh4[3]);
              mma(tacc[2 * pp + 1], a, bl4[2], bl4[3]);
            }
          }
#pragma unroll
          for (int nb = 0; nb < kNB; ++nb) {
            yacc[tk][nb][0] += e0 * tacc[nb][0];
            yacc[tk][nb][1] += e0 * tacc[nb][1];
            yacc[tk][nb][2] += e1 * tacc[nb][2];
            yacc[tk][nb][3] += e1 * tacc[nb][3];
          }
        }
#pragma unroll
        for (int nb = 0; nb < kNB; ++nb) {
          const int p = cg * PW + nb * 8 + 2 * t4;
          bf16* y0 = g.y + ((s0 + ir0) * H + h) * P + p;
          bf16* y1 = g.y + ((s0 + ir1) * H + h) * P + p;
          *reinterpret_cast<uint32_t*>(y0) = hopper::pack_bf16(yacc[tk][nb][0], yacc[tk][nb][1]);
          *reinterpret_cast<uint32_t*>(y1) = hopper::pack_bf16(yacc[tk][nb][2], yacc[tk][nb][3]);
        }
      }
    }
  }

  // ---- the last block to finish clears the ticket, the count and the
  // flags for the next call
  __syncthreads();
  if (tid == 0) {
    __threadfence();
    shared_int[1] = atomicAdd(done, 1u) == gridDim.x - 1 ? 1 : 0;
  }
  __syncthreads();
  if (shared_int[1]) {
    __threadfence();
    const int nflags = g.Bsz * H * nc;
    for (int o = tid; o < nflags; o += kTcThreads) flags[o] = 0u;
    if (tid == 0) {
      *ticket = 0u;
      *done = 0u;
    }
  }
}

// One block per (chunk, batch row, group of heads_per_block(P) heads); the
// output's dims are (S, H, B).
inline LaunchConfig config(int Bsz, int S, int H, int P, int N, int Q) {
  const int hg = heads_per_block(P);
  const long long groups = (H + hg - 1) / hg, chunks = S / Q;
  LaunchConfig c{{chunks * Bsz * groups, 1, 1}, {chunks * Q, groups * hg, Bsz},
                 kTcThreads, static_cast<int>(smem_bytes(P, N, Q)), 1, 4};
  return c;
}

template <int P>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  constexpr int HG = heads_per_block(P);
  const LaunchConfig c = config(a.Bsz, a.S, a.H, a.P, a.N, a.Q);
  cudaError_t err = cudaFuncSetAttribute(ssd_tc_kernel<P, HG>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         c.smem_bytes);
  if (err != cudaSuccess) return err;
  ssd_tc_kernel<P, HG><<<static_cast<unsigned>(c.grid[0]), c.threads, c.smem_bytes, stream>>>(a);
  return cudaGetLastError();
}

// The head widths compiled for the tensor-core kernel.
inline bool compiled_width(int P) { return P == 16 || P == 32 || P == 48 || P == 64 || P == 128; }

cudaError_t launch_width(const Args& a, cudaStream_t stream) {
  switch (a.P) {
    case 16: return launch<16>(a, stream);
    case 32: return launch<32>(a, stream);
    case 48: return launch<48>(a, stream);
    case 64: return launch<64>(a, stream);
    case 128: return launch<128>(a, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace tc

// One thread a block, on the launch's grid. The tensor-core kernel's block
// i takes ticket i in some order, so probe block i decodes ticket i: the
// check is that decode_ticket maps the tickets one to one onto disjoint
// tiles, rows [c Q, c Q + Q) of heads h0 .. h0 + nh - 1 of batch row b. The
// scalar kernel's block owns all S rows of its (b, h).
__global__ void ssd_tile_probe_kernel(int tensor_cores, int Bsz, int S, int H, int Q, int HG,
                                      TileBox* boxes, int capacity, unsigned int* count) {
  const long long i = blockIdx.x;
  if (tensor_cores) {
    const tc::Ticket k = tc::decode_ticket(static_cast<int>(i), Bsz, H, HG);
    const long long s0 = static_cast<long long>(k.c) * Q;
    emit_box(boxes, capacity, count, i, 0, 0, s0, k.h0, k.b, s0 + Q, k.h0 + k.nh, k.b + 1);
  } else {
    const ScanItem it = scalar_item(H);
    emit_box(boxes, capacity, count, i, 0, 0, 0, it.h, it.b, S, it.h + 1, it.b + 1);
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

// The one rule that picks the kernel (see the top of the file). The dry run's
// meta branch mirrors it in kernels/ssm_scan.py::meta_path (without the
// addresses); change both together.
bool tc_path(int dtype, int P, int N, int Q, const void* x, const void* Bm, const void* Cm) {
  return dtype == 1 && tc::compiled_width(P) && N % 16 == 0 && N > 0 && N <= 128 &&
         Q % 16 == 0 && Q > 0 && Q <= kMaxChunk && aligned16(x) && aligned16(Bm) &&
         aligned16(Cm) && tc::smem_bytes(P, N, Q) <= kMaxSmem;
}

}  // namespace

// 1 when ssm_scan_launch takes the tensor-core kernel for these operands,
// 0 for the scalar kernel.
extern "C" int ssm_scan_path(int dtype, int P, int N, int chunk, const void* x,
                             const void* Bm, const void* Cm) {
  return tc_path(dtype, P, N, chunk, x, Bm, Cm) ? 1 : 0;
}

// Bytes of dynamic shared memory one block of the scalar kernel needs (the
// wrapper checks it against the card's limit before launching there). The
// meta branch mirrors it in kernels/ssm_scan.py::scalar_smem_bytes.
extern "C" long long ssm_scan_smem_bytes(int P, int N, int Q) {
  Dims d{1, Q, 1, P, N, Q, odd_stride(N), odd_stride(Q)};
  return static_cast<long long>(smem_floats(d) * sizeof(float));
}

// dtype code: 0 = float32, 1 = bfloat16 (x, B, C and y alike); dt and A
// are float32, hout float32. All tensors contiguous: x, y (B, S, H, P);
// dt (B, S, H); A (H,); B, C (B, S, N); hout (B, H, N, P). S % chunk == 0
// and chunk <= 128. The tensor-core kernel also takes ring, fp32
// (2, B, H, N, P), and scratch, int32 (2 + B * H * S / chunk) zeroed before
// the stream's first call (each call leaves it zeroed); the scalar kernel
// ignores both. Returns a cudaError_t (0: ok).
extern "C" int ssm_scan_launch(int dtype, const void* x, const void* dt,
                               const void* A, const void* Bm, const void* Cm,
                               void* y, void* hout, void* ring, void* scratch,
                               int Bsz, int S, int H, int P, int N, int chunk,
                               void* stream) {
  if (Bsz <= 0 || H <= 0 || S <= 0) return 0;
  if (chunk <= 0 || chunk > kMaxChunk || S % chunk != 0 || P <= 0 || N <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* dtf = static_cast<const float*>(dt);
  const float* Af = static_cast<const float*>(A);
  float* hf = static_cast<float*>(hout);
  if (tc_path(dtype, P, N, chunk, x, Bm, Cm)) {
    if (ring == nullptr || scratch == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    tc::Args a{static_cast<const __nv_bfloat16*>(x), dtf, Af,
               static_cast<const __nv_bfloat16*>(Bm), static_cast<const __nv_bfloat16*>(Cm),
               static_cast<__nv_bfloat16*>(y), hf, static_cast<float*>(ring),
               static_cast<uint32_t*>(scratch), Bsz, S, H, P, N, chunk};
    return static_cast<int>(tc::launch_width(a, s));
  }
  Dims d{Bsz, S, H, P, N, chunk, odd_stride(N), odd_stride(chunk)};
  if (dtype == 0)
    return static_cast<int>(launch_scalar<float>(x, dtf, Af, Bm, Cm, y, hf, d, s));
  if (dtype == 1)
    return static_cast<int>(launch_scalar<__nv_bfloat16>(x, dtf, Af, Bm, Cm, y, hf, d, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

// The launch configuration ssm_scan_launch uses for these shapes and
// operands (the path depends on x, B and C's alignment). Returns 0, or
// cudaErrorInvalidValue for shapes the launch refuses.
extern "C" int ssm_scan_launch_config(int dtype, int Bsz, int S, int H, int P, int N,
                                      int chunk, const void* x, const void* Bm,
                                      const void* Cm, LaunchConfig* out) {
  if (Bsz <= 0 || H <= 0 || S <= 0 || chunk <= 0 || chunk > kMaxChunk || S % chunk != 0 ||
      P <= 0 || N <= 0 || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  if (tc_path(dtype, P, N, chunk, x, Bm, Cm)) {
    *out = tc::config(Bsz, S, H, P, N, chunk);
  } else {
    Dims d{Bsz, S, H, P, N, chunk, odd_stride(N), odd_stride(chunk)};
    *out = scalar_config(d);
  }
  return 0;
}

// The output boxes (of y) of ssm_scan_launch's blocks for these shapes and
// operands, on the launch's own grid (the configuration
// ssm_scan_launch_config reports): TileBoxes into boxes (device memory,
// room for capacity), the number found in *count (device memory, zeroed by
// the caller). Returns a cudaError_t.
extern "C" int ssm_scan_tile_probe(int dtype, int Bsz, int S, int H, int P, int N, int chunk,
                                   const void* x, const void* Bm, const void* Cm,
                                   void* boxes, int capacity, void* count, void* stream) {
  LaunchConfig c;
  const int err = ssm_scan_launch_config(dtype, Bsz, S, H, P, N, chunk, x, Bm, Cm, &c);
  if (err) return err;
  ssd_tile_probe_kernel<<<static_cast<unsigned>(c.grid[0]), 1, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      c.path, Bsz, S, H, chunk, tc::heads_per_block(P), static_cast<TileBox*>(boxes),
      capacity, static_cast<unsigned int*>(count));
  return static_cast<int>(cudaGetLastError());
}

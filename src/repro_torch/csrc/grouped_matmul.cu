// Grouped (ragged) matmul for Hopper (sm_90a): the MoE expert products.
//
// Replaces src/repro/kernels/grouped_matmul.py::grouped_matmul (the Pallas
// TPU kernel, pallas_call at line 134; body _gmm_kernel at line 62):
//
//   out[r] = x[r] @ w[g]   for offsets[g] <= r < offsets[g + 1]
//   out[r] = 0             for offsets[G] <= r < M
//
// with offsets the exclusive cumulative sum of group_sizes (G,) int32,
// x (M, K) with its rows sorted by group, w (G, K, N), the products summed
// in fp32 and written in x's dtype. group_sizes stays on the card: the
// kernel reads it itself, so the wrapper never waits for the host.
//
// What bounds it on this card: at the MoE prefill's shapes (65,536 sorted
// token-expert rows, K 6144, N 10752, 16 experts) arithmetic, 8.7 TFLOP
// against 4.3 GB, some 2,000 flops per byte, far above the H100's ridge of
// ~295 for bf16. At decode's shapes (32 rows over up to 16 experts) it is
// the expert weights' bytes, read once: 2.1 GB per bf16 leaf.
//
// What the design does about it:
//   * each output tile belongs to one group. The Pallas grid visits all G
//     groups for every row block and masks the rows it does not own; here a
//     block of row tiles is counted per group instead: group g owns
//     ceil(size_g / BM) row tiles that start at its own first row, so a tile
//     never straddles two experts and never multiplies masked rows. Warp 0
//     finds the block's (group, rows) from the device-side sizes with a warp
//     scan, 32 groups per step. ceil(M / BM) + G row tiles cover every group
//     and, after the last group, the rows past sum(group_sizes), which are
//     written as 0; surplus row tiles exit at once;
//   * row tiles are visited in bands of 8 per column tile, so a band's x
//     tiles and a run of w's column tiles stay in the 50 MB L2 while the band
//     sweeps across N, instead of every row tile reading all of w[g] from
//     device memory;
//   * bf16 (the serving path): 128 x 128 output tiles, 8 warps of 64 x 32,
//     products on the tensor cores with mma.sync m16n8k16 (bf16 in, fp32
//     accumulators in registers), operands fed by ldmatrix from padded
//     (conflict-free) shared memory, and a 3-stage cp.async ring that loads
//     the next k slices while the current one is multiplied; rows outside
//     the tile's group and k or n past the edge are zero-filled by the copy
//     itself. wgmma and TMA are later work. It needs K and N multiples of 8
//     and 16-byte aligned operands;
//   * fp32 (the parity runs), and bf16 shapes the tensor-core path does not
//     take: scalar FMAs on the CUDA cores, 64 x 64 tiles, 4 x 4 outputs per
//     thread, any K and N.

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBandRows = 8;  // row tiles per raster band

struct TileInfo {
  int kind;   // 0: nothing to do, 1: rows of a group, 2: rows past the groups
  int group;
  int row0;   // the tile owns rows [row0, row1)
  int row1;
};

__device__ __forceinline__ int warp_inclusive_scan(int v, int lane) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int n = __shfl_up_sync(0xffffffffu, v, o);
    if (lane >= o) v += n;
  }
  return v;
}

// Run by all 32 lanes of warp 0: what row tile t of the grid owns. Group g
// owns tiles [first_g, first_g + ceil(size_g / BM)), first_g the sum of the
// earlier groups' tile counts; the tiles after the last group's cover the
// rows from sum(sizes) to M.
template <int BM>
__device__ void locate_tile(const int* __restrict__ sizes, int G, int M, int t,
                            TileInfo* info, int lane) {
  int rows_before = 0, tiles_before = 0;
  for (int base = 0; base < G; base += 32) {
    const int g = base + lane;
    const int size = g < G ? max(sizes[g], 0) : 0;
    const int tiles = (size + BM - 1) / BM;
    const int incl_tiles = warp_inclusive_scan(tiles, lane);
    const int incl_rows = warp_inclusive_scan(size, lane);
    const int first = tiles_before + incl_tiles - tiles;
    const bool hit = g < G && t >= first && t < first + tiles;
    if (__ballot_sync(0xffffffffu, hit)) {
      if (hit) {
        const int start = rows_before + incl_rows - size;
        const int r0 = start + (t - first) * BM;
        const int r1 = min(min(r0 + BM, start + size), M);
        info->kind = r0 < r1 ? 1 : 0;
        info->group = g;
        info->row0 = r0;
        info->row1 = r1;
      }
      return;
    }
    tiles_before += __shfl_sync(0xffffffffu, incl_tiles, 31);
    rows_before += __shfl_sync(0xffffffffu, incl_rows, 31);
  }
  if (lane == 0) {
    const int r0 = min(rows_before, M) + (t - tiles_before) * BM;
    info->kind = r0 < M ? 2 : 0;
    info->group = -1;
    info->row0 = r0;
    info->row1 = min(r0 + BM, M);
  }
}

// Block index -> (row tile, column tile), bands of kBandRows row tiles.
__device__ __forceinline__ void tile_coords(int n_row_tiles, int n_col_tiles,
                                            int* rt, int* ct) {
  const int per_band = kBandRows * n_col_tiles;
  const int bid = static_cast<int>(blockIdx.x);
  const int band = bid / per_band;
  const int first = band * kBandRows;
  const int rows = min(kBandRows, n_row_tiles - first);
  const int local = bid - band * per_band;
  *rt = first + local % rows;
  *ct = local / rows;
}

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

// ---------------------------------------------------------------------------
// Scalar path: fp32 FMAs, any dtype of the two, any K and N.
// ---------------------------------------------------------------------------
constexpr int kSBM = 64, kSBN = 64, kSBK = 16;

template <typename T>
__global__ void __launch_bounds__(kThreads)
gmm_scalar_kernel(const T* __restrict__ x, const T* __restrict__ w,
                  const int* __restrict__ sizes, T* __restrict__ out, int M,
                  int K, int N, int G, int n_row_tiles, int n_col_tiles) {
  __shared__ float As[kSBK][kSBM + 4];  // x tile, transposed
  __shared__ float Bs[kSBK][kSBN + 4];
  __shared__ TileInfo info;
  int rt, ct;
  tile_coords(n_row_tiles, n_col_tiles, &rt, &ct);
  if (threadIdx.x < 32) locate_tile<kSBM>(sizes, G, M, rt, &info, threadIdx.x);
  __syncthreads();
  const TileInfo ti = info;
  if (ti.kind == 0) return;
  const int tid = threadIdx.x;
  const int n0 = ct * kSBN;
  if (ti.kind == 2) {
    for (int e = tid; e < kSBM * kSBN; e += kThreads) {
      const int r = ti.row0 + e / kSBN, c = n0 + e % kSBN;
      if (r < ti.row1 && c < N)
        out[static_cast<int64_t>(r) * N + c] = Elem<T>::store(0.f);
    }
    return;
  }
  const T* wg = w + static_cast<int64_t>(ti.group) * K * N;
  const int ty = tid / 16, tx = tid % 16;
  float acc[4][4] = {};
  for (int k0 = 0; k0 < K; k0 += kSBK) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int e = tid + i * kThreads;
      const int r = e / kSBK, c = e % kSBK;
      const int gr = ti.row0 + r, gk = k0 + c;
      As[c][r] = (gr < ti.row1 && gk < K)
                     ? Elem<T>::load(x[static_cast<int64_t>(gr) * K + gk])
                     : 0.f;
      const int kr = e / kSBN, nc = e % kSBN;
      Bs[kr][nc] = (k0 + kr < K && n0 + nc < N)
                       ? Elem<T>::load(wg[static_cast<int64_t>(k0 + kr) * N + n0 + nc])
                       : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kSBK; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ti.row0 + ty + 16 * i;
    if (r >= ti.row1) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = n0 + tx + 16 * j;
      if (c < N) out[static_cast<int64_t>(r) * N + c] = Elem<T>::store(acc[i][j]);
    }
  }
}

// ---------------------------------------------------------------------------
// Tensor-core path: bf16, mma.sync m16n8k16, fp32 accumulators.
// ---------------------------------------------------------------------------
constexpr int kBM = 128, kBN = 128, kBK = 32, kStages = 3;
constexpr int kLdA = kBK + 8;   // bf16 per A row in shared memory (80 B)
constexpr int kLdB = kBN + 8;   // bf16 per B row (272 B)
constexpr int kStageA = kBM * kLdA;
constexpr int kStageB = kBK * kLdB;
constexpr int kMmaSmemBytes = kStages * (kStageA + kStageB) * 2;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  const int n = valid ? 16 : 0;  // 0: fill the 16 bytes with zeros
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__global__ void __launch_bounds__(kThreads, 2)
gmm_mma_kernel(const __nv_bfloat16* __restrict__ x,
               const __nv_bfloat16* __restrict__ w,
               const int* __restrict__ sizes, __nv_bfloat16* __restrict__ out,
               int M, int K, int N, int G, int n_row_tiles, int n_col_tiles) {
  extern __shared__ __align__(16) __nv_bfloat16 smem[];
  __nv_bfloat16* As = smem;                       // [kStages][kBM][kLdA]
  __nv_bfloat16* Bs = smem + kStages * kStageA;   // [kStages][kBK][kLdB]
  __shared__ TileInfo info;
  int rt, ct;
  tile_coords(n_row_tiles, n_col_tiles, &rt, &ct);
  if (threadIdx.x < 32) locate_tile<kBM>(sizes, G, M, rt, &info, threadIdx.x);
  __syncthreads();
  const TileInfo ti = info;
  if (ti.kind == 0) return;
  const int tid = threadIdx.x;
  const int n0 = ct * kBN;
  if (ti.kind == 2) {
    const uint4 zero = make_uint4(0, 0, 0, 0);
    for (int e = tid; e < kBM * kBN / 8; e += kThreads) {
      const int r = ti.row0 + e / (kBN / 8), c = n0 + (e % (kBN / 8)) * 8;
      if (r < ti.row1 && c < N)
        *reinterpret_cast<uint4*>(out + static_cast<int64_t>(r) * N + c) = zero;
    }
    return;
  }
  const __nv_bfloat16* wg = w + static_cast<int64_t>(ti.group) * K * N;
  const int KT = (K + kBK - 1) / kBK;

  // one k slice into stage s: A 128 x 32 and B 32 x 128, 16-byte copies,
  // two of each per thread
  auto load_stage = [&](int s, int kt) {
    const int k0 = kt * kBK;
    __nv_bfloat16* as = As + s * kStageA;
    __nv_bfloat16* bs = Bs + s * kStageB;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int v = tid + i * kThreads;
      const int r = v / (kBK / 8), c = (v % (kBK / 8)) * 8;
      const int gr = ti.row0 + r, gk = k0 + c;
      const bool ok = gr < ti.row1 && gk < K;
      cp_async16(as + r * kLdA + c, ok ? x + static_cast<int64_t>(gr) * K + gk : x, ok);
      const int kr = v / (kBN / 8), nc = (v % (kBN / 8)) * 8;
      const bool okb = k0 + kr < K && n0 + nc < N;
      cp_async16(bs + kr * kLdB + nc,
                 okb ? wg + static_cast<int64_t>(k0 + kr) * N + n0 + nc : w, okb);
    }
  };

  const int warp = tid / 32, lane = tid % 32;
  const int wm = (warp / 4) * 64;   // warp's rows in the tile
  const int wn = (warp % 4) * 32;   // warp's columns
  float acc[4][4][4] = {};          // [m16 tile][n8 tile][fragment]

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < KT) load_stage(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // slice kt landed; every warp is done with slice kt-1
    const int nk = kt + kStages - 1;
    if (nk < KT) load_stage(nk % kStages, nk);
    cp_async_commit();
    const __nv_bfloat16* as = As + (kt % kStages) * kStageA;
    const __nv_bfloat16* bs = Bs + (kt % kStages) * kStageB;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      uint32_t a[4][4], b[2][4];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        // matrices: rows 0-7 / 8-15 (lane bit 3) x k 0-7 / 8-15 (lane bit 4)
        const int r = wm + mi * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
        const int c = kk + (lane >> 4) * 8;
        ldmatrix_x4(a[mi], as + r * kLdA + c);
      }
#pragma unroll
      for (int nj = 0; nj < 2; ++nj) {
        // matrices: k 0-7 / 8-15 (lane bit 3) x n 0-7 / 8-15 (lane bit 4),
        // transposed so each thread holds (k, k+1) pairs of one n
        const int r = kk + (lane & 7) + ((lane >> 3) & 1) * 8;
        const int c = wn + nj * 16 + (lane >> 4) * 8;
        ldmatrix_x4_trans(b[nj], bs + r * kLdB + c);
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
          mma_bf16(acc[mi][ni], a[mi], b[ni / 2][(ni % 2) * 2],
                   b[ni / 2][(ni % 2) * 2 + 1]);
    }
  }
  cp_async_wait<0>();

  // C fragment: (row lane/4, cols 2*(lane%4) + {0, 1}) and row + 8
  const int fr = lane >> 2, fc = (lane & 3) * 2;
#pragma unroll
  for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = ti.row0 + wm + mi * 16 + fr + half * 8;
      if (r >= ti.row1) continue;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int c = n0 + wn + ni * 8 + fc;
        if (c >= N) continue;
        const __nv_bfloat162 v = __floats2bfloat162_rn(acc[mi][ni][half * 2],
                                                       acc[mi][ni][half * 2 + 1]);
        *reinterpret_cast<__nv_bfloat162*>(out + static_cast<int64_t>(r) * N + c) = v;
      }
    }
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

template <typename T>
cudaError_t launch_scalar(const void* x, const void* w, const int* sizes, void* out,
                          int M, int K, int N, int G, cudaStream_t stream) {
  const int n_row = (M + kSBM - 1) / kSBM + G;
  const int n_col = (N + kSBN - 1) / kSBN;
  gmm_scalar_kernel<T><<<n_row * n_col, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), sizes,
      static_cast<T*>(out), M, K, N, G, n_row, n_col);
  return cudaGetLastError();
}

cudaError_t launch_mma(const void* x, const void* w, const int* sizes, void* out,
                       int M, int K, int N, int G, cudaStream_t stream) {
  // above 48 KB of dynamic shared memory only by opting in (per device)
  const cudaError_t err = cudaFuncSetAttribute(
      gmm_mma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMmaSmemBytes);
  if (err != cudaSuccess) return err;
  const int n_row = (M + kBM - 1) / kBM + G;
  const int n_col = (N + kBN - 1) / kBN;
  gmm_mma_kernel<<<n_row * n_col, kThreads, kMmaSmemBytes, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w),
      sizes, static_cast<__nv_bfloat16*>(out), M, K, N, G, n_row, n_col);
  return cudaGetLastError();
}

// The bf16 tensor-core path takes K and N multiples of 8 and 16-byte
// aligned operands; everything else runs on the scalar path.
bool tensor_core_path(int dtype, const void* x, const void* w, const void* out,
                      int K, int N) {
  return dtype == 1 && K % 8 == 0 && N % 8 == 0 && aligned16(x) && aligned16(w) &&
         aligned16(out);
}

}  // namespace

// dtype code: 0 = float32, 1 = bfloat16 (x, w and out alike). x (M, K),
// w (G, K, N), out (M, N) contiguous; sizes (G,) int32 on the card. Returns
// a cudaError_t (0: ok). Nothing is synchronized.
extern "C" int grouped_matmul_launch(int dtype, const void* x, const void* w,
                                     const void* sizes, void* out, int M, int K,
                                     int N, int G, void* stream) {
  if (M <= 0 || N <= 0) return 0;
  if (K < 0 || G <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* sz = static_cast<const int*>(sizes);
  if (tensor_core_path(dtype, x, w, out, K, N))
    return static_cast<int>(launch_mma(x, w, sz, out, M, K, N, G, s));
  if (dtype == 0)
    return static_cast<int>(launch_scalar<float>(x, w, sz, out, M, K, N, G, s));
  if (dtype == 1)
    return static_cast<int>(launch_scalar<__nv_bfloat16>(x, w, sz, out, M, K, N, G, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

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
//     ceil(size_g / BM) row tiles that start at its own first row, so the
//     rows a tile stores never straddle two experts. Warp 0
//     finds the block's (group, rows) from the device-side sizes with a warp
//     scan, 32 groups per step. ceil(M / BM) + G row tiles cover every group
//     and, after the last group, the rows past sum(group_sizes), which are
//     written as 0; surplus row tiles exit at once;
//   * row tiles are visited in bands of 8 per column tile, so a band's x
//     tiles and a run of w's column tiles stay in the 50 MB L2 while the band
//     sweeps across N, instead of every row tile reading all of w[g] from
//     device memory;
//   * bf16 (the serving path): 128 x 256 output tiles on the tensor cores
//     through wgmma, fed by TMA. A producer warpgroup (one thread issuing,
//     its registers handed to the others with setmaxnreg) keeps a 4-stage
//     ring of 64-deep k slices full: x through a 2-D tensor map (K, M), a
//     tile of up to 128 rows from the group's first row; w through a 3-D
//     map (N, K, G) with the group as a coordinate, so one descriptor serves
//     every expert, in 4 boxes of 64 columns. Both land 128-byte swizzled;
//     full and empty mbarriers pass the stages between the roles. Two
//     consumer warpgroups each run wgmma m64n256k16 on 64 of the rows with
//     both operands in shared memory (w is N-major: the transpose bit),
//     fp32 accumulators in registers. Rows of a tile past its group belong
//     to the next group or lie past M (zeros): they are multiplied and never
//     stored, which is exact because each output row depends on its own x
//     row alone; so no load needs a mask. K past its edge arrives as zeros,
//     and the epilogue stores only rows [row0, row1) and columns < N. Each
//     consumer keeps one k slice's products in flight while it waits for
//     the next (wgmma_wait<1>), then hands the finished slice's stage back.
//     It needs K and N multiples of 8 and 16-byte aligned operands, TMA's
//     stride and address rules;
//   * fp32 (the parity runs), and bf16 shapes the tensor-core path does not
//     take: scalar FMAs on the CUDA cores, 64 x 64 tiles, 4 x 4 outputs per
//     thread, any K and N.

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper.cuh"

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
// Tensor-core path: bf16, wgmma m64n256k16 fed by TMA, fp32 accumulators.
// ---------------------------------------------------------------------------
constexpr int kBM = 128, kBN = 256, kBK = 64, kStages = 4;
constexpr int kWgThreads = 384;                 // producer + 2 consumer warpgroups
constexpr int kBoxBytes = 64 * 128;             // one TMA box: 64 rows x 128 B
constexpr int kStageA = kBM * kBK * 2;          // x tile, 16 KB: K-major
constexpr int kStageB = kBK * kBN * 2;          // w tile, 32 KB: 4 boxes of 64 n
constexpr int kWgSmemBytes = kStages * (kStageA + kStageB) + 2 * kStages * 8 + 1024;

__global__ void __launch_bounds__(kWgThreads, 1)
gmm_wgmma_kernel(const __grid_constant__ CUtensorMap x_map,
                 const __grid_constant__ CUtensorMap w_map,
                 const int* __restrict__ sizes, __nv_bfloat16* __restrict__ out, int M,
                 int K, int N, int G, int n_row_tiles, int n_col_tiles) {
  extern __shared__ uint8_t smem_raw[];
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
    for (int e = tid; e < kBM * kBN / 8; e += kWgThreads) {
      const int r = ti.row0 + e / (kBN / 8), c = n0 + (e % (kBN / 8)) * 8;
      if (r < ti.row1 && c < N)
        *reinterpret_cast<uint4*>(out + static_cast<int64_t>(r) * N + c) = zero;
    }
    return;
  }

  // swizzled tiles start on 1024-byte boundaries (of the shared window)
  uint8_t* smem = smem_raw + ((1024u - (hopper::smem_u32(smem_raw) & 1023u)) & 1023u);
  uint8_t* As = smem;                                  // [kStages][128 rows][128 B]
  uint8_t* Bs = smem + kStages * kStageA;              // [kStages][4 boxes][64 k][128 B]
  uint64_t* full = reinterpret_cast<uint64_t*>(Bs + kStages * kStageB);
  uint64_t* empty = full + kStages;
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      hopper::mbar_init(&full[s], 1);      // the producer's expect-tx arrival
      hopper::mbar_init(&empty[s], 2);     // one arrival per consumer warpgroup
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();
  const int KT = (K + kBK - 1) / kBK;

  if (tid < 128) {
    // ---- producer warpgroup: one thread keeps the ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (tid == 0) {
      hopper::tma_prefetch_desc(&x_map);
      hopper::tma_prefetch_desc(&w_map);
      int s = 0, phase = 0;
      for (int kt = 0; kt < KT; ++kt) {
        hopper::mbar_wait(&empty[s], phase ^ 1);
        hopper::mbar_arrive_expect_tx(&full[s], kStageA + kStageB);
        // up to 128 rows from the group's first row: rows past the group
        // are multiplied and never stored; past M and K they are zeros
        hopper::tma_load_2d(As + s * kStageA, &x_map, &full[s], kt * kBK, ti.row0);
#pragma unroll
        for (int j = 0; j < kBN / 64; ++j)
          hopper::tma_load_3d(Bs + s * kStageB + j * kBoxBytes, &w_map, &full[s],
                              n0 + 64 * j, kt * kBK, ti.group);
        if (++s == kStages) { s = 0; phase ^= 1; }
      }
    }
  } else {
    // ---- consumer warpgroups: rows 64c..64c+63 of the tile each
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int c = tid / 128 - 1;
    float acc[kBN / 2];
#pragma unroll
    for (int i = 0; i < kBN / 2; ++i) acc[i] = 0.f;
    const bool leader = tid % 128 == 0;
    int s = 0, phase = 0, prev = 0;
    for (int kt = 0; kt < KT; ++kt) {
      hopper::mbar_wait(&full[s], phase);
      const uint8_t* as = As + s * kStageA + c * 64 * 128;
      const uint8_t* bs = Bs + s * kStageB;
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        // x K-major: a k16 slice is 32 B into the swizzled row; w MN-major:
        // 16 k rows = 2048 B, the next 64 columns one box (LBO) on
        hopper::wgmma_m64n256k16_ss<1>(
            acc, hopper::smem_desc_sw128(as + kk * 32, 16, 1024),
            hopper::smem_desc_sw128(bs + kk * 2048, kBoxBytes, 1024), 1);
      }
      hopper::wgmma_commit();
      // keep this slice's products in flight; the previous slice's are
      // done, so its stage goes back to the producer
      hopper::wgmma_wait<1>();
      hopper::fence_regs(acc);
      if (kt > 0 && leader) hopper::mbar_arrive(&empty[prev]);
      prev = s;
      if (++s == kStages) { s = 0; phase ^= 1; }
    }
    hopper::wgmma_wait<0>();
    hopper::fence_regs(acc);
    // C fragment: warp w rows 16w + lane/4 (+ 8), cols 8i + 2(lane%4) + {0, 1}
    const int warp = (tid % 128) / 32, lane = tid % 32;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = ti.row0 + 64 * c + 16 * warp + lane / 4 + 8 * hh;
      if (r >= ti.row1) continue;
      __nv_bfloat16* orow = out + static_cast<int64_t>(r) * N;
#pragma unroll
      for (int i = 0; i < kBN / 8; ++i) {
        const int col = n0 + 8 * i + 2 * (lane & 3);
        if (col < N)
          *reinterpret_cast<uint32_t*>(orow + col) =
              hopper::pack_bf16(acc[4 * i + 2 * hh], acc[4 * i + 2 * hh + 1]);
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

cudaError_t launch_wgmma(const void* x, const void* w, const int* sizes, void* out,
                         int M, int K, int N, int G, cudaStream_t stream) {
  // x: 2-D map (K, M), boxes of 64 k x 128 rows; w: 3-D map (N, K, G), the
  // group a coordinate, boxes of 64 n x 64 k x 1 group
  CUtensorMap xm, wm;
  const uint64_t x_dims[2] = {static_cast<uint64_t>(K), static_cast<uint64_t>(M)};
  const uint64_t x_strides[1] = {static_cast<uint64_t>(K) * 2};
  const uint32_t x_box[2] = {kBK, kBM};
  const uint64_t w_dims[3] = {static_cast<uint64_t>(N), static_cast<uint64_t>(K),
                              static_cast<uint64_t>(G)};
  const uint64_t w_strides[2] = {static_cast<uint64_t>(N) * 2,
                                 static_cast<uint64_t>(N) * K * 2};
  const uint32_t w_box[3] = {64, kBK, 1};
  if (!hopper::make_tensor_map_bf16(&xm, x, 2, x_dims, x_strides, x_box) ||
      !hopper::make_tensor_map_bf16(&wm, w, 3, w_dims, w_strides, w_box))
    return cudaErrorInvalidValue;
  // above 48 KB of dynamic shared memory only by opting in (per device)
  const cudaError_t err = cudaFuncSetAttribute(
      gmm_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kWgSmemBytes);
  if (err != cudaSuccess) return err;
  const int n_row = (M + kBM - 1) / kBM + G;
  const int n_col = (N + kBN - 1) / kBN;
  gmm_wgmma_kernel<<<n_row * n_col, kWgThreads, kWgSmemBytes, stream>>>(
      xm, wm, sizes, static_cast<__nv_bfloat16*>(out), M, K, N, G, n_row, n_col);
  return cudaGetLastError();
}

// The bf16 tensor-core path takes K and N multiples of 8 (K > 0) and
// 16-byte aligned operands, which are also TMA's rules for a tensor map's
// strides and base; everything else runs on the scalar path.
bool tensor_core_path(int dtype, const void* x, const void* w, const void* out,
                      int K, int N) {
  return dtype == 1 && K > 0 && K % 8 == 0 && N % 8 == 0 && aligned16(x) &&
         aligned16(w) && aligned16(out);
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
    return static_cast<int>(launch_wgmma(x, w, sz, out, M, K, N, G, s));
  if (dtype == 0)
    return static_cast<int>(launch_scalar<float>(x, w, sz, out, M, K, N, G, s));
  if (dtype == 1)
    return static_cast<int>(launch_scalar<__nv_bfloat16>(x, w, sz, out, M, K, N, G, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

// Which kernel grouped_matmul_launch takes for these operands: 1 the wgmma
// kernel, 0 the scalar one.
extern "C" int grouped_matmul_path(int dtype, const void* x, const void* w,
                                   const void* out, int K, int N) {
  return tensor_core_path(dtype, x, w, out, K, N) ? 1 : 0;
}

// Grouped (ragged) matmul for Hopper (sm_90a): the MoE expert products and
// their two gradients.
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
// The backward has no TPU kernel behind it (JAX differentiates
// lax.ragged_dot, src/repro/models/ffn.py:119). Two more kernels compute
// it, with the same conventions:
//
//   dx[r] = dy[r] @ w[g]^T                  rows past offsets[G]: 0
//   dw[g] = sum over r in g, ascending, of x[r]^T dy[r]   empty group: 0
//
// What bounds them on this card: at the MoE prefill's shapes (65,536 sorted
// token-expert rows, K 6144, N 10752, 16 experts) arithmetic, 8.7 TFLOP
// against 4.3 GB, some 2,000 flops per byte, far above the H100's ridge of
// ~295 for bf16; dx and dw do the same flops. At decode's and training's
// shapes (32 or ~2,000 rows over 16 experts) it is the expert weights'
// bytes, read (forward, dx) or written (dw) once: 2.1 GB per bf16 leaf.
//
// What the design does about it:
//   * each output tile of out / dx belongs to one group. The Pallas grid
//     visits all G groups for every row block and masks the rows it does
//     not own; here a block of row tiles is counted per group instead:
//     group g owns ceil(size_g / BM) row tiles that start at its own first
//     row, so the rows a tile stores never straddle two experts. Warp 0
//     finds the block's (group, rows) from the device-side sizes with a warp
//     scan, 32 groups per step. ceil(M / BM) + G row tiles cover every group
//     and, after the last group, the rows past sum(group_sizes), which are
//     written as 0; surplus row tiles exit at once;
//   * row tiles are visited in bands of 8 per column tile, so a band's x
//     tiles and a run of w's column tiles stay in the 50 MB L2 while the band
//     sweeps across N, instead of every row tile reading all of w[g] from
//     device memory;
//   * bf16: 128 x 256 output tiles on the tensor cores through wgmma, fed
//     by TMA. A producer warpgroup (one thread issuing, its registers handed
//     to the others with setmaxnreg) keeps a 4-stage ring of 64-deep
//     reduction slices full; full and empty mbarriers pass the stages
//     between the roles; two consumer warpgroups each run wgmma m64n256k16
//     on 64 of the tile's rows with both operands in shared memory, fp32
//     accumulators in registers. Each consumer keeps one slice's products in
//     flight while it waits for the next (wgmma_wait<1>), then hands the
//     finished slice's stage back. Tiles land 128-byte swizzled. It needs
//     the reduced and the stored widths multiples of 8 and 16-byte aligned
//     operands, TMA's stride and address rules:
//       - forward: x through a 2-D tensor map (K, M), a tile of up to 128
//         rows from the group's first row; w through a 3-D map (N, K, G)
//         with the group as a coordinate, so one descriptor serves every
//         expert, in 4 boxes of 64 n x 64 k: B is N-major (the transpose
//         bit). Rows of a tile past its group belong to the next group or
//         lie past M (zeros): they are multiplied and never stored, which
//         is exact because each output row depends on its own x row alone;
//         so no load needs a mask;
//       - dx: the same kernel over dy (N, M) with the reduction along N,
//         w's contiguous dim: the same w map, boxes of 64 n x 64 k taken at
//         (reduction slice, output column), land K-major, wgmma's native B
//         layout. So dx reads w in place: no transposed copy of the weights;
//       - dw: 128 (K) x 256 (N) tiles of one group each, the group's rows
//         the reduction, in ascending 64-row slices: A = x_g^T and B = dy_g,
//         both N-major (x's K and dy's N contiguous), both through 2-D maps
//         with 64-row boxes. A slice that runs past the group's end has
//         loaded the next group's rows (or rows past M, zeros): the
//         consumers zero those rows of both operands in shared memory, fence
//         the generic writes against the async proxy, meet at a named
//         barrier, and only then multiply. No float atomics, no split over
//         the rows: each dw element is one fp32 sum in row order, so the
//         gradient is the same bits on every run. An empty group's tiles are
//         stored as zeros. At the training shape (~128 rows a group) a
//         tile is two slices and a 64 KB store, so the store decides the
//         time: blocks are persistent, one an SM, each walking tiles with
//         a stride of the grid, the producer loading the next tiles'
//         slices while the consumers store; and the consumers stage the
//         tile in shared memory (3 ring stages leave room for it) and
//         write whole 512-byte rows, where the accumulator fragment's own
//         layout gives 16-byte pieces of 8 rows per store instruction
//         (2.3 -> 1.0 ms at dbrx's training shape on an H100);
//   * fp32 (the parity runs), and bf16 shapes the tensor-core path does not
//     take: scalar FMAs on the CUDA cores, 64 x 64 tiles, 4 x 4 outputs per
//     thread, any K and N; dx reads w transposed through its strides, dw
//     sums 16 rows of the group at a time.

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

// Run by all 32 lanes of warp 0: group g's rows [rows[0], rows[1]), clipped
// to M as the forward clips them.
__device__ void group_rows(const int* __restrict__ sizes, int g, int M, int* rows,
                           int lane) {
  int before = 0;
  for (int i = lane; i < g; i += 32) before += max(sizes[i], 0);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) before += __shfl_xor_sync(0xffffffffu, before, o);
  if (lane == 0) {
    rows[0] = min(before, M);
    rows[1] = min(before + max(sizes[g], 0), M);
  }
}

// Block `bid` -> (row tile, column tile), bands of kBandRows row tiles.
__device__ __forceinline__ void tile_coords(int bid, int n_row_tiles, int n_col_tiles,
                                            int* rt, int* ct) {
  const int per_band = kBandRows * n_col_tiles;
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

// out (M, C) = a (M, R) times group g's matrix, reduced over R. Forward:
// a = x, R = K, C = N, element (red, col) of w[g] at red * C + col. dx
// (kDx): a = dy, R = N, C = K, the element at col * R + red (w[g]^T).
template <typename T, bool kDx>
__device__ __forceinline__ void scalar_tile(const T* __restrict__ a,
                                            const T* __restrict__ w,
                                            const int* __restrict__ sizes,
                                            T* __restrict__ out, int M, int R, int C,
                                            int G, int n_row_tiles, int n_col_tiles) {
  __shared__ float As[kSBK][kSBM + 4];  // a tile, transposed
  __shared__ float Bs[kSBK][kSBN + 4];
  __shared__ TileInfo info;
  int rt, ct;
  tile_coords(static_cast<int>(blockIdx.x), n_row_tiles, n_col_tiles, &rt, &ct);
  if (threadIdx.x < 32) locate_tile<kSBM>(sizes, G, M, rt, &info, threadIdx.x);
  __syncthreads();
  const TileInfo ti = info;
  if (ti.kind == 0) return;
  const int tid = threadIdx.x;
  const int n0 = ct * kSBN;
  if (ti.kind == 2) {
    for (int e = tid; e < kSBM * kSBN; e += kThreads) {
      const int r = ti.row0 + e / kSBN, c = n0 + e % kSBN;
      if (r < ti.row1 && c < C)
        out[static_cast<int64_t>(r) * C + c] = Elem<T>::store(0.f);
    }
    return;
  }
  const T* wg = w + static_cast<int64_t>(ti.group) * R * C;
  const int ty = tid / 16, tx = tid % 16;
  float acc[4][4] = {};
  for (int k0 = 0; k0 < R; k0 += kSBK) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int e = tid + i * kThreads;
      const int r = e / kSBK, c = e % kSBK;
      const int gr = ti.row0 + r, gk = k0 + c;
      As[c][r] = (gr < ti.row1 && gk < R)
                     ? Elem<T>::load(a[static_cast<int64_t>(gr) * R + gk])
                     : 0.f;
      // neighbouring threads on neighbouring addresses of w in both cases
      const int kr = kDx ? e % kSBK : e / kSBN, nc = kDx ? e / kSBK : e % kSBN;
      const int64_t at = kDx ? static_cast<int64_t>(n0 + nc) * R + k0 + kr
                             : static_cast<int64_t>(k0 + kr) * C + n0 + nc;
      Bs[kr][nc] = (k0 + kr < R && n0 + nc < C) ? Elem<T>::load(wg[at]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kSBK; ++kk) {
      float av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = As[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = Bs[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
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
      if (c < C) out[static_cast<int64_t>(r) * C + c] = Elem<T>::store(acc[i][j]);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
gmm_scalar_kernel(const T* __restrict__ x, const T* __restrict__ w,
                  const int* __restrict__ sizes, T* __restrict__ out, int M, int K,
                  int N, int G, int n_row_tiles, int n_col_tiles) {
  scalar_tile<T, false>(x, w, sizes, out, M, K, N, G, n_row_tiles, n_col_tiles);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
gmm_dx_scalar_kernel(const T* __restrict__ dy, const T* __restrict__ w,
                     const int* __restrict__ sizes, T* __restrict__ dx, int M, int K,
                     int N, int G, int n_row_tiles, int n_col_tiles) {
  scalar_tile<T, true>(dy, w, sizes, dx, M, N, K, G, n_row_tiles, n_col_tiles);
}

// dw[g] (K, N) tile (k0, n0) = sum over the group's rows, 16 at a time in
// ascending order, of x[r]^T dy[r]; an empty group stores zeros.
template <typename T>
__global__ void __launch_bounds__(kThreads)
gmm_dw_scalar_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                     const int* __restrict__ sizes, T* __restrict__ dw, int M, int K,
                     int N, int G, int n_k_tiles, int n_n_tiles) {
  __shared__ float As[kSBK][kSBM + 4];  // 16 rows x 64 k of x
  __shared__ float Bs[kSBK][kSBN + 4];  // 16 rows x 64 n of dy
  __shared__ int rows[2];
  const int per_group = n_k_tiles * n_n_tiles;
  const int g = static_cast<int>(blockIdx.x) / per_group;
  int kt, nt;
  tile_coords(static_cast<int>(blockIdx.x) - g * per_group, n_k_tiles, n_n_tiles, &kt, &nt);
  if (threadIdx.x < 32) group_rows(sizes, g, M, rows, threadIdx.x);
  __syncthreads();
  const int row0 = rows[0], row1 = rows[1];
  const int tid = threadIdx.x;
  const int k0 = kt * kSBM, n0 = nt * kSBN;
  const int ty = tid / 16, tx = tid % 16;
  float acc[4][4] = {};
  for (int r0 = row0; r0 < row1; r0 += kSBK) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int e = tid + i * kThreads;
      const int r = e / kSBM, c = e % kSBM;
      const bool live = r0 + r < row1;
      As[r][c] = (live && k0 + c < K)
                     ? Elem<T>::load(x[static_cast<int64_t>(r0 + r) * K + k0 + c])
                     : 0.f;
      Bs[r][c] = (live && n0 + c < N)
                     ? Elem<T>::load(dy[static_cast<int64_t>(r0 + r) * N + n0 + c])
                     : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int rr = 0; rr < kSBK; ++rr) {
      float av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = As[rr][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = Bs[rr][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
  T* dwg = dw + static_cast<int64_t>(g) * K * N;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int k = k0 + ty + 16 * i;
    if (k >= K) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n < N) dwg[static_cast<int64_t>(k) * N + n] = Elem<T>::store(acc[i][j]);
    }
  }
}

// ---------------------------------------------------------------------------
// Tensor-core path: bf16, wgmma m64n256k16 fed by TMA, fp32 accumulators.
// ---------------------------------------------------------------------------
constexpr int kBM = 128, kBN = 256, kBK = 64, kStages = 4;
constexpr int kWgThreads = 384;                 // producer + 2 consumer warpgroups
constexpr int kBoxBytes = 64 * 128;             // one TMA box: 64 rows x 128 B
constexpr int kStageA = kBM * kBK * 2;          // A tile, 16 KB
constexpr int kStageB = kBK * kBN * 2;          // B tile, 32 KB: 4 boxes
constexpr int kWgSmemBytes = kStages * (kStageA + kStageB) + 2 * kStages * 8 + 1024;
// dw: 3 stages, then the output tile staged for coalesced stores, rows
// padded by 16 B so that the fragment's writes hit 32 distinct banks
constexpr int kDwStages = 3;
constexpr int kDwOutStride = kBN * 2 + 16;       // bytes per staged row
constexpr int kDwSmemBytes = kDwStages * (kStageA + kStageB) + 2 * kDwStages * 8 + 1024 +
                             16 + kBM * kDwOutStride;

// The shared-memory ring of the tensor-core kernels: STAGES A and B stages
// on 1024-byte boundaries (the swizzle's period), then the full and empty
// barriers, initialised by thread 0; the caller syncs the block.
struct Ring {
  uint8_t* as;
  uint8_t* bs;
  uint64_t* full;
  uint64_t* empty;
};

template <int STAGES>
__device__ __forceinline__ Ring make_ring(uint8_t* smem_raw) {
  Ring ring;
  uint8_t* smem = smem_raw + ((1024u - (hopper::smem_u32(smem_raw) & 1023u)) & 1023u);
  ring.as = smem;                                  // [STAGES][kStageA]
  ring.bs = smem + STAGES * kStageA;               // [STAGES][4 boxes][64 rows][128 B]
  ring.full = reinterpret_cast<uint64_t*>(ring.bs + STAGES * kStageB);
  ring.empty = ring.full + STAGES;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      hopper::mbar_init(&ring.full[s], 1);     // the producer's expect-tx arrival
      hopper::mbar_init(&ring.empty[s], 2);    // one arrival per consumer warpgroup
    }
    hopper::mbar_fence_init();
  }
  return ring;
}

// out (M, C) = a (M, R) @ group matrix, R reduced in 64-deep slices.
// Forward: a = x (R = K), B = w[g] N-major. dx (kDx): a = dy (R = N),
// B = w[g]^T, read K-major from the same (N, K, G) map.
template <bool kDx>
__device__ __forceinline__ void wgmma_tile(const CUtensorMap* a_map,
                                           const CUtensorMap* w_map,
                                           const int* __restrict__ sizes,
                                           __nv_bfloat16* __restrict__ out, int M, int R,
                                           int C, int G, int n_row_tiles,
                                           int n_col_tiles) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ TileInfo info;
  int rt, ct;
  tile_coords(static_cast<int>(blockIdx.x), n_row_tiles, n_col_tiles, &rt, &ct);
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
      if (r < ti.row1 && c < C)
        *reinterpret_cast<uint4*>(out + static_cast<int64_t>(r) * C + c) = zero;
    }
    return;
  }

  const Ring ring = make_ring<kStages>(smem_raw);
  __syncthreads();
  const int KT = (R + kBK - 1) / kBK;

  if (tid < 128) {
    // ---- producer warpgroup: one thread keeps the ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (tid == 0) {
      hopper::tma_prefetch_desc(a_map);
      hopper::tma_prefetch_desc(w_map);
      int s = 0, phase = 0;
      for (int kt = 0; kt < KT; ++kt) {
        hopper::mbar_wait(&ring.empty[s], phase ^ 1);
        hopper::mbar_arrive_expect_tx(&ring.full[s], kStageA + kStageB);
        // up to 128 rows from the group's first row: rows past the group
        // are multiplied and never stored; past M and R they are zeros
        hopper::tma_load_2d(ring.as + s * kStageA, a_map, &ring.full[s], kt * kBK,
                            ti.row0);
#pragma unroll
        for (int j = 0; j < kBN / 64; ++j) {
          // forward: 64 output columns (n) x 64 k rows; dx: 64 reduction
          // values (n) x 64 output columns (k), i.e. 64 K-major rows
          uint8_t* dst = ring.bs + s * kStageB + j * kBoxBytes;
          if (kDx)
            hopper::tma_load_3d(dst, w_map, &ring.full[s], kt * kBK, n0 + 64 * j, ti.group);
          else
            hopper::tma_load_3d(dst, w_map, &ring.full[s], n0 + 64 * j, kt * kBK, ti.group);
        }
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
      hopper::mbar_wait(&ring.full[s], phase);
      const uint8_t* as = ring.as + s * kStageA + c * 64 * 128;
      const uint8_t* bs = ring.bs + s * kStageB;
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        // a K-major: a k16 slice is 32 B into the swizzled row. Forward,
        // w N-major: 16 k rows = 2048 B, the next 64 columns one box (LBO);
        // dx, w^T K-major: 32 B into each of its 256 rows, like a
        if (kDx)
          hopper::wgmma_m64n256k16_ss<0>(
              acc, hopper::smem_desc_sw128(as + kk * 32, 16, 1024),
              hopper::smem_desc_sw128(bs + kk * 32, 16, 1024), 1);
        else
          hopper::wgmma_m64n256k16_ss<1>(
              acc, hopper::smem_desc_sw128(as + kk * 32, 16, 1024),
              hopper::smem_desc_sw128(bs + kk * 2048, kBoxBytes, 1024), 1);
      }
      hopper::wgmma_commit();
      // keep this slice's products in flight; the previous slice's are
      // done, so its stage goes back to the producer
      hopper::wgmma_wait<1>();
      hopper::fence_regs(acc);
      if (kt > 0 && leader) hopper::mbar_arrive(&ring.empty[prev]);
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
      __nv_bfloat16* orow = out + static_cast<int64_t>(r) * C;
#pragma unroll
      for (int i = 0; i < kBN / 8; ++i) {
        const int col = n0 + 8 * i + 2 * (lane & 3);
        if (col < C)
          *reinterpret_cast<uint32_t*>(orow + col) =
              hopper::pack_bf16(acc[4 * i + 2 * hh], acc[4 * i + 2 * hh + 1]);
      }
    }
  }
}

__global__ void __launch_bounds__(kWgThreads, 1)
gmm_wgmma_kernel(const __grid_constant__ CUtensorMap x_map,
                 const __grid_constant__ CUtensorMap w_map,
                 const int* __restrict__ sizes, __nv_bfloat16* __restrict__ out, int M,
                 int K, int N, int G, int n_row_tiles, int n_col_tiles) {
  wgmma_tile<false>(&x_map, &w_map, sizes, out, M, K, N, G, n_row_tiles, n_col_tiles);
}

__global__ void __launch_bounds__(kWgThreads, 1)
gmm_dx_wgmma_kernel(const __grid_constant__ CUtensorMap dy_map,
                    const __grid_constant__ CUtensorMap w_map,
                    const int* __restrict__ sizes, __nv_bfloat16* __restrict__ dx, int M,
                    int K, int N, int G, int n_row_tiles, int n_col_tiles) {
  wgmma_tile<true>(&dy_map, &w_map, sizes, dx, M, N, K, G, n_row_tiles, n_col_tiles);
}

// Run by all 32 lanes of warp 0: off[g] = the first row of group g and
// off[G] = the end of the last, cumulative sums clipped to M as the forward
// clips them, so group g's rows are [off[g], off[g + 1]).
__device__ void group_offsets(const int* __restrict__ sizes, int G, int M,
                              int* off, int lane) {
  int carry = 0;
  for (int base = 0; base < G; base += 32) {
    const int g = base + lane;
    const int incl = warp_inclusive_scan(g < G ? max(sizes[g], 0) : 0, lane);
    if (g < G) off[g + 1] = min(carry + incl, M);
    carry += __shfl_sync(0xffffffffu, incl, 31);
  }
  if (lane == 0) off[0] = 0;
}

// dw tiles, persistent: each block walks tiles blockIdx.x, + gridDim.x, ...
// of the G x ceil(K / 128) x ceil(N / 256) grid (bands of 8 k tiles per n
// tile within a group, so the blocks in flight share x and dy tiles in L2).
// Tile (g, k0, n0): A = x_g^T (two boxes of 64 k x 64 rows, one per
// consumer), B = dy_g (four boxes of 64 n x 64 rows), both N-major; the
// group's rows are the reduction. The producer runs on into the next
// tiles' slices while the consumers store a tile, which at the training
// shape (~128 rows a group: two slices, then 64 KB to store) is most of a
// tile's time; the store goes through shared memory, whole rows at a time.
__global__ void __launch_bounds__(kWgThreads, 1)
gmm_dw_wgmma_kernel(const __grid_constant__ CUtensorMap x_map,
                    const __grid_constant__ CUtensorMap dy_map,
                    const int* __restrict__ sizes, __nv_bfloat16* __restrict__ dw, int M,
                    int K, int N, int G, int n_k_tiles, int n_n_tiles) {
  extern __shared__ uint8_t smem_raw[];
  const Ring ring = make_ring<kDwStages>(smem_raw);
  // the staged output tile (16-byte aligned), then the G + 1 row offsets
  uint8_t* obuf = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(ring.empty + kDwStages) + 15) & ~uintptr_t{15});
  int* off = reinterpret_cast<int*>(obuf + kBM * kDwOutStride);
  if (threadIdx.x < 32) group_offsets(sizes, G, M, off, threadIdx.x);
  __syncthreads();
  const int tid = threadIdx.x;
  const int per_group = n_k_tiles * n_n_tiles;
  const int n_tiles = G * per_group;
  // tile t -> group g, first k row k0, first n column n0
  auto locate = [&](int t, int* g, int* k0, int* n0) {
    *g = t / per_group;
    int kt, nt;
    tile_coords(t - *g * per_group, n_k_tiles, n_n_tiles, &kt, &nt);
    *k0 = kt * kBM;
    *n0 = nt * kBN;
  };

  if (tid < 128) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (tid == 0) {
      hopper::tma_prefetch_desc(&x_map);
      hopper::tma_prefetch_desc(&dy_map);
      int s = 0, phase = 0;
      for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
        int g, k0, n0;
        locate(t, &g, &k0, &n0);
        for (int r = off[g]; r < off[g + 1]; r += kBK) {
          hopper::mbar_wait(&ring.empty[s], phase ^ 1);
          hopper::mbar_arrive_expect_tx(&ring.full[s], kStageA + kStageB);
#pragma unroll
          for (int j = 0; j < kBM / 64; ++j)
            hopper::tma_load_2d(ring.as + s * kStageA + j * kBoxBytes, &x_map,
                                &ring.full[s], k0 + 64 * j, r);
#pragma unroll
          for (int j = 0; j < kBN / 64; ++j)
            hopper::tma_load_2d(ring.bs + s * kStageB + j * kBoxBytes, &dy_map,
                                &ring.full[s], n0 + 64 * j, r);
          if (++s == kDwStages) { s = 0; phase ^= 1; }
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int c = tid / 128 - 1;
    const bool leader = tid % 128 == 0;
    const int warp = (tid % 128) / 32, lane = tid % 32;
    float acc[kBN / 2];
    int s = 0, phase = 0;
    for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
      int g, k0, n0;
      locate(t, &g, &k0, &n0);
      const int row0 = off[g], row1 = off[g + 1];
#pragma unroll
      for (int i = 0; i < kBN / 2; ++i) acc[i] = 0.f;
      int prev = 0;
      for (int r = row0; r < row1; r += kBK) {
        hopper::mbar_wait(&ring.full[s], phase);
        uint8_t* as = ring.as + s * kStageA;
        uint8_t* bs = ring.bs + s * kStageB;
        const int live = row1 - r;   // rows of the slice in the group
        if (live < kBK) {
          // the slice ran into the next group (or past M): zero rows
          // live..63 of A's box c and B's boxes 2c, 2c + 1. A row is 128 B
          // of its box whatever the swizzle (it permutes 16-byte chunks
          // within the row), so the row's bytes are [128 row, 128 row + 128)
          const uint4 zero = make_uint4(0, 0, 0, 0);
          const int chunks = (kBK - live) * 8, lt = tid - 128 * (c + 1);
          for (int e = lt; e < 3 * chunks; e += 128) {
            const int box = e / chunks, at = live * 128 + (e % chunks) * 16;
            uint8_t* base = box == 0 ? as + c * kBoxBytes : bs + (2 * c + box - 1) * kBoxBytes;
            *reinterpret_cast<uint4*>(base + at) = zero;
          }
          hopper::fence_proxy_async_smem();
          hopper::named_bar_sync(1, 256);
        }
        hopper::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kBK / 16; ++kk) {
          // both N-major: 16 rows = 2048 B a k16 slice; A is one box (64 k),
          // B's next 64 columns one box on (LBO)
          hopper::wgmma_m64n256k16_ss<1, 1>(
              acc, hopper::smem_desc_sw128(as + c * kBoxBytes + kk * 2048, kBoxBytes, 1024),
              hopper::smem_desc_sw128(bs + kk * 2048, kBoxBytes, 1024), 1);
        }
        hopper::wgmma_commit();
        // keep this slice's products in flight; the previous slice's are
        // done, so its stage goes back to the producer
        hopper::wgmma_wait<1>();
        hopper::fence_regs(acc);
        if (r > row0 && leader) hopper::mbar_arrive(&ring.empty[prev]);
        prev = s;
        if (++s == kDwStages) { s = 0; phase ^= 1; }
      }
      hopper::wgmma_wait<0>();
      hopper::fence_regs(acc);
      if (row1 > row0 && leader) hopper::mbar_arrive(&ring.empty[prev]);
      // the tile through shared memory, each warpgroup its 64 rows (an
      // empty group stores its zeros): the C fragment (rows k = 64c + 16
      // warp + lane/4 (+ 8), columns n) in 4-byte pieces into the staged
      // rows, then whole 512-byte rows out, a warp a row, 16 B a lane
      hopper::named_bar_sync(2 + c, 128);      // the last tile's rows are out
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        uint8_t* orow = obuf + (64 * c + 16 * warp + lane / 4 + 8 * hh) * kDwOutStride;
#pragma unroll
        for (int i = 0; i < kBN / 8; ++i)
          *reinterpret_cast<uint32_t*>(orow + (8 * i + 2 * (lane & 3)) * 2) =
              hopper::pack_bf16(acc[4 * i + 2 * hh], acc[4 * i + 2 * hh + 1]);
      }
      hopper::named_bar_sync(2 + c, 128);
      __nv_bfloat16* dwg = dw + static_cast<int64_t>(g) * K * N;
      for (int e = tid - 128 * (c + 1); e < 64 * (kBN / 8); e += 128) {
        const int row = 64 * c + e / (kBN / 8), chunk = e % (kBN / 8);
        const int k = k0 + row, col = n0 + 8 * chunk;
        if (k < K && col < N)
          *reinterpret_cast<uint4*>(dwg + static_cast<int64_t>(k) * N + col) =
              *reinterpret_cast<const uint4*>(obuf + row * kDwOutStride + 16 * chunk);
      }
    }
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

// Forward (dx false) or dx: a (M, R), out (M, C), R = K / C = N forward and
// R = N / C = K for dx; w (G, K, N) either way.
template <typename T>
cudaError_t launch_scalar(bool dx, const void* a, const void* w, const int* sizes,
                          void* out, int M, int K, int N, int G, cudaStream_t stream) {
  const int C = dx ? K : N;
  const int n_row = (M + kSBM - 1) / kSBM + G;
  const int n_col = (C + kSBN - 1) / kSBN;
  const T* at = static_cast<const T*>(a);
  const T* wt = static_cast<const T*>(w);
  T* ot = static_cast<T*>(out);
  if (dx)
    gmm_dx_scalar_kernel<T><<<n_row * n_col, kThreads, 0, stream>>>(
        at, wt, sizes, ot, M, K, N, G, n_row, n_col);
  else
    gmm_scalar_kernel<T><<<n_row * n_col, kThreads, 0, stream>>>(
        at, wt, sizes, ot, M, K, N, G, n_row, n_col);
  return cudaGetLastError();
}

// The w map both tensor-core kernels share: 3-D (N, K, G), the group a
// coordinate, boxes of 64 n x 64 k x 1 group.
bool w_map(CUtensorMap* map, const void* w, int K, int N, int G) {
  const uint64_t dims[3] = {static_cast<uint64_t>(N), static_cast<uint64_t>(K),
                            static_cast<uint64_t>(G)};
  const uint64_t strides[2] = {static_cast<uint64_t>(N) * 2,
                               static_cast<uint64_t>(N) * K * 2};
  const uint32_t box[3] = {64, kBK, 1};
  return hopper::make_tensor_map_bf16(map, w, 3, dims, strides, box);
}

// A row-major (rows, width) bf16 matrix as a 2-D map, boxes of 64 columns
// x box_rows rows.
bool rows_map(CUtensorMap* map, const void* base, int rows, int width, uint32_t box_rows) {
  const uint64_t dims[2] = {static_cast<uint64_t>(width), static_cast<uint64_t>(rows)};
  const uint64_t strides[1] = {static_cast<uint64_t>(width) * 2};
  const uint32_t box[2] = {64, box_rows};
  return hopper::make_tensor_map_bf16(map, base, 2, dims, strides, box);
}

// Above 48 KB of dynamic shared memory only by opting in (per device).
template <typename Kernel>
cudaError_t opt_in_smem(Kernel kernel) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              kWgSmemBytes);
}

cudaError_t launch_wgmma(bool dx, const void* a, const void* w, const int* sizes,
                         void* out, int M, int K, int N, int G, cudaStream_t stream) {
  const int R = dx ? N : K, C = dx ? K : N;
  CUtensorMap am, wm;
  if (!rows_map(&am, a, M, R, kBM) || !w_map(&wm, w, K, N, G))
    return cudaErrorInvalidValue;
  const cudaError_t err = opt_in_smem(dx ? gmm_dx_wgmma_kernel : gmm_wgmma_kernel);
  if (err != cudaSuccess) return err;
  const int n_row = (M + kBM - 1) / kBM + G;
  const int n_col = (C + kBN - 1) / kBN;
  auto* o = static_cast<__nv_bfloat16*>(out);
  if (dx)
    gmm_dx_wgmma_kernel<<<n_row * n_col, kWgThreads, kWgSmemBytes, stream>>>(
        am, wm, sizes, o, M, K, N, G, n_row, n_col);
  else
    gmm_wgmma_kernel<<<n_row * n_col, kWgThreads, kWgSmemBytes, stream>>>(
        am, wm, sizes, o, M, K, N, G, n_row, n_col);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dw_scalar(const void* x, const void* dy, const int* sizes, void* dw,
                             int M, int K, int N, int G, cudaStream_t stream) {
  const int n_k = (K + kSBM - 1) / kSBM, n_n = (N + kSBN - 1) / kSBN;
  gmm_dw_scalar_kernel<T><<<G * n_k * n_n, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dy), sizes, static_cast<T*>(dw),
      M, K, N, G, n_k, n_n);
  return cudaGetLastError();
}

cudaError_t launch_dw_wgmma(const void* x, const void* dy, const int* sizes, void* dw,
                            int M, int K, int N, int G, cudaStream_t stream) {
  CUtensorMap xm, dym;
  if (!rows_map(&xm, x, M, K, kBK) || !rows_map(&dym, dy, M, N, kBK))
    return cudaErrorInvalidValue;
  // the ring, the staged output tile, then the G + 1 row offsets
  const int smem = kDwSmemBytes + 4 * (G + 1);
  cudaError_t err = cudaFuncSetAttribute(
      gmm_dw_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  int device = 0, sms = 0;
  err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  const int n_k = (K + kBM - 1) / kBM, n_n = (N + kBN - 1) / kBN;
  const int64_t n_tiles = static_cast<int64_t>(G) * n_k * n_n;
  if (n_tiles > INT32_MAX) return cudaErrorInvalidValue;
  const int grid = static_cast<int>(n_tiles < sms ? n_tiles : sms);   // one block an SM
  gmm_dw_wgmma_kernel<<<grid, kWgThreads, smem, stream>>>(
      xm, dym, sizes, static_cast<__nv_bfloat16*>(dw), M, K, N, G, n_k, n_n);
  return cudaGetLastError();
}

// The bf16 tensor-core path takes a reduced width R > 0 and a stored width
// C, both multiples of 8, and 16-byte aligned operands, which are also
// TMA's rules for a tensor map's strides and base; everything else runs on
// the scalar path.
bool tensor_core_path(int dtype, const void* a, const void* b, const void* out, int R,
                      int C) {
  return dtype == 1 && R > 0 && R % 8 == 0 && C % 8 == 0 && aligned16(a) &&
         aligned16(b) && aligned16(out);
}

}  // namespace

// dtype code: 0 = float32, 1 = bfloat16 (every operand alike). x (M, K),
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
    return static_cast<int>(launch_wgmma(false, x, w, sz, out, M, K, N, G, s));
  if (dtype == 0)
    return static_cast<int>(launch_scalar<float>(false, x, w, sz, out, M, K, N, G, s));
  if (dtype == 1)
    return static_cast<int>(
        launch_scalar<__nv_bfloat16>(false, x, w, sz, out, M, K, N, G, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

// dx (M, K) = dy (M, N) times each row's w[g]^T, rows past the groups 0;
// w (G, K, N). Same conventions as grouped_matmul_launch.
extern "C" int grouped_matmul_dx_launch(int dtype, const void* dy, const void* w,
                                        const void* sizes, void* dx, int M, int K,
                                        int N, int G, void* stream) {
  if (M <= 0 || K <= 0) return 0;
  if (N < 0 || G <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* sz = static_cast<const int*>(sizes);
  if (tensor_core_path(dtype, dy, w, dx, N, K))
    return static_cast<int>(launch_wgmma(true, dy, w, sz, dx, M, K, N, G, s));
  if (dtype == 0)
    return static_cast<int>(launch_scalar<float>(true, dy, w, sz, dx, M, K, N, G, s));
  if (dtype == 1)
    return static_cast<int>(
        launch_scalar<__nv_bfloat16>(true, dy, w, sz, dx, M, K, N, G, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

// dw (G, K, N): dw[g] = x_g^T dy_g over group g's rows, x (M, K), dy (M, N);
// every group's tile is written, an empty group's as 0. Same conventions.
extern "C" int grouped_matmul_dw_launch(int dtype, const void* x, const void* dy,
                                        const void* sizes, void* dw, int M, int K,
                                        int N, int G, void* stream) {
  if (G <= 0 || M < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (K <= 0 || N <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* sz = static_cast<const int*>(sizes);
  // no rows at all: the scalar kernel writes the zeros (a tensor map needs M > 0)
  if (M > 0 && tensor_core_path(dtype, x, dy, dw, K, N))
    return static_cast<int>(launch_dw_wgmma(x, dy, sz, dw, M, K, N, G, s));
  if (dtype == 0)
    return static_cast<int>(launch_dw_scalar<float>(x, dy, sz, dw, M, K, N, G, s));
  if (dtype == 1)
    return static_cast<int>(launch_dw_scalar<__nv_bfloat16>(x, dy, sz, dw, M, K, N, G, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

// Which kernel each launch takes for these operands: 1 the wgmma kernel,
// 0 the scalar one. `which`: 0 forward (a = x, b = w), 1 dx (a = dy,
// b = w), 2 dw (a = x, b = dy).
extern "C" int grouped_matmul_path(int which, int dtype, const void* a, const void* b,
                                   const void* out, int M, int K, int N) {
  if (which == 1) return tensor_core_path(dtype, a, b, out, N, K) ? 1 : 0;
  if (which == 2) return M > 0 && tensor_core_path(dtype, a, b, out, K, N) ? 1 : 0;
  return tensor_core_path(dtype, a, b, out, K, N) ? 1 : 0;
}

// Flash attention backward for Hopper (sm_90a): bf16 on wgmma fed by TMA,
// causal or not, GQA, deterministic.
//
// Replaces no TPU kernel: the JAX model trains through a plain einsum
// attention, and its Pallas flash kernel (src/repro/kernels/flash_attention.py)
// has no backward. The port's training attention runs the forward kernel
// (csrc/flash_attention.cu) with its log-sum-exp output and this backward
// (kernels/flash_attention_bwd.py::FlashAttention), so that no (S, S) score
// tensor is ever stored and every product runs on the tensor cores.
//
// Given q (B, S, Hq, hd), k (B, S, Hkv, hd) and v (B, S, Hkv, hd_v), the
// forward's output o and its gradient do (B, S, Hq, hd_v) (all bf16) and
// lse (B, Hq, S) fp32, with the scaled scores
// s_ij = q_i . k_j / sqrt(hd) and P_ij = exp(s_ij - lse_i) over the live keys
// (j <= i when causal; every key otherwise):
//
//   D_i  = sum_d do_id o_id                      (fp32, the dq pass writes it)
//   dP   = do v^T,   dS_ij = P_ij (dP_ij - D_i)
//   dq   = dS k / sqrt(hd),   dk = dS^T q / sqrt(hd),   dv = P^T do
//
// summed over the query heads h of kv head h / (Hq / Hkv) for dk and dv.
//
// What bounds it on this card: arithmetic. Per live (query, key) pair and
// query head the backward needs 10 hd flops (q k^T again, dP, dv, dk, dq):
// at the training cell's shape (1 x 4096, 16 / 8 heads of 128, causal)
// 172 GFLOP against ~60 MB of operands, 0.17 ms at 989 TFLOP/s bf16. Only
// the tensor cores can approach it, so every product is a wgmma and every
// operand tile arrives by TMA, as in the forward.
//
// Two passes, two kernels, launched one after the other on the caller's
// stream; neither uses a floating-point atomic, so two launches on the
// same inputs give the same bits:
//
// * dq pass (flash_wgmma_dq_kernel): a block per (64-row q tile, query
//   head, batch row), costliest tiles first. It computes D for its rows
//   from o and do (and writes it for the dk / dv pass), loads its Q and dO
//   tiles once and walks the k tiles up to the causal diagonal through a
//   2-stage K / V ring: S = Q K^T and dP = dO V^T (both operands K-major in
//   shared memory), P and dS on the fp32 fragments, dS packed to bf16
//   straight into wgmma's register A operand, dQ += dS K with K read
//   MN-major (the forward's P V). dQ stays in fp32 registers.
// * dk / dv pass (flash_wgmma_dkdv_kernel): a block per (64-key tile, kv
//   head, batch row), the first k tiles (which see every q tile when
//   causal) launched first. It loads its K and V tiles once and walks every
//   (query head of its group, q tile from the diagonal on) through a
//   2-stage Q / dO ring, with lse and D of the tile's rows staged in shared
//   memory beside it: S^T = K Q^T and dP^T = V dO^T put the keys on the
//   accumulator's rows, so P^T and dS^T are register A operands as they
//   stand, and dV += P^T dO, dK += dS^T Q read dO and Q MN-major. The
//   group's query heads are summed in the block's fp32 registers: no
//   reduction crosses blocks.
//
// The forward's EDGE rule masks per element only the tiles that cross the
// causal diagonal or the ragged end (S not a multiple of 64); tiles wholly
// above the diagonal are never visited. TMA reads rows past S as zeros; a
// masked P is 0 outright (never exp of a masked score), rows past S are not
// stored. P and dS are rounded to bf16 as operands of their products; D,
// lse, P before rounding, and every accumulator are fp32.
//
// Shared memory (hd 128): 6 tiles of 64 rows x hd bf16 (two fixed, two
// 2-stage rings), 96 KB, plus 1 KB of row statistics: two blocks an SM.
//
// Latent attention (DeepSeek-V3, Moonlight): q / k heads of 192 over v heads
// of 128, the pair (192, 128). Every tile of q, k, dq and dk is three
// 64-column boxes wide, every tile of v, o, do and dv two; v is never
// zero-padded to 192. Per live pair and query head the backward needs
// 2 (3 x 192 + 2 x 128) flops. Its register files do not fit the hd-128
// design, so the pair has its own launch shapes:
//
// * dq pass: dQ is 96 fp32 registers a thread beside the S and dP
//   fragments (32 each): one warpgroup holds 64 rows, but its fixed Q and
//   dO tiles and the K / V ring take 120 KB, one block an SM. So a block
//   is two warpgroups over 128 q rows that share one K / V ring (160 KB,
//   8 warps an SM, half the ring's bytes a row), as the forward's hd-192
//   kernel is; a block's k range is the union of its warpgroups', and its
//   last causal tile is masked whole for warpgroup 0's rows;
// * dk / dv pass (flash_wgmma_dkdv_split_kernel): dK (96 registers), dV
//   (64) and the S^T and dP^T fragments (32 + 32) do not fit one thread's
//   255 registers. Two warpgroups split a 64-key tile's work in two equal
//   halves (640 flops a pair each): warpgroup 0 computes S^T = K Q^T, P^T
//   and dV += P^T dO; warpgroup 1 computes dP^T = V dO^T and, once
//   warpgroup 0 has handed it P^T through 16 KB of shared memory (fp32, in
//   the fragments' own order, a named barrier), dS^T and dK += dS^T Q. Each
//   holds only its own accumulators (dV 64 registers, dK 96), on one shared
//   Q / dO ring (136 KB, one block of 8 warps an SM). The branch is on a
//   warp-uniform warpgroup index, so ptxas keeps the products asynchronous.
//
// Head widths 64 and 128 and the pair (192, 128) are compiled; any other
// width or pair is refused with cudaErrorInvalidValue (the Python wrapper
// raises first).

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper.cuh"
#include "launch_config.cuh"

namespace {

constexpr int kBlk = 64;                     // rows of a warpgroup's q tile and of a k tile
constexpr int kStages = 2;                   // ring depth
constexpr int kBoxBytes = 64 * 128;          // 64 rows x 128 B, one TMA box
constexpr float kLog2e = 1.4426950408889634f;

struct BwdParams {
  const void* q;
  const void* k;
  const void* v;
  const void* out;
  const void* dout;
  const float* lse;     // (B, Hq, S): the forward's log-sum-exp
  float* delta;         // (B, Hq, S): rowsum(dout * out), the dq pass writes it
  void* dq;
  void* dk;
  void* dv;
  int B, S, Hq, Hkv;
  int causal;
  float sm_scale;
};

// Products into N output columns are issued in pieces of n128 (N a
// multiple of 128) or n64 (3 x n64 at 192).
template <int N>
struct Cols {
  static constexpr int kPiece = N % 128 == 0 ? 128 : 64;
  static constexpr int kPieces = N / kPiece;
};

// A pass's shared memory. Operands 0 (q, k) are HD wide, operands 1 (v, o,
// do) HDV wide. dq pass: FIXED Q and dO tiles (one a warpgroup), K and V
// rings. dk / dv pass: K and V fixed (FIXED 1), Q and dO rings. Then the
// row statistics, EXCH bytes one warpgroup hands the other, the barriers.
template <int HD, int HDV, int FIXED, int EXCH = 0>
struct BwdLayout {
  static constexpr int kBoxes = HD / 64;                     // 64-column boxes per row
  static constexpr int kVBoxes = HDV / 64;                   // never more than kBoxes
  static constexpr int kTileBytes = kBoxes * kBoxBytes;      // 64 rows x HD bf16
  static constexpr int kVTileBytes = kVBoxes * kBoxBytes;    // 64 rows x HDV bf16
  static constexpr int kFixed0 = 0;                                 // [FIXED]
  static constexpr int kFixed1 = FIXED * kTileBytes;                // [FIXED]
  static constexpr int kRing0 = kFixed1 + FIXED * kVTileBytes;      // [kStages]
  static constexpr int kRing1 = kRing0 + kStages * kTileBytes;      // [kStages]
  // dk / dv: [kStages][2][64] fp32; dq: lse[64 FIXED], D[64 FIXED]
  static constexpr int kStats = kRing1 + kStages * kVTileBytes;
  static constexpr int kExch = kStats + kStages * 2 * kBlk * 4;
  static constexpr int kBar = kExch + EXCH;                         // fixed, ring[kStages]
  static constexpr int kSmem = kBar + 64 + 1024;                    // + slack to align
  static_assert(kVBoxes <= kBoxes && FIXED <= kStages, "v no wider than q; stats fit");
};

// The launch shapes of a pair of widths: the dq pass's warpgroups (64 q
// rows each) and whether the dk / dv pass splits a key tile over two.
template <int HD, int HDV>
struct Pair {
  static constexpr int kDqWarpgroups = HD == HDV ? 1 : 2;
  static constexpr bool kSplit = HD != HDV;
  using Dq = BwdLayout<HD, HDV, kDqWarpgroups>;
  using Dkdv = BwdLayout<HD, HDV, 1, kSplit ? kBlk * kBlk * 4 : 0>;
};

// The block -> output tile mappings, which the tile probe calls too.
struct DqTile {
  int qt, h, b;
};

// dq pass: one block per (q tile, query head, batch row), the costliest
// (last, under causal) q tiles first, as the forward launches them.
__device__ __forceinline__ DqTile dq_tile() {
  DqTile t;
  t.qt = gridDim.x - 1 - blockIdx.x;
  t.h = blockIdx.y;
  t.b = blockIdx.z;
  return t;
}

struct KvTile {
  int kt, hk, b;
};

// dk / dv pass: one block per (k tile, kv head, batch row); under causal
// k tile 0 sees every q tile, so the first tiles go first.
__device__ __forceinline__ KvTile dkdv_tile() {
  KvTile t;
  t.kt = blockIdx.x;
  t.hk = blockIdx.y;
  t.b = blockIdx.z;
  return t;
}

// 2^x in one MUFU op, denormals flushed
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// acc (64 x 64) = A B^T over HD: both tiles 64 rows x HD, K-major in
// shared memory (128-byte swizzled 64-column boxes); a k16 slice is 32 B
// on inside a box, the next 64 columns a box later.
template <int HD>
__device__ __forceinline__ void product_kmajor(float (&acc)[32], const uint8_t* a,
                                               const uint8_t* b) {
#pragma unroll
  for (int t = 0; t < HD / 16; ++t) {
    const int off = (t / 4) * kBoxBytes + (t % 4) * 32;
    hopper::wgmma_m64n64k16_ss<0>(acc, hopper::smem_desc_sw128(a + off, 16, 1024),
                                  hopper::smem_desc_sw128(b + off, 16, 1024), t > 0 ? 1 : 0);
  }
}

// acc (64 x N) += A B over 64 rows of B: A from registers (the four k16
// slices of a 64 x 64 tile's fragments), B a 64-row tile read MN-major (16
// rows = 2048 B a slice; the next 64 columns one box, LBO, later).
template <int N>
__device__ __forceinline__ void product_rows(float (&acc)[Cols<N>::kPieces]
                                                         [Cols<N>::kPiece / 2],
                                             const uint32_t (&a)[4][4], const uint8_t* b) {
  using L = Cols<N>;
#pragma unroll
  for (int t = 0; t < 4; ++t) {
#pragma unroll
    for (int c = 0; c < L::kPieces; ++c) {
      const uint64_t desc =
          hopper::smem_desc_sw128(b + c * (L::kPiece / 64) * kBoxBytes + t * 2048, kBoxBytes,
                                  1024);
      if constexpr (L::kPiece == 128) {
        hopper::wgmma_m64n128k16_rs<1>(acc[c], a[t], desc, 1);
      } else {
        hopper::wgmma_m64n64k16_rs<1>(acc[c], a[t], desc, 1);
      }
    }
  }
}

// The fragments of a 64 x 64 fp32 tile as bf16 A operands: the tile's
// columns 16t..16t+15 are the A fragment of k slice t.
__device__ __forceinline__ void pack_fragments(const float (&x)[32], uint32_t (&a)[4][4]) {
#pragma unroll
  for (int t = 0; t < 4; ++t) {
#pragma unroll
    for (int r = 0; r < 4; ++r) a[t][r] = hopper::pack_bf16(x[8 * t + 2 * r], x[8 * t + 2 * r + 1]);
  }
}

// Store a (64 x N) fp32 accumulator, times `scale`, as bf16 rows: the
// thread's rows row0 + row_in (+ 8) of a (B, S, H, N) tensor, rows past S
// not stored.
template <int N>
__device__ __forceinline__ void store_rows(const float (&acc)[Cols<N>::kPieces]
                                                             [Cols<N>::kPiece / 2],
                                           void* dst, const BwdParams& prm, int H, int head,
                                           int b, int row0, int row_in, int col_in,
                                           float scale) {
  using L = Cols<N>;
  __nv_bfloat16* base = static_cast<__nv_bfloat16*>(dst);
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = row0 + row_in + 8 * hh;
    if (r >= prm.S) continue;
    __nv_bfloat16* row = base + ((static_cast<int64_t>(b) * prm.S + r) * H + head) * N + col_in;
#pragma unroll
    for (int c = 0; c < L::kPieces; ++c) {
#pragma unroll
      for (int i = 0; i < L::kPiece / 8; ++i)
        *reinterpret_cast<uint32_t*>(row + c * L::kPiece + 8 * i) = hopper::pack_bf16(
            acc[c][4 * i + 2 * hh] * scale, acc[c][4 * i + 2 * hh + 1] * scale);
    }
  }
}

// The dq pass over NWG warpgroups of 64 q rows each (one for hd 64 / 128,
// two for the pair (192, 128)), which share the block's K / V ring.
template <int HD, int HDV, int NWG>
__global__ void __launch_bounds__(128 * NWG, NWG == 1 ? 2 : 1)
flash_wgmma_dq_kernel(const __grid_constant__ CUtensorMap q_map,
                      const __grid_constant__ CUtensorMap k_map,
                      const __grid_constant__ CUtensorMap v_map,
                      const __grid_constant__ CUtensorMap do_map, BwdParams prm) {
  using L = BwdLayout<HD, HDV, NWG>;
  constexpr int kRows = kBlk * NWG;             // q rows of a block
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024u - (hopper::smem_u32(smem_raw) & 1023u)) & 1023u);
  uint64_t* fixed_full = reinterpret_cast<uint64_t*>(smem + L::kBar);
  uint64_t* ring_full = fixed_full + 1;
  float* stats = reinterpret_cast<float*>(smem + L::kStats);   // lse (log2 units), D

  const int tid = threadIdx.x;
  const DqTile tile = dq_tile();
  const int h = tile.h, b = tile.b;
  const int hk = h / (prm.Hq / prm.Hkv);
  const int q0 = tile.qt * kRows;
  // this warpgroup's rows start at qw; n_q warpgroups hold rows (with one
  // warpgroup both are known here). A warpgroup with no row computes on a
  // Q tile that is never loaded and stores nothing: rows do not mix.
  const int wg = NWG == 1 ? 0 : tid / 128;
  const int qw = q0 + kBlk * wg;
  const int n_q = NWG == 1 ? 1 : min(NWG, (prm.S - q0 + kBlk - 1) / kBlk);
  const int k_end = prm.causal ? min(prm.S, q0 + kRows) : prm.S;
  const int n_tiles = (k_end + kBlk - 1) / kBlk;

  if (tid == 0) {
    hopper::mbar_init(fixed_full, 1);
    for (int s = 0; s < kStages; ++s) hopper::mbar_init(&ring_full[s], 1);
    hopper::mbar_fence_init();
  }
  __syncthreads();

  auto load_kv = [&](int j) {
    const int s = j % kStages;
    hopper::mbar_arrive_expect_tx(&ring_full[s], L::kTileBytes + L::kVTileBytes);
#pragma unroll
    for (int c = 0; c < L::kBoxes; ++c) {
      hopper::tma_load_4d(smem + L::kRing0 + s * L::kTileBytes + c * kBoxBytes, &k_map,
                          &ring_full[s], 64 * c, hk, j * kBlk, b);
      if (c < L::kVBoxes)
        hopper::tma_load_4d(smem + L::kRing1 + s * L::kVTileBytes + c * kBoxBytes, &v_map,
                            &ring_full[s], 64 * c, hk, j * kBlk, b);
    }
  };
  if (tid == 0) {
    hopper::mbar_arrive_expect_tx(fixed_full, n_q * (L::kTileBytes + L::kVTileBytes));
    for (int w = 0; w < n_q; ++w) {
#pragma unroll
      for (int c = 0; c < L::kBoxes; ++c) {
        hopper::tma_load_4d(smem + L::kFixed0 + w * L::kTileBytes + c * kBoxBytes, &q_map,
                            fixed_full, 64 * c, h, q0 + kBlk * w, b);
        if (c < L::kVBoxes)
          hopper::tma_load_4d(smem + L::kFixed1 + w * L::kVTileBytes + c * kBoxBytes, &do_map,
                              fixed_full, 64 * c, h, q0 + kBlk * w, b);
      }
    }
    load_kv(0);
  }

  // D = rowsum(dO o) of the block's rows (over v's width), two threads a
  // row, while the tiles arrive; D (written for the dk / dv pass) and lse
  // into shared memory for the fragments' rows
  {
    const int r = tid >> 1, half = tid & 1;
    const int qi = q0 + r;
    const int64_t row = (static_cast<int64_t>(b) * prm.S + qi) * prm.Hq + h;
    float d = 0.f;
    if (qi < prm.S) {
      const __nv_bfloat16* o = static_cast<const __nv_bfloat16*>(prm.out) + row * HDV;
      const __nv_bfloat16* g = static_cast<const __nv_bfloat16*>(prm.dout) + row * HDV;
#pragma unroll
      for (int c = half * (HDV / 2); c < (half + 1) * (HDV / 2); c += 8) {
        const uint4 ov = *reinterpret_cast<const uint4*>(o + c);
        const uint4 gv = *reinterpret_cast<const uint4*>(g + c);
        const __nv_bfloat162* o2 = reinterpret_cast<const __nv_bfloat162*>(&ov);
        const __nv_bfloat162* g2 = reinterpret_cast<const __nv_bfloat162*>(&gv);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 of = __bfloat1622float2(o2[e]);
          const float2 gf = __bfloat1622float2(g2[e]);
          d = fmaf(of.x, gf.x, d);
          d = fmaf(of.y, gf.y, d);
        }
      }
    }
    d += __shfl_xor_sync(0xffffffffu, d, 1);
    if (half == 0) {
      const int64_t at = (static_cast<int64_t>(b) * prm.Hq + h) * prm.S + qi;
      stats[kRows + r] = d;
      stats[r] = qi < prm.S ? prm.lse[at] * kLog2e : 0.f;
      if (qi < prm.S) prm.delta[at] = d;
    }
  }
  __syncthreads();

  // this thread's rows of its warpgroup's tile (fragment layout: see hopper.cuh)
  const int warp = (tid % 128) / 32, lane = tid % 32;
  const int row_in = 16 * warp + lane / 4;      // and row_in + 8
  const int col_in = 2 * (lane & 3);            // within each n8 block
  const int sr = kBlk * wg + row_in;            // the row's statistics
  const float lse2[2] = {stats[sr], stats[sr + 8]};
  const float dd[2] = {stats[kRows + sr], stats[kRows + sr + 8]};
  const float scale = prm.sm_scale * kLog2e;
  const uint8_t* qs = smem + L::kFixed0 + wg * L::kTileBytes;
  const uint8_t* dos = smem + L::kFixed1 + wg * L::kVTileBytes;

  float dq[Cols<HD>::kPieces][Cols<HD>::kPiece / 2];
#pragma unroll
  for (int c = 0; c < Cols<HD>::kPieces; ++c)
#pragma unroll
    for (int i = 0; i < Cols<HD>::kPiece / 2; ++i) dq[c][i] = 0.f;
  float s[32], dp[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;

  hopper::mbar_wait(fixed_full, 0);
  for (int j = 0; j < n_tiles; ++j) {
    const int st = j % kStages;
    const int kt0 = j * kBlk;
    // stage (j + 1) % 2 was freed by the barrier that ended tile j - 1
    if (tid == 0 && j + 1 < n_tiles) load_kv(j + 1);
    hopper::mbar_wait(&ring_full[st], (j / kStages) & 1);
    const uint8_t* ks = smem + L::kRing0 + st * L::kTileBytes;
    const uint8_t* vs = smem + L::kRing1 + st * L::kVTileBytes;

    // ---- S = Q K^T and dP = dO V^T
    hopper::wgmma_fence();
    product_kmajor<HD>(s, qs, ks);
    product_kmajor<HDV>(dp, dos, vs);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(s);
    hopper::fence_regs(dp);

    // ---- dS = P (dP - D), P = 2^(s scale - lse); only tiles that cross
    // the causal diagonal of the block's first row or the ragged end mask
    // (a block-uniform test: ptxas serializes wgmma calls behind a branch
    // on the thread index). With two warpgroups the block's last causal
    // tile holds no live key for warpgroup 0's rows: every P is 0 there.
    const bool edge = kt0 + kBlk > prm.S || (prm.causal && kt0 + kBlk - 1 > q0);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int x = 4 * i + 2 * hh + e;
          float p = fast_exp2(fmaf(s[x], scale, -lse2[hh]));
          if (edge) {
            const int kj = kt0 + 8 * i + col_in + e;
            const int qi = qw + row_in + 8 * hh;
            if (kj >= prm.S || (prm.causal && kj > qi)) p = 0.f;
          }
          s[x] = p * (dp[x] - dd[hh]);
        }
      }
    }
    uint32_t ds[4][4];
    pack_fragments(s, ds);

    // ---- dQ += dS K
    hopper::wgmma_fence();
    product_rows<HD>(dq, ds, ks);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
#pragma unroll
    for (int c = 0; c < Cols<HD>::kPieces; ++c) hopper::fence_regs(dq[c]);
#pragma unroll
    for (int t = 0; t < 4; ++t) hopper::fence_regs(ds[t]);
    __syncthreads();   // every product that read stage st is done: it may refill
  }

  store_rows<HD>(dq, prm.dq, prm, prm.Hq, h, b, qw, row_in, col_in, prm.sm_scale);
}

// The dk / dv pass of one width (hd 64 / 128): one warpgroup a key tile.
template <int HD>
__global__ void __launch_bounds__(128, 2)
flash_wgmma_dkdv_kernel(const __grid_constant__ CUtensorMap q_map,
                        const __grid_constant__ CUtensorMap k_map,
                        const __grid_constant__ CUtensorMap v_map,
                        const __grid_constant__ CUtensorMap do_map, BwdParams prm) {
  using L = BwdLayout<HD, HD, 1>;
  using C = Cols<HD>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024u - (hopper::smem_u32(smem_raw) & 1023u)) & 1023u);
  uint64_t* fixed_full = reinterpret_cast<uint64_t*>(smem + L::kBar);
  uint64_t* ring_full = fixed_full + 1;
  float* stats = reinterpret_cast<float*>(smem + L::kStats);   // [stage]: lse2[64], D[64]

  const int tid = threadIdx.x;
  const KvTile tile = dkdv_tile();
  const int hk = tile.hk, b = tile.b;
  const int group = prm.Hq / prm.Hkv;
  const int k0 = tile.kt * kBlk;
  const int n_qt = (prm.S + kBlk - 1) / kBlk;
  const int qt_begin = prm.causal ? tile.kt : 0;    // the diagonal tile: q tiles are 64 rows too
  const int per_head = n_qt - qt_begin;
  const int n_iter = group * per_head;

  if (tid == 0) {
    hopper::mbar_init(fixed_full, 1);
    for (int s = 0; s < kStages; ++s) hopper::mbar_init(&ring_full[s], 1);
    hopper::mbar_fence_init();
  }
  __syncthreads();

  // iteration j: query head hk * group + j / per_head, q tile
  // qt_begin + j % per_head
  auto load_qdo = [&](int j) {
    const int s = j % kStages;
    const int h = hk * group + j / per_head;
    const int q0 = (qt_begin + j % per_head) * kBlk;
    hopper::mbar_arrive_expect_tx(&ring_full[s], 2 * L::kTileBytes);
#pragma unroll
    for (int c = 0; c < L::kBoxes; ++c) {
      hopper::tma_load_4d(smem + L::kRing0 + s * L::kTileBytes + c * kBoxBytes, &q_map,
                          &ring_full[s], 64 * c, h, q0, b);
      hopper::tma_load_4d(smem + L::kRing1 + s * L::kTileBytes + c * kBoxBytes, &do_map,
                          &ring_full[s], 64 * c, h, q0, b);
    }
  };
  // lse (log2 units) and D of iteration j's rows into its stage's slot,
  // a thread an entry; rows past S get 0 (their P is masked)
  auto load_stats = [&](int j) {
    const int h = hk * group + j / per_head;
    const int r = tid % kBlk;
    const int qi = (qt_begin + j % per_head) * kBlk + r;
    const int64_t at = (static_cast<int64_t>(b) * prm.Hq + h) * prm.S + qi;
    float* slot = stats + (j % kStages) * 2 * kBlk;
    if (tid < kBlk) {
      slot[r] = qi < prm.S ? prm.lse[at] * kLog2e : 0.f;
    } else {
      slot[kBlk + r] = qi < prm.S ? prm.delta[at] : 0.f;
    }
  };
  if (tid == 0) {
    hopper::mbar_arrive_expect_tx(fixed_full, 2 * L::kTileBytes);
#pragma unroll
    for (int c = 0; c < L::kBoxes; ++c) {
      hopper::tma_load_4d(smem + L::kFixed0 + c * kBoxBytes, &k_map, fixed_full, 64 * c, hk,
                          k0, b);
      hopper::tma_load_4d(smem + L::kFixed1 + c * kBoxBytes, &v_map, fixed_full, 64 * c, hk,
                          k0, b);
    }
    load_qdo(0);
  }
  load_stats(0);
  __syncthreads();

  const int warp = tid / 32, lane = tid % 32;
  const int row_in = 16 * warp + lane / 4;      // the thread's keys: row_in, row_in + 8
  const int col_in = 2 * (lane & 3);            // its q columns within each n8 block
  const float scale = prm.sm_scale * kLog2e;
  const uint8_t* ks = smem + L::kFixed0;
  const uint8_t* vs = smem + L::kFixed1;

  float dk[C::kPieces][C::kPiece / 2], dv[C::kPieces][C::kPiece / 2];
#pragma unroll
  for (int c = 0; c < C::kPieces; ++c)
#pragma unroll
    for (int i = 0; i < C::kPiece / 2; ++i) dk[c][i] = dv[c][i] = 0.f;
  float s[32], dp[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;

  hopper::mbar_wait(fixed_full, 0);
  for (int j = 0; j < n_iter; ++j) {
    const int st = j % kStages;
    const int qt = qt_begin + j % per_head;
    const int q0 = qt * kBlk;
    if (tid == 0 && j + 1 < n_iter) load_qdo(j + 1);
    // the next iteration's statistics, into the slot iteration j - 1 read
    if (j + 1 < n_iter) load_stats(j + 1);
    hopper::mbar_wait(&ring_full[st], (j / kStages) & 1);
    const uint8_t* qs = smem + L::kRing0 + st * L::kTileBytes;
    const uint8_t* dos = smem + L::kRing1 + st * L::kTileBytes;
    const float* lse2 = stats + st * 2 * kBlk;
    const float* dd = lse2 + kBlk;

    // ---- S^T = K Q^T: the keys on the rows
    hopper::wgmma_fence();
    product_kmajor<HD>(s, ks, qs);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(s);

    // ---- P^T = 2^(s scale - lse) of each column's query; the diagonal
    // tile and the ragged q tail mask (a block-uniform test)
    const bool edge = (prm.causal && qt == tile.kt) || q0 + kBlk > prm.S;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = 8 * i + col_in + e;
        const float l2 = lse2[col];
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int x = 4 * i + 2 * hh + e;
          float p = fast_exp2(fmaf(s[x], scale, -l2));
          if (edge) {
            const int qi = q0 + col;
            const int kj = k0 + row_in + 8 * hh;
            if (qi >= prm.S || (prm.causal && kj > qi)) p = 0.f;
          }
          s[x] = p;
        }
      }
    }
    uint32_t pt[4][4];
    pack_fragments(s, pt);

    // ---- dV += P^T dO and dP^T = V dO^T
    hopper::wgmma_fence();
    product_rows<HD>(dv, pt, dos);
    product_kmajor<HD>(dp, vs, dos);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
#pragma unroll
    for (int c = 0; c < C::kPieces; ++c) hopper::fence_regs(dv[c]);
#pragma unroll
    for (int t = 0; t < 4; ++t) hopper::fence_regs(pt[t]);
    hopper::fence_regs(dp);

    // ---- dS^T = P^T (dP^T - D)
#pragma unroll
    for (int i = 0; i < 8; ++i) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float d = dd[8 * i + col_in + e];
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int x = 4 * i + 2 * hh + e;
          s[x] = s[x] * (dp[x] - d);
        }
      }
    }
    uint32_t dst[4][4];
    pack_fragments(s, dst);

    // ---- dK += dS^T Q
    hopper::wgmma_fence();
    product_rows<HD>(dk, dst, qs);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
#pragma unroll
    for (int c = 0; c < C::kPieces; ++c) hopper::fence_regs(dk[c]);
#pragma unroll
    for (int t = 0; t < 4; ++t) hopper::fence_regs(dst[t]);
    __syncthreads();   // stage st and its statistics may refill
  }

  store_rows<HD>(dk, prm.dk, prm, prm.Hkv, hk, b, k0, row_in, col_in, prm.sm_scale);
  store_rows<HD>(dv, prm.dv, prm, prm.Hkv, hk, b, k0, row_in, col_in, 1.f);
}

// The dk / dv pass of the pair (192, 128): two warpgroups split one key
// tile's work. Warpgroup 0 computes S^T and P^T, hands P^T (fp32, element
// i of thread t at i * 128 + t, so that warpgroup 1's thread t reads the
// element its own dP^T fragment holds) to warpgroup 1 through shared
// memory and named barrier 1, and sums dV; warpgroup 1 computes dP^T, then
// dS^T and sums dK. Named barrier 2 ends an iteration for both: the ring's
// stage, the statistics' slot and P^T may then be written again. Each
// warpgroup's loop lives in its own branch, so its accumulators alone are
// live in it.
template <int HD, int HDV>
__global__ void __launch_bounds__(256, 1)
flash_wgmma_dkdv_split_kernel(const __grid_constant__ CUtensorMap q_map,
                              const __grid_constant__ CUtensorMap k_map,
                              const __grid_constant__ CUtensorMap v_map,
                              const __grid_constant__ CUtensorMap do_map, BwdParams prm) {
  using L = typename Pair<HD, HDV>::Dkdv;
  constexpr int kPBar = 1, kEndBar = 2;         // named barriers over both warpgroups
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024u - (hopper::smem_u32(smem_raw) & 1023u)) & 1023u);
  uint64_t* fixed_full = reinterpret_cast<uint64_t*>(smem + L::kBar);
  uint64_t* ring_full = fixed_full + 1;
  float* stats = reinterpret_cast<float*>(smem + L::kStats);   // [stage]: lse2[64], D[64]
  float* pt_x = reinterpret_cast<float*>(smem + L::kExch);     // P^T, [32][128]

  const int tid = threadIdx.x;
  const KvTile tile = dkdv_tile();
  const int hk = tile.hk, b = tile.b;
  const int group = prm.Hq / prm.Hkv;
  const int k0 = tile.kt * kBlk;
  const int n_qt = (prm.S + kBlk - 1) / kBlk;
  const int qt_begin = prm.causal ? tile.kt : 0;    // the diagonal tile: q tiles are 64 rows too
  const int per_head = n_qt - qt_begin;
  const int n_iter = group * per_head;

  if (tid == 0) {
    hopper::mbar_init(fixed_full, 1);
    for (int s = 0; s < kStages; ++s) hopper::mbar_init(&ring_full[s], 1);
    hopper::mbar_fence_init();
  }
  __syncthreads();

  // iteration j: query head hk * group + j / per_head, q tile
  // qt_begin + j % per_head
  auto load_qdo = [&](int j) {
    const int s = j % kStages;
    const int h = hk * group + j / per_head;
    const int q0 = (qt_begin + j % per_head) * kBlk;
    hopper::mbar_arrive_expect_tx(&ring_full[s], L::kTileBytes + L::kVTileBytes);
#pragma unroll
    for (int c = 0; c < L::kBoxes; ++c) {
      hopper::tma_load_4d(smem + L::kRing0 + s * L::kTileBytes + c * kBoxBytes, &q_map,
                          &ring_full[s], 64 * c, h, q0, b);
      if (c < L::kVBoxes)
        hopper::tma_load_4d(smem + L::kRing1 + s * L::kVTileBytes + c * kBoxBytes, &do_map,
                            &ring_full[s], 64 * c, h, q0, b);
    }
  };
  // lse (log2 units) and D of iteration j's rows into its stage's slot, a
  // thread of warpgroup 0 an entry; rows past S get 0 (their P is masked)
  auto load_stats = [&](int j) {
    const int h = hk * group + j / per_head;
    const int r = tid % kBlk;
    const int qi = (qt_begin + j % per_head) * kBlk + r;
    const int64_t at = (static_cast<int64_t>(b) * prm.Hq + h) * prm.S + qi;
    float* slot = stats + (j % kStages) * 2 * kBlk;
    if (tid < kBlk) {
      slot[r] = qi < prm.S ? prm.lse[at] * kLog2e : 0.f;
    } else {
      slot[kBlk + r] = qi < prm.S ? prm.delta[at] : 0.f;
    }
  };
  if (tid == 0) {
    hopper::mbar_arrive_expect_tx(fixed_full, L::kTileBytes + L::kVTileBytes);
#pragma unroll
    for (int c = 0; c < L::kBoxes; ++c) {
      hopper::tma_load_4d(smem + L::kFixed0 + c * kBoxBytes, &k_map, fixed_full, 64 * c, hk,
                          k0, b);
      if (c < L::kVBoxes)
        hopper::tma_load_4d(smem + L::kFixed1 + c * kBoxBytes, &v_map, fixed_full, 64 * c, hk,
                            k0, b);
    }
    load_qdo(0);
  }
  if (tid < 128) load_stats(0);
  __syncthreads();

  // the warpgroup as a value the compiler knows is the same over a warp (a
  // branch on threadIdx itself would serialize the wgmma calls behind it)
  const int wg = __shfl_sync(0xffffffffu, tid / 128, 0);
  const int t = tid % 128;
  const int warp = t / 32, lane = t % 32;
  const int row_in = 16 * warp + lane / 4;      // the thread's keys: row_in, row_in + 8
  const int col_in = 2 * (lane & 3);            // its q columns within each n8 block
  const uint8_t* ks = smem + L::kFixed0;
  const uint8_t* vs = smem + L::kFixed1;

  hopper::mbar_wait(fixed_full, 0);
  if (wg == 0) {
    // ---- warpgroup 0: S^T, P^T, dV
    const float scale = prm.sm_scale * kLog2e;
    float dv[Cols<HDV>::kPieces][Cols<HDV>::kPiece / 2];
#pragma unroll
    for (int c = 0; c < Cols<HDV>::kPieces; ++c)
#pragma unroll
      for (int i = 0; i < Cols<HDV>::kPiece / 2; ++i) dv[c][i] = 0.f;
    float s[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.f;
    for (int j = 0; j < n_iter; ++j) {
      const int st = j % kStages;
      const int qt = qt_begin + j % per_head;
      const int q0 = qt * kBlk;
      if (t == 0 && j + 1 < n_iter) load_qdo(j + 1);
      // the next iteration's statistics, into the slot iteration j - 1 read
      if (j + 1 < n_iter) load_stats(j + 1);
      hopper::mbar_wait(&ring_full[st], (j / kStages) & 1);
      const uint8_t* qs = smem + L::kRing0 + st * L::kTileBytes;
      const uint8_t* dos = smem + L::kRing1 + st * L::kVTileBytes;
      const float* lse2 = stats + st * 2 * kBlk;

      // S^T = K Q^T: the keys on the rows
      hopper::wgmma_fence();
      product_kmajor<HD>(s, ks, qs);
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(s);

      // P^T = 2^(s scale - lse) of each column's query; the diagonal tile
      // and the ragged q tail mask (a block-uniform test)
      const bool edge = (prm.causal && qt == tile.kt) || q0 + kBlk > prm.S;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = 8 * i + col_in + e;
          const float l2 = lse2[col];
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const int x = 4 * i + 2 * hh + e;
            float p = fast_exp2(fmaf(s[x], scale, -l2));
            if (edge) {
              const int qi = q0 + col;
              const int kj = k0 + row_in + 8 * hh;
              if (qi >= prm.S || (prm.causal && kj > qi)) p = 0.f;
            }
            s[x] = p;
          }
        }
      }
#pragma unroll
      for (int i = 0; i < 32; ++i) pt_x[i * 128 + t] = s[i];
      hopper::named_bar_arrive(kPBar, 256);
      uint32_t pt[4][4];
      pack_fragments(s, pt);

      // dV += P^T dO
      hopper::wgmma_fence();
      product_rows<HDV>(dv, pt, dos);
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
#pragma unroll
      for (int c = 0; c < Cols<HDV>::kPieces; ++c) hopper::fence_regs(dv[c]);
#pragma unroll
      for (int i = 0; i < 4; ++i) hopper::fence_regs(pt[i]);
      hopper::named_bar_sync(kEndBar, 256);
    }
    store_rows<HDV>(dv, prm.dv, prm, prm.Hkv, hk, b, k0, row_in, col_in, 1.f);
  } else {
    // ---- warpgroup 1: dP^T, dS^T, dK
    float dk[Cols<HD>::kPieces][Cols<HD>::kPiece / 2];
#pragma unroll
    for (int c = 0; c < Cols<HD>::kPieces; ++c)
#pragma unroll
      for (int i = 0; i < Cols<HD>::kPiece / 2; ++i) dk[c][i] = 0.f;
    float dp[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) dp[i] = 0.f;
    for (int j = 0; j < n_iter; ++j) {
      const int st = j % kStages;
      hopper::mbar_wait(&ring_full[st], (j / kStages) & 1);
      const uint8_t* qs = smem + L::kRing0 + st * L::kTileBytes;
      const uint8_t* dos = smem + L::kRing1 + st * L::kVTileBytes;
      const float* dd = stats + st * 2 * kBlk + kBlk;

      // dP^T = V dO^T
      hopper::wgmma_fence();
      product_kmajor<HDV>(dp, vs, dos);
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(dp);

      // dS^T = P^T (dP^T - D), P^T from warpgroup 0
      hopper::named_bar_sync(kPBar, 256);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float d = dd[8 * i + col_in + e];
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const int x = 4 * i + 2 * hh + e;
            dp[x] = pt_x[x * 128 + t] * (dp[x] - d);
          }
        }
      }
      uint32_t dst[4][4];
      pack_fragments(dp, dst);

      // dK += dS^T Q
      hopper::wgmma_fence();
      product_rows<HD>(dk, dst, qs);
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
#pragma unroll
      for (int c = 0; c < Cols<HD>::kPieces; ++c) hopper::fence_regs(dk[c]);
#pragma unroll
      for (int i = 0; i < 4; ++i) hopper::fence_regs(dst[i]);
      hopper::named_bar_sync(kEndBar, 256);
    }
    store_rows<HD>(dk, prm.dk, prm, prm.Hkv, hk, b, k0, row_in, col_in, prm.sm_scale);
  }
}

// A 4-D tensor map over a contiguous (B, S, H, width) bf16 tensor, dims
// innermost first (width, H, S, B), boxes of 64 columns x 1 head x 64 rows.
bool make_bshd_map(CUtensorMap* map, const void* base, int B, int S, int H, int hd) {
  const uint64_t dims[4] = {static_cast<uint64_t>(hd), static_cast<uint64_t>(H),
                            static_cast<uint64_t>(S), static_cast<uint64_t>(B)};
  const uint64_t row = static_cast<uint64_t>(hd) * 2;
  const uint64_t strides[3] = {row, row * H, row * H * S};
  const uint32_t box[4] = {64, 1, static_cast<uint32_t>(kBlk), 1};
  return hopper::make_tensor_map_bf16(map, base, 4, dims, strides, box);
}

constexpr int kPassDq = 0;
constexpr int kPassDkdv = 1;

// The pairs (q / k width, v width) the backward compiles.
bool bwd_pair(int hd, int hd_v) {
  return (hd == hd_v && (hd == 64 || hd == 128)) || (hd == 192 && hd_v == 128);
}

// The pass's launch: the dq pass over (q tiles of 64 rows a warpgroup, Hq,
// B), output dims (S, Hq, B); the dk / dv pass over (k tiles, Hkv, B),
// output dims (S, Hkv, B).
template <int HD, int HDV>
LaunchConfig pass_config(int pass, int B, int S, int Hq, int Hkv) {
  using P = Pair<HD, HDV>;
  if (pass == kPassDq) {
    const long long rows = kBlk * P::kDqWarpgroups;
    const long long tiles = (S + rows - 1) / rows;
    LaunchConfig c{{tiles, Hq, B}, {tiles * rows, Hq, B}, 128 * P::kDqWarpgroups,
                   P::Dq::kSmem, 1, 4};
    return c;
  }
  const long long tiles = (S + kBlk - 1) / kBlk;
  LaunchConfig c{{tiles, Hkv, B}, {tiles * kBlk, Hkv, B}, P::kSplit ? 256 : 128,
                 P::Dkdv::kSmem, 1, 4};
  return c;
}

bool config_for(int pass, int hd, int hd_v, int B, int S, int Hq, int Hkv, LaunchConfig* c) {
  if ((pass != kPassDq && pass != kPassDkdv) || !bwd_pair(hd, hd_v)) return false;
  switch (hd) {
    case 64: *c = pass_config<64, 64>(pass, B, S, Hq, Hkv); return true;
    case 128: *c = pass_config<128, 128>(pass, B, S, Hq, Hkv); return true;
    default: *c = pass_config<192, 128>(pass, B, S, Hq, Hkv); return true;
  }
}

template <int HD, int HDV>
auto dkdv_kernel() {
  if constexpr (Pair<HD, HDV>::kSplit) {
    return flash_wgmma_dkdv_split_kernel<HD, HDV>;
  } else {
    return flash_wgmma_dkdv_kernel<HD>;
  }
}

template <int HD, int HDV>
cudaError_t launch_pass(int pass, const CUtensorMap (&maps)[4], const BwdParams& prm,
                        cudaStream_t stream) {
  const LaunchConfig c = pass_config<HD, HDV>(pass, prm.B, prm.S, prm.Hq, prm.Hkv);
  auto kernel = dkdv_kernel<HD, HDV>();
  if (pass == kPassDq) kernel = flash_wgmma_dq_kernel<HD, HDV, Pair<HD, HDV>::kDqWarpgroups>;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, c.smem_bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>(c.grid[0]), static_cast<unsigned>(c.grid[1]),
                  static_cast<unsigned>(c.grid[2]));
  kernel<<<grid, c.threads, c.smem_bytes, stream>>>(maps[0], maps[1], maps[2], maps[3], prm);
  return cudaGetLastError();
}

// One box a block, on the pass's launch grid: the `rows` rows of its tile
// (past S the kernels' stores are guarded), its head and its batch row.
__global__ void flash_bwd_tile_probe_kernel(int pass, long long rows, TileBox* boxes,
                                            int capacity, unsigned int* count) {
  if (pass == kPassDq) {
    const DqTile t = dq_tile();
    const long long q0 = static_cast<long long>(t.qt) * rows;
    emit_box(boxes, capacity, count, t.qt, t.h, t.b, q0, t.h, t.b, q0 + rows, t.h + 1, t.b + 1);
  } else {
    const KvTile t = dkdv_tile();
    const long long k0 = static_cast<long long>(t.kt) * rows;
    emit_box(boxes, capacity, count, t.kt, t.hk, t.b, k0, t.hk, t.b, k0 + rows, t.hk + 1,
             t.b + 1);
  }
}

}  // namespace

// The backward of flash attention over bf16 contiguous (B, S, H, width)
// tensors (Sq == Sk == S; q, k, dq and dk hd wide, v, o, do and dv hd_v
// wide), in one pass (0: D and dq; 1: dk and dv, which reads the D pass 0
// wrote). lse and delta are fp32 contiguous (B, Hq, S). Returns a
// cudaError_t (0: ok).
extern "C" int flash_attention_bwd_launch(int pass, const void* q, const void* k, const void* v,
                                          const void* out, const void* dout, const void* lse,
                                          void* delta, void* dq, void* dk, void* dv, int B,
                                          int S, int Hq, int Hkv, int hd, int hd_v, int causal,
                                          float sm_scale, void* stream) {
  if (B <= 0 || S <= 0 || Hq <= 0) return 0;
  if (Hkv <= 0 || Hq % Hkv != 0 || (pass != kPassDq && pass != kPassDkdv))
    return static_cast<int>(cudaErrorInvalidValue);
  if (!bwd_pair(hd, hd_v)) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap maps[4];
  if (!make_bshd_map(&maps[0], q, B, S, Hq, hd) || !make_bshd_map(&maps[1], k, B, S, Hkv, hd) ||
      !make_bshd_map(&maps[2], v, B, S, Hkv, hd_v) ||
      !make_bshd_map(&maps[3], dout, B, S, Hq, hd_v))
    return static_cast<int>(cudaErrorInvalidValue);
  BwdParams prm{q, k, v, out, dout, static_cast<const float*>(lse), static_cast<float*>(delta),
                dq, dk, dv, B, S, Hq, Hkv, causal, sm_scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 64: return static_cast<int>(launch_pass<64, 64>(pass, maps, prm, s));
    case 128: return static_cast<int>(launch_pass<128, 128>(pass, maps, prm, s));
    default: return static_cast<int>(launch_pass<192, 128>(pass, maps, prm, s));
  }
}

// The widths the backward takes: 1 for hd 64 and 128 (v as wide) and for
// q / k 192 over v 128, else 0.
extern "C" int flash_attention_bwd_path(int hd, int hd_v) { return bwd_pair(hd, hd_v) ? 1 : 0; }

// The launch configuration of a pass for these shapes. Returns 0, or
// cudaErrorInvalidValue for a pass or widths no kernel is compiled for.
extern "C" int flash_attention_bwd_launch_config(int pass, int B, int S, int Hq, int Hkv, int hd,
                                                 int hd_v, LaunchConfig* out) {
  return config_for(pass, hd, hd_v, B, S, Hq, Hkv, out)
             ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

// The output boxes of a pass's blocks, from dq_tile / dkdv_tile on the
// pass's own grid (config_for): one TileBox a block into boxes (device
// memory, room for capacity), the number found in *count (device memory,
// zeroed by the caller). Returns a cudaError_t.
extern "C" int flash_attention_bwd_tile_probe(int pass, int B, int S, int Hq, int Hkv, int hd,
                                              int hd_v, void* boxes, int capacity, void* count,
                                              void* stream) {
  if (B <= 0 || S <= 0 || Hq <= 0) return 0;
  LaunchConfig c;
  if (!config_for(pass, hd, hd_v, B, S, Hq, Hkv, &c))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(c.grid[0]), static_cast<unsigned>(c.grid[1]),
                  static_cast<unsigned>(c.grid[2]));
  flash_bwd_tile_probe_kernel<<<grid, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      pass, c.cover[0] / c.grid[0], static_cast<TileBox*>(boxes), capacity,
      static_cast<unsigned int*>(count));
  return static_cast<int>(cudaGetLastError());
}

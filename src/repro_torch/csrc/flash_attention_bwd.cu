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
// Given q (B, S, Hq, hd), k and v (B, S, Hkv, hd), the forward's output o,
// its gradient do (all bf16) and lse (B, Hq, S) fp32, with the scaled scores
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
// Head widths 64 and 128 are compiled; any other width is refused with
// cudaErrorInvalidValue (the Python wrapper raises first).

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper.cuh"
#include "launch_config.cuh"

namespace {

constexpr int kBlk = 64;                     // rows of a q tile and of a k tile
constexpr int kThreads = 128;                // one warpgroup a block
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

template <int HD>
struct BwdLayout {
  static constexpr int kBoxes = HD / 64;                     // 64-column boxes per row
  static constexpr int kTileBytes = kBoxes * kBoxBytes;      // 64 rows x HD bf16
  // products into hd columns are issued in pieces of n128 (hd 128) or n64
  static constexpr int kPiece = HD % 128 == 0 ? 128 : 64;
  static constexpr int kPieces = HD / kPiece;
  // dq pass: Q, dO fixed; K, V rings. dk / dv pass: K, V fixed; Q, dO rings.
  static constexpr int kFixed0 = 0;
  static constexpr int kFixed1 = kTileBytes;
  static constexpr int kRing0 = 2 * kTileBytes;                     // [kStages]
  static constexpr int kRing1 = kRing0 + kStages * kTileBytes;      // [kStages]
  static constexpr int kStats = kRing1 + kStages * kTileBytes;      // [kStages][2][64] fp32
  static constexpr int kBar = kStats + kStages * 2 * kBlk * 4;      // fixed, ring[kStages]
  static constexpr int kSmem = kBar + 64 + 1024;                    // + slack to align
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

// acc (64 x HD) += A B over 64 rows of B: A from registers (the four k16
// slices of a 64 x 64 tile's fragments), B a 64-row tile read MN-major (16
// rows = 2048 B a slice; the next 64 columns one box, LBO, later).
template <int HD>
__device__ __forceinline__ void product_rows(float (&acc)[BwdLayout<HD>::kPieces]
                                                         [BwdLayout<HD>::kPiece / 2],
                                             const uint32_t (&a)[4][4], const uint8_t* b) {
  using L = BwdLayout<HD>;
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

// Store a (64 x HD) fp32 accumulator, times `scale`, as bf16 rows: the
// thread's rows row0 + row_in (+ 8) of a (B, S, H, HD) tensor, rows past S
// not stored.
template <int HD>
__device__ __forceinline__ void store_rows(const float (&acc)[BwdLayout<HD>::kPieces]
                                                             [BwdLayout<HD>::kPiece / 2],
                                           void* dst, const BwdParams& prm, int H, int head,
                                           int b, int row0, int row_in, int col_in,
                                           float scale) {
  using L = BwdLayout<HD>;
  __nv_bfloat16* base = static_cast<__nv_bfloat16*>(dst);
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = row0 + row_in + 8 * hh;
    if (r >= prm.S) continue;
    __nv_bfloat16* row = base + ((static_cast<int64_t>(b) * prm.S + r) * H + head) * HD + col_in;
#pragma unroll
    for (int c = 0; c < L::kPieces; ++c) {
#pragma unroll
      for (int i = 0; i < L::kPiece / 8; ++i)
        *reinterpret_cast<uint32_t*>(row + c * L::kPiece + 8 * i) = hopper::pack_bf16(
            acc[c][4 * i + 2 * hh] * scale, acc[c][4 * i + 2 * hh + 1] * scale);
    }
  }
}

template <int HD>
__global__ void __launch_bounds__(kThreads, 2)
flash_wgmma_dq_kernel(const __grid_constant__ CUtensorMap q_map,
                      const __grid_constant__ CUtensorMap k_map,
                      const __grid_constant__ CUtensorMap v_map,
                      const __grid_constant__ CUtensorMap do_map, BwdParams prm) {
  using L = BwdLayout<HD>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024u - (hopper::smem_u32(smem_raw) & 1023u)) & 1023u);
  uint64_t* fixed_full = reinterpret_cast<uint64_t*>(smem + L::kBar);
  uint64_t* ring_full = fixed_full + 1;
  float* stats = reinterpret_cast<float*>(smem + L::kStats);   // lse (log2 units), D

  const int tid = threadIdx.x;
  const DqTile tile = dq_tile();
  const int h = tile.h, b = tile.b;
  const int hk = h / (prm.Hq / prm.Hkv);
  const int q0 = tile.qt * kBlk;
  const int k_end = prm.causal ? min(prm.S, q0 + kBlk) : prm.S;
  const int n_tiles = (k_end + kBlk - 1) / kBlk;

  if (tid == 0) {
    hopper::mbar_init(fixed_full, 1);
    for (int s = 0; s < kStages; ++s) hopper::mbar_init(&ring_full[s], 1);
    hopper::mbar_fence_init();
  }
  __syncthreads();

  auto load_kv = [&](int j) {
    const int s = j % kStages;
    hopper::mbar_arrive_expect_tx(&ring_full[s], 2 * L::kTileBytes);
#pragma unroll
    for (int c = 0; c < L::kBoxes; ++c) {
      hopper::tma_load_4d(smem + L::kRing0 + s * L::kTileBytes + c * kBoxBytes, &k_map,
                          &ring_full[s], 64 * c, hk, j * kBlk, b);
      hopper::tma_load_4d(smem + L::kRing1 + s * L::kTileBytes + c * kBoxBytes, &v_map,
                          &ring_full[s], 64 * c, hk, j * kBlk, b);
    }
  };
  if (tid == 0) {
    hopper::mbar_arrive_expect_tx(fixed_full, 2 * L::kTileBytes);
#pragma unroll
    for (int c = 0; c < L::kBoxes; ++c) {
      hopper::tma_load_4d(smem + L::kFixed0 + c * kBoxBytes, &q_map, fixed_full, 64 * c, h, q0,
                          b);
      hopper::tma_load_4d(smem + L::kFixed1 + c * kBoxBytes, &do_map, fixed_full, 64 * c, h,
                          q0, b);
    }
    load_kv(0);
  }

  // D = rowsum(dO o) of the tile's rows, two threads a row, while the
  // tiles arrive; D (written for the dk / dv pass) and lse into shared
  // memory for the fragments' rows
  {
    const int r = tid >> 1, half = tid & 1;
    const int qi = q0 + r;
    const int64_t row = (static_cast<int64_t>(b) * prm.S + qi) * prm.Hq + h;
    float d = 0.f;
    if (qi < prm.S) {
      const __nv_bfloat16* o = static_cast<const __nv_bfloat16*>(prm.out) + row * HD;
      const __nv_bfloat16* g = static_cast<const __nv_bfloat16*>(prm.dout) + row * HD;
#pragma unroll
      for (int c = half * (HD / 2); c < (half + 1) * (HD / 2); c += 8) {
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
      stats[kBlk + r] = d;
      stats[r] = qi < prm.S ? prm.lse[at] * kLog2e : 0.f;
      if (qi < prm.S) prm.delta[at] = d;
    }
  }
  __syncthreads();

  // this thread's rows of the tile (fragment layout: see hopper.cuh)
  const int warp = tid / 32, lane = tid % 32;
  const int row_in = 16 * warp + lane / 4;      // and row_in + 8
  const int col_in = 2 * (lane & 3);            // within each n8 block
  const float lse2[2] = {stats[row_in], stats[row_in + 8]};
  const float dd[2] = {stats[kBlk + row_in], stats[kBlk + row_in + 8]};
  const float scale = prm.sm_scale * kLog2e;
  const uint8_t* qs = smem + L::kFixed0;
  const uint8_t* dos = smem + L::kFixed1;

  float dq[L::kPieces][L::kPiece / 2];
#pragma unroll
  for (int c = 0; c < L::kPieces; ++c)
#pragma unroll
    for (int i = 0; i < L::kPiece / 2; ++i) dq[c][i] = 0.f;
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
    const uint8_t* vs = smem + L::kRing1 + st * L::kTileBytes;

    // ---- S = Q K^T and dP = dO V^T
    hopper::wgmma_fence();
    product_kmajor<HD>(s, qs, ks);
    product_kmajor<HD>(dp, dos, vs);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(s);
    hopper::fence_regs(dp);

    // ---- dS = P (dP - D), P = 2^(s scale - lse); only tiles that cross
    // the causal diagonal or the ragged end mask (a block-uniform test)
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
            const int qi = q0 + row_in + 8 * hh;
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
    for (int c = 0; c < L::kPieces; ++c) hopper::fence_regs(dq[c]);
#pragma unroll
    for (int t = 0; t < 4; ++t) hopper::fence_regs(ds[t]);
    __syncthreads();   // every product that read stage st is done: it may refill
  }

  store_rows<HD>(dq, prm.dq, prm, prm.Hq, h, b, q0, row_in, col_in, prm.sm_scale);
}

template <int HD>
__global__ void __launch_bounds__(kThreads, 2)
flash_wgmma_dkdv_kernel(const __grid_constant__ CUtensorMap q_map,
                        const __grid_constant__ CUtensorMap k_map,
                        const __grid_constant__ CUtensorMap v_map,
                        const __grid_constant__ CUtensorMap do_map, BwdParams prm) {
  using L = BwdLayout<HD>;
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

  float dk[L::kPieces][L::kPiece / 2], dv[L::kPieces][L::kPiece / 2];
#pragma unroll
  for (int c = 0; c < L::kPieces; ++c)
#pragma unroll
    for (int i = 0; i < L::kPiece / 2; ++i) dk[c][i] = dv[c][i] = 0.f;
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
    for (int c = 0; c < L::kPieces; ++c) hopper::fence_regs(dv[c]);
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
    for (int c = 0; c < L::kPieces; ++c) hopper::fence_regs(dk[c]);
#pragma unroll
    for (int t = 0; t < 4; ++t) hopper::fence_regs(dst[t]);
    __syncthreads();   // stage st and its statistics may refill
  }

  store_rows<HD>(dk, prm.dk, prm, prm.Hkv, hk, b, k0, row_in, col_in, prm.sm_scale);
  store_rows<HD>(dv, prm.dv, prm, prm.Hkv, hk, b, k0, row_in, col_in, 1.f);
}

// A 4-D tensor map over a contiguous (B, S, H, hd) bf16 tensor, dims
// innermost first (hd, H, S, B), boxes of 64 columns x 1 head x 64 rows.
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

// The pass's launch: the dq pass over (q tiles, Hq, B), output dims
// (S, Hq, B); the dk / dv pass over (k tiles, Hkv, B), output dims
// (S, Hkv, B).
template <int HD>
LaunchConfig pass_config(int pass, int B, int S, int Hq, int Hkv) {
  const long long tiles = (S + kBlk - 1) / kBlk;
  const long long heads = pass == kPassDq ? Hq : Hkv;
  LaunchConfig c{{tiles, heads, B}, {tiles * kBlk, heads, B}, kThreads, BwdLayout<HD>::kSmem,
                 1, 4};
  return c;
}

bool config_for(int pass, int hd, int B, int S, int Hq, int Hkv, LaunchConfig* c) {
  if (pass != kPassDq && pass != kPassDkdv) return false;
  switch (hd) {
    case 64: *c = pass_config<64>(pass, B, S, Hq, Hkv); return true;
    case 128: *c = pass_config<128>(pass, B, S, Hq, Hkv); return true;
    default: return false;
  }
}

template <int HD>
cudaError_t launch_pass(int pass, const CUtensorMap (&maps)[4], const BwdParams& prm,
                        cudaStream_t stream) {
  const LaunchConfig c = pass_config<HD>(pass, prm.B, prm.S, prm.Hq, prm.Hkv);
  auto kernel = pass == kPassDq ? flash_wgmma_dq_kernel<HD> : flash_wgmma_dkdv_kernel<HD>;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, c.smem_bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>(c.grid[0]), static_cast<unsigned>(c.grid[1]),
                  static_cast<unsigned>(c.grid[2]));
  kernel<<<grid, c.threads, c.smem_bytes, stream>>>(maps[0], maps[1], maps[2], maps[3], prm);
  return cudaGetLastError();
}

// One box a block, on the pass's launch grid: the rows of its tile (past S
// the kernels' stores are guarded), its head and its batch row.
__global__ void flash_bwd_tile_probe_kernel(int pass, TileBox* boxes, int capacity,
                                            unsigned int* count) {
  if (pass == kPassDq) {
    const DqTile t = dq_tile();
    const long long q0 = static_cast<long long>(t.qt) * kBlk;
    emit_box(boxes, capacity, count, t.qt, t.h, t.b, q0, t.h, t.b, q0 + kBlk, t.h + 1, t.b + 1);
  } else {
    const KvTile t = dkdv_tile();
    const long long k0 = static_cast<long long>(t.kt) * kBlk;
    emit_box(boxes, capacity, count, t.kt, t.hk, t.b, k0, t.hk, t.b, k0 + kBlk, t.hk + 1,
             t.b + 1);
  }
}

}  // namespace

// The backward of flash attention over bf16 contiguous (B, S, H, hd)
// tensors (Sq == Sk == S), in one pass (0: D and dq; 1: dk and dv, which
// reads the D pass 0 wrote). lse and delta are fp32 contiguous (B, Hq, S).
// Returns a cudaError_t (0: ok).
extern "C" int flash_attention_bwd_launch(int pass, const void* q, const void* k, const void* v,
                                          const void* out, const void* dout, const void* lse,
                                          void* delta, void* dq, void* dk, void* dv, int B,
                                          int S, int Hq, int Hkv, int hd, int causal,
                                          float sm_scale, void* stream) {
  if (B <= 0 || S <= 0 || Hq <= 0) return 0;
  if (Hkv <= 0 || Hq % Hkv != 0 || (pass != kPassDq && pass != kPassDkdv))
    return static_cast<int>(cudaErrorInvalidValue);
  if (hd != 64 && hd != 128) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap maps[4];
  if (!make_bshd_map(&maps[0], q, B, S, Hq, hd) || !make_bshd_map(&maps[1], k, B, S, Hkv, hd) ||
      !make_bshd_map(&maps[2], v, B, S, Hkv, hd) || !make_bshd_map(&maps[3], dout, B, S, Hq, hd))
    return static_cast<int>(cudaErrorInvalidValue);
  BwdParams prm{q, k, v, out, dout, static_cast<const float*>(lse), static_cast<float*>(delta),
                dq, dk, dv, B, S, Hq, Hkv, causal, sm_scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(hd == 64 ? launch_pass<64>(pass, maps, prm, s)
                                   : launch_pass<128>(pass, maps, prm, s));
}

// The head widths the backward takes: 1 for hd 64 and 128, else 0.
extern "C" int flash_attention_bwd_path(int hd) { return hd == 64 || hd == 128 ? 1 : 0; }

// The launch configuration of a pass for these shapes. Returns 0, or
// cudaErrorInvalidValue for a pass or head width no kernel is compiled for.
extern "C" int flash_attention_bwd_launch_config(int pass, int B, int S, int Hq, int Hkv, int hd,
                                                 LaunchConfig* out) {
  return config_for(pass, hd, B, S, Hq, Hkv, out) ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

// The output boxes of a pass's blocks, from dq_tile / dkdv_tile on the
// pass's own grid (config_for): one TileBox a block into boxes (device
// memory, room for capacity), the number found in *count (device memory,
// zeroed by the caller). Returns a cudaError_t.
extern "C" int flash_attention_bwd_tile_probe(int pass, int B, int S, int Hq, int Hkv, int hd,
                                              void* boxes, int capacity, void* count,
                                              void* stream) {
  if (B <= 0 || S <= 0 || Hq <= 0) return 0;
  LaunchConfig c;
  if (!config_for(pass, hd, B, S, Hq, Hkv, &c)) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(c.grid[0]), static_cast<unsigned>(c.grid[1]),
                  static_cast<unsigned>(c.grid[2]));
  flash_bwd_tile_probe_kernel<<<grid, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      pass, static_cast<TileBox*>(boxes), capacity, static_cast<unsigned int*>(count));
  return static_cast<int>(cudaGetLastError());
}

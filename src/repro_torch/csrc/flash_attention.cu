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
// ~680 flops per byte, far above the H100's ridge. Only the bf16 tensor
// cores (989 TFLOP/s) can approach the 0.14 ms bound; scalar fp32 FMAs on
// the CUDA cores (67 TFLOP/s) cannot go below ~2 ms.
//
// Two kernels, chosen by one rule (wgmma_path below):
//
// * bf16 with hd 64, 112, 128, 192 or 256 (every serving width but the
//   smoke models' 32): the wgmma kernel. Consumer warpgroups own 64 q rows
//   each: one at hd 64 / 112 / 128, two at 192 / 256; a block is (q tile
//   of 64 or 128 rows, q head, batch), costliest q tiles launched first.
//   One thread issues TMA loads through 4-D tensor maps (hd, heads, S, B),
//   so a tile never reads another batch's or head's rows and keys past Sk
//   arrive as zeros: the Q tile once, then K and V tiles of 64 keys
//   through a 2-stage ring that the warpgroups share, completion on
//   mbarriers; the next tile's loads overlap this tile's products. Tiles
//   land 128-byte swizzled in 64-column boxes, the layout wgmma reads
//   without bank conflicts. hd 112 is the hd-128 kernel on a zero-padded
//   box: the tensor map keeps the true width (224-byte rows), so TMA fills
//   columns 112-127 of the second box with zeros (still counted in the
//   barrier's bytes); S skips the zero slice and those output columns are
//   not stored. S = Q K^T is a wgmma m64n64k16 with both operands in
//   shared memory (K is K-major as stored). The online softmax runs on the
//   fp32 accumulator fragments: each thread holds 2 rows x 16 keys and
//   reduces a row over the 4 lanes that share it. On the card it costs
//   about as much as the products, so it is lean: the running max stays in
//   raw scores, each p is one FFMA (the 1/sqrt(hd) scale folded into log2
//   units) and one ex2.approx, and only tiles that cross the causal
//   diagonal, the window edge or kv_len mask per element, from each
//   register's (row, key). P is packed to bf16 straight from the S
//   fragments into wgmma's register A operand, and O += P V is a wgmma
//   with V read MN-major (hd contiguous: the transpose bit), in pieces of
//   n128 (hd 128, 256) or n64 (hd 64, 192) output columns. P is rounded to
//   bf16 before P V; the row sums l add the fp32 p. At hd 64-128 two
//   blocks share an SM so that one's softmax overlaps the other's
//   products. At hd 192 / 256 O takes 96 / 128 fp32 registers a thread and
//   the ring 144 / 192 KB, so one block of two warpgroups fills an SM; a
//   block's k range is the union of its warpgroups' ranges, and a tile
//   with no live key for one warpgroup's rows is masked whole for it;
// * fp32 (the parity runs), bf16 hd 32, and a k/v with no keys: the
//   scalar kernel, fp32 FMAs on the CUDA cores. One block of 256 threads
//   per tile of 64 q rows walks the k tiles; Q (transposed, pre-scaled), K
//   and V tiles live in shared memory as fp32 and each thread computes a
//   4 x 4 block of scores and a 4 x hd/16 block of the output. The tile
//   loads stride a tile's 16-byte chunks over the 256 threads, so a chunk
//   count that 256 does not divide (hd 112: 14 or 28 a row) leaves some
//   threads a chunk short. bf16 hd 32 stays here: its 64-byte rows would
//   need the 64-byte swizzle, a second descriptor layout that no serving
//   model needs.
//
// Both walk the k tiles of a q tile from the window's first live tile to
// the causal diagonal and kv_len (the TPU's sequential k grid axis and its
// pl.when tile skip), mask per element against absolute indices (so no
// caller pads), never take exp() of a masked score (its probability is 0
// outright; the running max starts at the finite NEG_INF), and write 0 for
// a row with no live key, never NaN.
//
// Shared memory: scalar (2 * hd * 64 + 64 * hd + 64 * 64) * 4 bytes, 112 KB
// at hd 128 and 208 KB at hd 256 (one block an SM, under the 227 KB
// opt-in); wgmma (warpgroups + 4) tiles of 64 rows x the padded width in
// bf16: 80 KB at hd 112 / 128 (two blocks an SM), 144 KB at 192, 192 KB at
// 256. At hd 256 a scalar thread holds 64 fp32 accumulators. Head widths
// 32, 64, 112, 128, 192 and 256 (every head_dim of the model registry) are
// compiled; any other width is refused with cudaErrorInvalidValue (the
// Python wrapper raises first).

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper.cuh"
#include "launch_config.cuh"

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

// The block -> output tile mapping both kernels use: one block per (q tile,
// query head, batch row), q tiles in reverse launch order (the costliest,
// along the causal diagonal's far end, first). The tile probe calls it too.
struct FlashTile {
  int qt, h, b;
};

__device__ __forceinline__ FlashTile flash_tile() {
  const int num_qt = gridDim.x;
  FlashTile t;
  t.qt = num_qt - 1 - blockIdx.x;   // costliest tiles first
  t.h = blockIdx.y;
  t.b = blockIdx.z;
  return t;
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_scalar_kernel(Params prm) {
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
  const FlashTile tile = flash_tile();
  const int qt = tile.qt;
  const int h = tile.h;
  const int b = tile.b;
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

// One block per (kBQ query rows, query head, batch row); the output's
// dims are (Sq, Hq, B).
template <int HD>
LaunchConfig scalar_config(int B, int Sq, int Hq) {
  const long long rows = (Sq + kBQ - 1) / kBQ;
  const int smem = (2 * HD * kBQ + kBK * HD + kBK * kBQ) * static_cast<int>(sizeof(float));
  LaunchConfig c{{rows, Hq, B}, {rows * kBQ, Hq, B}, kThreads, smem, 0, 4};
  return c;
}

template <typename T, int HD>
cudaError_t launch(const Params& prm, cudaStream_t stream) {
  const LaunchConfig c = scalar_config<HD>(prm.B, prm.Sq, prm.Hq);
  cudaError_t err = cudaFuncSetAttribute(
      flash_scalar_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      c.smem_bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>(c.grid[0]), static_cast<unsigned>(c.grid[1]),
                  static_cast<unsigned>(c.grid[2]));
  flash_scalar_kernel<T, HD><<<grid, c.threads, c.smem_bytes, stream>>>(prm);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_hd(int hd, const Params& prm, cudaStream_t stream) {
  switch (hd) {
    case 32: return launch<T, 32>(prm, stream);
    case 64: return launch<T, 64>(prm, stream);
    case 112: return launch<T, 112>(prm, stream);
    case 128: return launch<T, 128>(prm, stream);
    case 192: return launch<T, 192>(prm, stream);
    case 256: return launch<T, 256>(prm, stream);
    default: return cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// wgmma path: bf16, hd 64, 112, 128 (one warpgroup), 192 and 256 (two)
// ---------------------------------------------------------------------------
constexpr int kWgStages = 2;                    // K/V ring depth
constexpr int kBoxBytes = 64 * 128;             // 64 rows x 128 B, one TMA box
constexpr float kLog2e = 1.4426950408889634f;

// HD is the true head width; the tiles are kHDP wide, whole 64-column
// boxes (hd 112 pads to 128: TMA fills columns 112-127 with zeros). NWG
// consumer warpgroups own 64 q rows each and share every K / V stage.
template <int HD, int NWG>
struct WgLayout {
  static constexpr int kHDP = (HD + 63) / 64 * 64;         // padded width
  static constexpr int kBoxes = kHDP / 64;                  // 64-column boxes per row
  static constexpr int kTileBytes = kBoxes * kBoxBytes;     // 64 rows x kHDP bf16
  static constexpr int kRows = 64 * NWG;                    // q rows of a block
  static constexpr int kThreads = 128 * NWG;
  // O += P V is issued in pieces of kPiece output columns: n128 where the
  // width is a multiple of 128, else n64 (3 x n64 at 192)
  static constexpr int kPiece = kHDP % 128 == 0 ? 128 : 64;
  static constexpr int kPieces = kHDP / kPiece;
  static constexpr int kQ = 0;                              // [NWG] tiles
  static constexpr int kK = kQ + NWG * kTileBytes;          // [kWgStages] tiles
  static constexpr int kV = kK + kWgStages * kTileBytes;    // [kWgStages] tiles
  static constexpr int kBar = kV + kWgStages * kTileBytes;  // q_full, kv_full[2]
  static constexpr int kSmem = kBar + 64 + 1024;            // + slack to align
};

// O piece += P V for one k16 slice: A = P from registers, B = V MN-major.
template <int N>
__device__ __forceinline__ void wgmma_pv(float (&o)[N / 2], const uint32_t (&p)[4],
                                         uint64_t desc_v) {
  if constexpr (N == 128) {
    hopper::wgmma_m64n128k16_rs<1>(o, p, desc_v, 1);
  } else {
    hopper::wgmma_m64n64k16_rs<1>(o, p, desc_v, 1);
  }
}

// 2^x in one MUFU op, denormals flushed (exp2f adds range handling)
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Online softmax of one 64 x 64 tile on its S accumulator fragments: the
// raw scores in sc become p = 2^((s - m) * scale), the running max m (raw
// units) and this thread's share l of each row sum move on, and alpha is the
// factor O must take. Thread rows qrow and qrow + 8; its keys kcol + 8i +
// {0, 1}. Only EDGE tiles (crossing the causal diagonal, the window edge
// or kv_len) mask, per element; a masked score never reaches exp2: its p
// is 0 outright.
template <bool EDGE>
__device__ __forceinline__ void softmax_tile(float (&sc)[32], float (&m)[2], float (&l)[2],
                                             float (&alpha)[2], const Params& prm,
                                             int qrow, int kcol, float scale) {
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int qi = qrow + 8 * hh;
    uint32_t live = 0xffffffffu;                // bit 2i + e: key kcol + 8i + e
    float mx = kNegInf;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float x = sc[4 * i + 2 * hh + e];
        if (EDGE) {
          const int kj = kcol + 8 * i + e;
          bool ok = kj < prm.kv_len;
          if (prm.causal) ok = ok && kj <= qi;
          if (prm.window > 0) ok = ok && (qi - kj < prm.window);
          if (ok) {
            mx = fmaxf(mx, x);
          } else {
            live &= ~(1u << (2 * i + e));
          }
        } else {
          mx = fmaxf(mx, x);
        }
      }
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m[hh], mx);
    alpha[hh] = fast_exp2((m[hh] - m_new) * scale);   // 1 while nothing is live
    m[hh] = m_new;
    const float ms = m_new * scale;
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float& x = sc[4 * i + 2 * hh + e];
        if (EDGE) {
          x = ((live >> (2 * i + e)) & 1u) ? fast_exp2(fmaf(x, scale, -ms)) : 0.f;
        } else {
          x = fast_exp2(fmaf(x, scale, -ms));
        }
        sum += x;
      }
    }
    l[hh] = l[hh] * alpha[hh] + sum;
  }
}

template <int HD, int NWG>
__global__ void __launch_bounds__(128 * NWG, NWG == 1 ? 2 : 1)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap q_map,
                   const __grid_constant__ CUtensorMap k_map,
                   const __grid_constant__ CUtensorMap v_map, Params prm) {
  using L = WgLayout<HD, NWG>;
  extern __shared__ uint8_t smem_raw[];
  // swizzled tiles start on 1024-byte boundaries (of the shared window)
  uint8_t* smem = smem_raw + ((1024u - (hopper::smem_u32(smem_raw) & 1023u)) & 1023u);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + L::kBar);
  uint64_t* kv_full = q_full + 1;

  const int tid = threadIdx.x;
  const FlashTile tile = flash_tile();
  const int qt = tile.qt;
  const int h = tile.h;
  const int b = tile.b;
  const int hk = h / (prm.Hq / prm.Hkv);
  const int q0 = qt * L::kRows;
  // this warpgroup's rows start at qw; n_q warpgroups hold rows (with one
  // warpgroup, both are known here and the code is the one-warpgroup
  // kernel). A warpgroup with no row computes on a Q tile that is never
  // loaded and stores nothing: rows do not mix, so it changes no other row.
  const int wg = NWG == 1 ? 0 : tid / 128;
  const int qw = q0 + 64 * wg;
  const int n_q = NWG == 1 ? 1 : min(NWG, (prm.Sq - q0 + 63) / 64);

  // k range of the block (the union of its warpgroups'), in whole tiles
  const int kv_len = prm.kv_len;
  const int q_last = min(q0 + L::kRows, prm.Sq) - 1;
  int k_end = kv_len;
  if (prm.causal) k_end = min(k_end, q_last + 1);
  int k_begin = 0;
  if (prm.window > 0) k_begin = max(0, q0 - prm.window + 1);
  k_begin = (k_begin / kBK) * kBK;
  const int n_tiles = k_end > k_begin ? (k_end - k_begin + kBK - 1) / kBK : 0;

  if (tid == 0) {
    hopper::mbar_init(q_full, 1);
    for (int s = 0; s < kWgStages; ++s) hopper::mbar_init(&kv_full[s], 1);
    hopper::mbar_fence_init();
  }
  __syncthreads();

  // one thread issues every load: K and V of k tile j into stage j % 2
  auto load_kv = [&](int j) {
    const int s = j % kWgStages;
    const int kt0 = k_begin + j * kBK;
    uint8_t* ks = smem + L::kK + s * L::kTileBytes;
    uint8_t* vs = smem + L::kV + s * L::kTileBytes;
    hopper::mbar_arrive_expect_tx(&kv_full[s], 2 * L::kTileBytes);
#pragma unroll
    for (int c = 0; c < L::kBoxes; ++c) {
      hopper::tma_load_4d(ks + c * kBoxBytes, &k_map, &kv_full[s], 64 * c, hk, kt0, b);
      hopper::tma_load_4d(vs + c * kBoxBytes, &v_map, &kv_full[s], 64 * c, hk, kt0, b);
    }
  };
  if (tid == 0 && n_tiles > 0) {
    // the Q rows of each warpgroup that holds any; a box counts its full
    // bytes, zero-filled past Sq and past HD
    hopper::mbar_arrive_expect_tx(q_full, n_q * L::kTileBytes);
    for (int w = 0; w < n_q; ++w) {
#pragma unroll
      for (int c = 0; c < L::kBoxes; ++c)
        hopper::tma_load_4d(smem + L::kQ + w * L::kTileBytes + c * kBoxBytes, &q_map,
                            q_full, 64 * c, h, q0 + 64 * w, b);
    }
    load_kv(0);
  }

  // this thread's rows of its warpgroup's tile (fragment layout: see hopper.cuh)
  const int warp = (tid % 128) / 32, lane = tid % 32;
  const int row_in = 16 * warp + lane / 4;      // and row_in + 8
  const int col_in = 2 * (lane & 3);            // within each n8 block
  const uint8_t* qs = smem + L::kQ + wg * L::kTileBytes;

  float o[L::kPieces][L::kPiece / 2];
#pragma unroll
  for (int c = 0; c < L::kPieces; ++c)
#pragma unroll
    for (int i = 0; i < L::kPiece / 2; ++i) o[c][i] = 0.f;
  float m[2] = {kNegInf, kNegInf};              // running max of the raw scores
  float l[2] = {0.f, 0.f};                      // this thread's share of the row sum
  float sc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) sc[i] = 0.f;
  const float scale = prm.sm_scale * kLog2e;

  if (n_tiles > 0) hopper::mbar_wait(q_full, 0);
  for (int j = 0; j < n_tiles; ++j) {
    const int s = j % kWgStages;
    const int kt0 = k_begin + j * kBK;
    // stage (j + 1) % 2 was freed by the barrier that ended tile j - 1
    if (tid == 0 && j + 1 < n_tiles) load_kv(j + 1);
    hopper::mbar_wait(&kv_full[s], (j / kWgStages) & 1);
    const uint8_t* ks = smem + L::kK + s * L::kTileBytes;
    const uint8_t* vs = smem + L::kV + s * L::kTileBytes;

    // ---- S = Q K^T: HD / 16 k16 slices (the zero columns of a padded
    // box are left out); K-major operands advance 32 B a slice inside a
    // 128 B swizzled row, the next 64 columns a box later
    hopper::wgmma_fence();
#pragma unroll
    for (int t = 0; t < HD / 16; ++t) {
      const int off = (t / 4) * kBoxBytes + (t % 4) * 32;
      hopper::wgmma_m64n64k16_ss<0>(
          sc, hopper::smem_desc_sw128(qs + off, 16, 1024),
          hopper::smem_desc_sw128(ks + off, 16, 1024), t > 0 ? 1 : 0);
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(sc);

    // ---- mask, online softmax, P -> bf16 A fragments. Whether a tile is
    // an EDGE tile is decided for the block's rows q0 .. q0 + kRows - 1: a
    // test on one warpgroup's rows would depend on the thread index, and
    // ptxas serializes wgmma calls behind a branch on it. The block's k
    // range is the union of its warpgroups', so a tile may hold no live
    // key for one warpgroup's rows (its last causal tile for warpgroup 0,
    // its first window tile for warpgroup 1): it is an EDGE tile, every p
    // is 0, and m, l and O stay as they were.
    const bool edge = kt0 + kBK > kv_len || (prm.causal && kt0 + kBK - 1 > q0) ||
                      (prm.window > 0 && q0 + L::kRows - 1 - kt0 >= prm.window);
    float alpha[2];
    if (edge) {
      softmax_tile<true>(sc, m, l, alpha, prm, qw + row_in, kt0 + col_in, scale);
    } else {
      softmax_tile<false>(sc, m, l, alpha, prm, qw + row_in, kt0 + col_in, scale);
    }
#pragma unroll
    for (int c = 0; c < L::kPieces; ++c) {
#pragma unroll
      for (int i = 0; i < L::kPiece / 8; ++i) {
        o[c][4 * i + 0] *= alpha[0];
        o[c][4 * i + 1] *= alpha[0];
        o[c][4 * i + 2] *= alpha[1];
        o[c][4 * i + 3] *= alpha[1];
      }
    }
    // the S fragment of keys 16t..16t+15 is the A fragment of k slice t
    uint32_t p[4][4];
#pragma unroll
    for (int t = 0; t < 4; ++t) {
#pragma unroll
      for (int r = 0; r < 4; ++r)
        p[t][r] = hopper::pack_bf16(sc[8 * t + 2 * r], sc[8 * t + 2 * r + 1]);
    }

    // ---- O += P V: 4 k16 slices of 16 keys, V MN-major (16 rows = 2048 B
    // a slice; the next 64 hd columns one box, LBO, later), each slice in
    // kPieces products of kPiece columns
    hopper::wgmma_fence();
#pragma unroll
    for (int t = 0; t < 4; ++t) {
#pragma unroll
      for (int c = 0; c < L::kPieces; ++c)
        wgmma_pv<L::kPiece>(
            o[c], p[t],
            hopper::smem_desc_sw128(vs + c * (L::kPiece / 64) * kBoxBytes + t * 2048,
                                    kBoxBytes, 1024));
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
#pragma unroll
    for (int c = 0; c < L::kPieces; ++c) hopper::fence_regs(o[c]);
#pragma unroll
    for (int t = 0; t < 4; ++t) hopper::fence_regs(p[t]);
    __syncthreads();   // every product that read stage s is done: it may refill
  }

  // ---- out = O / l; a row with no live key (l == 0) writes 0; the zero
  // columns of a padded box are not stored
  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(prm.out);
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    float sum = l[hh];
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    const float inv = sum == 0.f ? 0.f : 1.f / sum;
    const int qi = qw + row_in + 8 * hh;
    if (qi >= prm.Sq) continue;
    __nv_bfloat16* orow =
        out + ((static_cast<int64_t>(b) * prm.Sq + qi) * prm.Hq + h) * HD + col_in;
#pragma unroll
    for (int c = 0; c < L::kPieces; ++c) {
#pragma unroll
      for (int i = 0; i < L::kPiece / 8; ++i) {
        const int col = c * L::kPiece + 8 * i;
        if (col < HD)
          *reinterpret_cast<uint32_t*>(orow + col) = hopper::pack_bf16(
              o[c][4 * i + 2 * hh] * inv, o[c][4 * i + 2 * hh + 1] * inv);
      }
    }
  }
}

// A 4-D tensor map over a contiguous (B, S, H, hd) bf16 tensor, dims
// innermost first (hd, H, S, B), boxes of 64 columns x 1 head x 64 rows.
bool make_bshd_map(CUtensorMap* map, const void* base, int B, int S, int H, int hd) {
  const uint64_t dims[4] = {static_cast<uint64_t>(hd), static_cast<uint64_t>(H),
                            static_cast<uint64_t>(S), static_cast<uint64_t>(B)};
  const uint64_t row = static_cast<uint64_t>(hd) * 2;
  const uint64_t strides[3] = {row, row * H, row * H * S};
  const uint32_t box[4] = {64, 1, static_cast<uint32_t>(kBQ), 1};
  return hopper::make_tensor_map_bf16(map, base, 4, dims, strides, box);
}

// One block per (kRows query rows, query head, batch row).
template <int HD, int NWG>
LaunchConfig wgmma_config(int B, int Sq, int Hq) {
  using L = WgLayout<HD, NWG>;
  const long long rows = (Sq + L::kRows - 1) / L::kRows;
  LaunchConfig c{{rows, Hq, B}, {rows * L::kRows, Hq, B}, L::kThreads, L::kSmem, 1, 4};
  return c;
}

template <int HD, int NWG>
cudaError_t launch_wgmma(const Params& prm, cudaStream_t stream) {
  CUtensorMap qm, km, vm;
  if (!make_bshd_map(&qm, prm.q, prm.B, prm.Sq, prm.Hq, HD) ||
      !make_bshd_map(&km, prm.k, prm.B, prm.Sk, prm.Hkv, HD) ||
      !make_bshd_map(&vm, prm.v, prm.B, prm.Sk, prm.Hkv, HD))
    return cudaErrorInvalidValue;
  const LaunchConfig c = wgmma_config<HD, NWG>(prm.B, prm.Sq, prm.Hq);
  const cudaError_t err = cudaFuncSetAttribute(
      flash_wgmma_kernel<HD, NWG>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      c.smem_bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>(c.grid[0]), static_cast<unsigned>(c.grid[1]),
                  static_cast<unsigned>(c.grid[2]));
  flash_wgmma_kernel<HD, NWG><<<grid, c.threads, c.smem_bytes, stream>>>(qm, km, vm, prm);
  return cudaGetLastError();
}

// The rule: bf16 with hd 64, 112, 128, 192 or 256 and at least one key
// takes the wgmma kernel; everything else (fp32, bf16 hd 32, Sk 0) the
// scalar one. The wrapper has already checked contiguity and 16-byte
// alignment, which TMA needs too.
bool wgmma_path(int dtype, int hd, int Sk) {
  return dtype == 1 && Sk > 0 &&
         (hd == 64 || hd == 112 || hd == 128 || hd == 192 || hd == 256);
}

cudaError_t dispatch_wgmma(int hd, const Params& prm, cudaStream_t stream) {
  switch (hd) {
    case 64: return launch_wgmma<64, 1>(prm, stream);
    case 112: return launch_wgmma<112, 1>(prm, stream);
    case 128: return launch_wgmma<128, 1>(prm, stream);
    case 192: return launch_wgmma<192, 2>(prm, stream);
    case 256: return launch_wgmma<256, 2>(prm, stream);
    default: return cudaErrorInvalidValue;
  }
}

// The configuration flash_attention_launch uses: false for a width no
// kernel is compiled for.
bool config_for(int dtype, int hd, int Sk, int B, int Sq, int Hq, LaunchConfig* c) {
  if (wgmma_path(dtype, hd, Sk)) {
    switch (hd) {
      case 64: *c = wgmma_config<64, 1>(B, Sq, Hq); return true;
      case 112: *c = wgmma_config<112, 1>(B, Sq, Hq); return true;
      case 128: *c = wgmma_config<128, 1>(B, Sq, Hq); return true;
      case 192: *c = wgmma_config<192, 2>(B, Sq, Hq); return true;
      case 256: *c = wgmma_config<256, 2>(B, Sq, Hq); return true;
      default: return false;
    }
  }
  if (dtype != 0 && dtype != 1) return false;
  switch (hd) {
    case 32: *c = scalar_config<32>(B, Sq, Hq); return true;
    case 64: *c = scalar_config<64>(B, Sq, Hq); return true;
    case 112: *c = scalar_config<112>(B, Sq, Hq); return true;
    case 128: *c = scalar_config<128>(B, Sq, Hq); return true;
    case 192: *c = scalar_config<192>(B, Sq, Hq); return true;
    case 256: *c = scalar_config<256>(B, Sq, Hq); return true;
    default: return false;
  }
}

// One thread a block, on the launch's grid: the block's output box, rows
// [q0, q0 + rows) of its q tile (past Sq the kernels' stores are guarded),
// its query head and its batch row.
__global__ void flash_tile_probe_kernel(long long rows, TileBox* boxes, int capacity,
                                        unsigned int* count) {
  const FlashTile t = flash_tile();
  const long long q0 = t.qt * rows;
  emit_box(boxes, capacity, count, t.qt, t.h, t.b, q0, t.h, t.b, q0 + rows, t.h + 1,
           t.b + 1);
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
  if (wgmma_path(dtype, hd, Sk)) return static_cast<int>(dispatch_wgmma(hd, prm, s));
  if (dtype == 0) return static_cast<int>(dispatch_hd<float>(hd, prm, s));
  if (dtype == 1) return static_cast<int>(dispatch_hd<__nv_bfloat16>(hd, prm, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

// Which kernel flash_attention_launch takes for these operands: 1 the
// wgmma kernel, 0 the scalar one.
extern "C" int flash_attention_path(int dtype, int hd, int Sk) {
  return wgmma_path(dtype, hd, Sk) ? 1 : 0;
}

// The launch configuration flash_attention_launch uses for these shapes:
// the output's dims are (Sq, Hq, B). Returns 0, or cudaErrorInvalidValue
// for a dtype or head width no kernel is compiled for.
extern "C" int flash_attention_launch_config(int dtype, int B, int Sq, int Sk, int Hq,
                                             int hd, LaunchConfig* out) {
  return config_for(dtype, hd, Sk, B, Sq, Hq, out) ? 0
                                                  : static_cast<int>(cudaErrorInvalidValue);
}

// The output boxes of flash_attention_launch's blocks for these shapes,
// from flash_tile on the launch's own grid (config_for): one TileBox a
// block into boxes (device memory, room for capacity), the number found in
// *count (device memory, zeroed by the caller). Returns a cudaError_t.
extern "C" int flash_attention_tile_probe(int dtype, int B, int Sq, int Sk, int Hq, int hd,
                                          void* boxes, int capacity, void* count,
                                          void* stream) {
  if (B <= 0 || Sq <= 0 || Hq <= 0) return 0;
  LaunchConfig c;
  if (!config_for(dtype, hd, Sk, B, Sq, Hq, &c)) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(c.grid[0]), static_cast<unsigned>(c.grid[1]),
                  static_cast<unsigned>(c.grid[2]));
  flash_tile_probe_kernel<<<grid, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      c.cover[0] / c.grid[0], static_cast<TileBox*>(boxes), capacity,
      static_cast<unsigned int*>(count));
  return static_cast<int>(cudaGetLastError());
}

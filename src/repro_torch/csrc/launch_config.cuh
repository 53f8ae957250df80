// The launch configuration every kernel library reports through its
// `<name>_launch_config` C entry: the grid, block and dynamic shared memory
// its launch uses, the output extent that grid covers, the path taken and
// the accumulator's width. Each library computes it in one function that
// its launch calls too, so `repro_torch.analysis.kernel_lint` checks the
// numbers the card is given, not a copy of the rule.
//
// Beside it, each library's `<name>_tile_probe` C entry launches a probe
// kernel on the same grid that calls the kernel's own block -> tile
// functions and writes one TileBox per output tile a block (or, for a
// persistent or grid-stride kernel, a visit) stores: the output box a
// block owns, before its per-element store guards.
#pragma once

struct LaunchConfig {
  long long grid[3];    // blocks along x, y, z
  long long cover[3];   // output extent the grid covers along the output's
                        // three logical dims (a kernel's own order, named
                        // by the wrapper's `launch_config`)
  int threads;          // per block
  int smem_bytes;       // dynamic shared memory per block
  int path;             // 1: the tensor-core kernel (wgmma / mma.sync), 0: scalar
  int acc_bytes;        // bytes of one accumulator element (4: fp32)
};

struct TileBox {
  long long writer[3];  // the writing block's (or tile's) coordinates along
                        // the wrapper's KERNEL_CONTRACT grid axes
  long long lo[3];      // the box's first element along cover's three dims
  long long hi[3];      // one past its last
};

#ifdef __CUDACC__
// Append one box to the probe's output; `count` ends as the number of boxes
// the probe found, which may exceed `capacity` (the caller then asks again
// with room for all of them).
__device__ __forceinline__ void emit_box(TileBox* boxes, int capacity, unsigned int* count,
                                         long long w0, long long w1, long long w2,
                                         long long l0, long long l1, long long l2,
                                         long long h0, long long h1, long long h2) {
  const unsigned int i = atomicAdd(count, 1u);
  if (i >= static_cast<unsigned int>(capacity)) return;
  TileBox& b = boxes[i];
  b.writer[0] = w0;
  b.writer[1] = w1;
  b.writer[2] = w2;
  b.lo[0] = l0;
  b.lo[1] = l1;
  b.lo[2] = l2;
  b.hi[0] = h0;
  b.hi[1] = h1;
  b.hi[2] = h2;
}
#endif

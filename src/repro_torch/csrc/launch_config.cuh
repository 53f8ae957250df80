// The launch configuration every kernel library reports through its
// `<name>_launch_config` C entry: the grid, block and dynamic shared memory
// its launch uses, the output extent that grid covers, the path taken and
// the accumulator's width. Each library computes it in one function that
// its launch calls too, so `repro_torch.analysis.kernel_lint` checks the
// numbers the card is given, not a copy of the rule.
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

"""Model FLOPs utilization, %: the model FLOPs of the window's steps
(the configuration's own count, ``flops_per_token``) over window seconds
x chips x 989 TFLOP/s (dense bf16, NVIDIA's H100 SXM data sheet)."""


def read(run):
    return 100.0 * run.steps * run.flops_per_step / (run.window_s * run.chips * run.peak_flops)

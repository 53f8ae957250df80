"""The whole step's share of the card's bf16 peak over the traced
window, %: the model FLOPs of its steps over its seconds x chips x 989
TFLOP/s. It stands beside the kernels' roofline shares that move the
same end-to-end metric: a change that takes a kernel off the path
leaves that kernel's share silent, and this one still reads."""


def read(rec):
    w = rec.windows[0]
    return 100.0 * w["steps"] * rec.flops_per_step / (w["window_s"] * rec.chips * rec.peak_flops)

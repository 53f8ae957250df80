"""Training tokens a second: every node's tokens in every step of the
window, over the window's seconds (step boundaries as CUDA events)."""


def read(run):
    return run.steps * run.tokens_per_step / run.window_s

"""Mean milliseconds a step of the latent-attention blocks: the ``mla``
spans (each block's forward, and remat's recompute of it inside
``backward``) plus the ``mla/backward`` spans (its backward, from its
output's gradient to its input's), that ``models/attention.py::mla_block``
opens on the step's spans (CUDA events, unfenced; summed over a step,
averaged over the traced window's steps after the profiled ones and the
ranks). A split of the card's time: a window whose profile saw no device
activity (a run on the CPU) reads nothing, and so does a program whose
step has no ``mla`` spans."""


def read(rec):
    per = [p["mla"] + p.get("mla/backward", 0.0) for w in rec.windows
           if (w.get("profile") or {}).get("busy_s") for p in w.get("phases", []) if "mla" in p]
    return sum(per) / len(per) if per else None

"""Mean milliseconds a step of the MoE blocks (the expert share): the
``moe`` spans (each block's forward: router, the held experts' grouped
products, the shared experts; and remat's recompute of it inside
``backward``) plus the ``moe/backward`` spans (its backward), that
``models/ffn.py::moe_block`` opens on the step's spans (CUDA events,
unfenced; summed over a step, averaged over the traced window's steps
after the profiled ones and the ranks). A split of the card's time: a
window whose profile saw no device activity (a run on the CPU) reads
nothing, and so does a program whose step has no ``moe`` spans."""


def read(rec):
    per = [p["moe"] + p.get("moe/backward", 0.0) for w in rec.windows
           if (w.get("profile") or {}).get("busy_s") for p in w.get("phases", []) if "moe" in p]
    return sum(per) / len(per) if per else None

"""Mean milliseconds a step of the ``backward`` spans that ``TrainStep``
records inside each node's ``fwd_bwd``: the gradient, with remat's
recompute of the forward in it, and the clip (CUDA events, unfenced;
summed over a step's spans, averaged over the traced window's steps
after the profiled ones and the ranks). A split of the card's time: a
window whose profile saw no device activity (a run on the CPU, where the
spans time the host) reads nothing."""


def read(rec):
    per = [p.get("backward") for w in rec.windows if (w.get("profile") or {}).get("busy_s")
           for p in w.get("phases", [])]
    per = [v for v in per if v is not None]
    return sum(per) / len(per) if per else None

"""Mean milliseconds a step of the ``forward`` spans that ``TrainStep``
records inside each node's ``fwd_bwd``: the node's loss (CUDA events,
unfenced; summed over a step's spans, averaged over the traced window's
steps after the profiled ones and the ranks). A split of the card's
time: a window whose profile saw no device activity (a run on the CPU,
where the spans time the host) reads nothing."""


def read(rec):
    per = [p.get("forward") for w in rec.windows if (w.get("profile") or {}).get("busy_s")
           for p in w.get("phases", [])]
    per = [v for v in per if v is not None]
    return sum(per) / len(per) if per else None

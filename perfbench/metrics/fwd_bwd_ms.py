"""Mean milliseconds a step of the ``fwd_bwd`` spans that ``TrainStep``
records (CUDA events, unfenced; summed over a step's spans, averaged
over the traced window's steps and the ranks)."""


def read(rec):
    per = [p.get("fwd_bwd") for w in rec.windows for p in w.get("phases", [])]
    per = [v for v in per if v is not None]
    return sum(per) / len(per) if per else None

"""The device's idle share of the profiled steps, %: 1 - the union of
its activities' intervals over the steps' span between CUDA events,
averaged over the ranks."""


def read(rec):
    shares = [100.0 * (1.0 - w["profile"]["busy_s"] / w["profile"]["window_s"])
              for w in rec.windows if w.get("profile") and w["profile"]["busy_s"]]
    return sum(shares) / len(shares) if shares else None

"""The gossip-axpy kernel's share of its roofline, %: the least time its
bytes allow (x read, the fp32 target read, x written, for every
parameter of every local node, at 3.35 TB/s) over its device time in the
profiled steps (torch.profiler), averaged over the ranks."""


def read(rec):
    shares = []
    for w, nbytes in zip(rec.windows, rec.axpy_bytes_per_step):
        p = w.get("profile")
        if not p or not p["gossip_axpy_s"]:
            continue
        bound = nbytes * p["steps"] / rec.hbm_bytes_per_s
        shares.append(100.0 * bound / p["gossip_axpy_s"])
    return sum(shares) / len(shares) if shares else None

"""``device.idle_pct``: the share of one profiled cycle's wall time in
which no kernel, copy or set ran on the device, %: 1 - (union of the
device's intervals / the cycle's wall).  Nothing where no device
operation ran (a run on the CPU)."""


def read(ctx):
    p = ctx["profile"]
    if not p.get("window_s") or not p.get("busy_s"):
        return None
    return 100.0 * (1.0 - p["busy_s"] / p["window_s"])

"""``train_epoch_roofline``: kernel 1's share of its roofline, %: the
least time of the profiled cycle's local epochs (``costs/train_epoch``:
rounds x epochs x one epoch of the cohort) over the device time of every
``train_epoch_kernel`` launch in that cycle (profiler)."""
from bench.costs import common, train_epoch


def read(ctx):
    spent = sum(s for n, s in ctx["profile"].get("kernel_s", {}).items()
                if "train_epoch_kernel" in n)
    if not spent or ctx["peak"] is None:
        return None
    tm, wl = ctx["config"]["tm"], ctx["workload"]
    one = train_epoch.count(tm, wl["cohort"], wl["per_client"]["train"])
    least = (ctx["cycle_rounds"] * tm["local_epochs"]
             * common.seconds(one, ctx["peak"]))
    return 100.0 * least / spent

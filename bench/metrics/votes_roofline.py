"""``votes_roofline``: kernel 2's share of its roofline, %: the least
time of the profiled cycle's vote calls (``costs/votes``: a round's
confidence pass over the cohort and evaluation of the population) over
the device time of every ``votes_mma_kernel`` launch in that cycle."""
from bench.costs import common, votes


def read(ctx):
    spent = sum(s for n, s in ctx["profile"].get("kernel_s", {}).items()
                if "votes_mma_kernel" in n)
    if not spent or ctx["peak"] is None:
        return None
    tm, wl = ctx["config"]["tm"], ctx["workload"]
    split = wl["per_client"]
    least = ctx["cycle_rounds"] * (
        common.seconds(votes.count(tm, wl["cohort"], split["conf"]),
                       ctx["peak"])
        + common.seconds(votes.count(tm, wl["population"], split["test"]),
                         ctx["peak"]))
    return 100.0 * least / spent

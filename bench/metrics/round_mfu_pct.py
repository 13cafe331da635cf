"""``round_mfu_pct``: the whole round's share of the card's peak, %: the
least time of a round's counted work (``costs/round``) over the traced
window's measured time a round."""
from bench.costs import common
from bench.costs import round as round_cost


def read(ctx):
    if ctx["peak"] is None or not ctx["round_s"]:
        return None
    least = common.seconds(
        round_cost.count(ctx["config"]["tm"], ctx["workload"]), ctx["peak"])
    return 100.0 * least / ctx["round_s"]

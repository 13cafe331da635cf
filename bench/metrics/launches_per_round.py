"""``launches_per_round``: every device operation (kernel, copy, set) of
the profiled cycle, counted by ``bench/attribution.py`` under the span
that launched it or outside every span, over the cycle's rounds."""


def read(ctx):
    counts = ctx["profile"].get("launches_by_span")
    if not counts:
        return None
    return sum(counts.values()) / ctx["cycle_rounds"]

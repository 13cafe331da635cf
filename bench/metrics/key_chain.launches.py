"""``key_chain.launches``: the device operations launched inside the
program's ``key_chain`` span in the profiled cycle (``bench/attribution.py``,
by correlation id), over the cycle's rounds."""


def read(ctx):
    counts = ctx["profile"].get("launches_by_span")
    if not counts:
        return None
    return counts.get("key_chain", 0) / ctx["cycle_rounds"]

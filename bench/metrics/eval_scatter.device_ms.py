"""``eval_scatter.device_ms``: device milliseconds of the operations
launched inside the program's ``eval_scatter`` span (the population's
scatter before its evaluation) in the profiled cycle
(``bench/attribution.py``, clipped to the cycle), over its rounds."""


def read(ctx):
    device_s = ctx["profile"].get("device_s_by_span")
    if not device_s:
        return None
    return 1e3 * device_s.get("eval_scatter", 0.0) / ctx["cycle_rounds"]

"""``eval_ms``: the engine's ``eval`` span, milliseconds a round, mean
over the traced window's rounds (host clock, the span fenced by a
device synchronize at its end)."""


def read(ctx):
    return ctx["spans_ms"].get("eval")

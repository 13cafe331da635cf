"""``key_chain_ms``: the program's ``key_chain`` span (the epoch keys of
``core/tm.py``: the split into epochs, ``draws.epoch_keys`` and the
class pairs), milliseconds a round over all its epochs, mean over the
traced window's rounds (host clock; the span waits for no device work,
so it is the host's time to issue the chain)."""


def read(ctx):
    return ctx["spans_ms"].get("key_chain")

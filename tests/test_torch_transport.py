"""The transport's wire on the port against the JAX package's: frames and
every round-protocol message pack to the reference's bytes and parse
back (hypothesis properties), every corruption fails loudly with the
reference's typed error, ``FaultPlan`` / ``RetryPolicy`` and
``arrival_participation`` behave as the reference's, and
``RuntimeConfig`` refuses what the reference refuses, with its
messages.  The numpy-only modules are the reference's code, statement
for statement."""
import ast
import dataclasses
import io
from pathlib import Path

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.fl.runtime import CodecConfig as JCodecConfig
from repro.fl.runtime import RuntimeConfig as JRuntimeConfig
from repro.fl.runtime.scheduler import \
    arrival_participation as jarrival_participation
from repro.fl.transport import faults as jfaults
from repro.fl.transport import framing as jframing
from repro.fl.transport import messages as jmsgs
from repro_torch.fl.runtime import CodecConfig, RuntimeConfig
from repro_torch.fl.runtime.scheduler import arrival_participation
from repro_torch.fl.transport import (BadMagicError, DisconnectError,
                                      FaultPlan, FrameTooLargeError,
                                      RetryPolicy, TruncatedFrameError,
                                      WireError, faults, framing)
from repro_torch.fl.transport import messages as msgs
from test_torch_gpu import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
PROPS = settings(max_examples=60, deadline=None)

u4 = st.integers(0, 2**32 - 1)
blobs = st.binary(max_size=48)


def _reader(buf: bytes):
    bio = io.BytesIO(buf)
    return lambda n: bio.read(n)


# -- the numpy-only modules are the reference's code ----------------------

def _body(path: Path) -> list[str]:
    """The module's statements after its docstring, its imports of the
    package itself (``repro`` / ``repro_torch``) left out."""
    out = []
    for node in ast.parse(path.read_text()).body[1:]:
        if isinstance(node, ast.ImportFrom) and node.module and \
                node.module.split(".")[0] in ("repro", "repro_torch"):
            continue
        out.append(ast.dump(node))
    return out


@pytest.mark.parametrize("name", ["framing", "messages", "faults",
                                  "loopback"])
def test_module_is_the_references_code(name):
    ref = ROOT / "src" / "repro" / "fl" / "transport" / f"{name}.py"
    port = ROOT / "src" / "repro_torch" / "fl" / "transport" / f"{name}.py"
    assert _body(port) == _body(ref)


# -- framing ----------------------------------------------------------------

@PROPS
@given(kind=st.integers(0, 255), payload=st.binary(max_size=512))
def test_frame_bytes_and_roundtrip(kind, payload):
    frame = framing.pack_frame(kind, payload)
    assert frame == jframing.pack_frame(kind, payload)
    assert framing.decode_frame(frame) == (kind, payload, len(frame))
    assert framing.read_frame(_reader(frame)) == (kind, payload)


@PROPS
@given(pos=st.integers(0, framing.HEADER.size - 1),
       flip=st.integers(1, 255))
def test_corrupted_header_is_never_absorbed(pos, flip):
    """Flipping a header byte raises a typed WireError or changes what
    the stream decodes to, in the port as in the reference."""
    payload = b"x" * 40
    buf = bytearray(framing.pack_frame(3, payload)
                    + framing.pack_frame(4, b"tail"))
    buf[pos] ^= flip
    outcomes = []
    for mod in (framing, jframing):
        reader = _reader(bytes(buf))
        try:
            outcomes.append([mod.read_frame(reader), mod.read_frame(reader)])
        except mod.WireError as e:
            outcomes.append(type(e).__name__)
    assert outcomes[0] == outcomes[1]
    assert outcomes[0] != [(3, payload), (4, b"tail")]


@pytest.mark.parametrize("case", ["bad_magic", "truncated_payload",
                                  "truncated_header", "boundary",
                                  "too_large", "send_too_large",
                                  "buffer_truncated"])
def test_loud_failures_match_the_reference(case, monkeypatch):
    """Each corruption raises the reference's typed error with the
    reference's message."""
    frame = framing.pack_frame(2, b"hello world")
    bad = bytearray(frame)
    bad[0] ^= 0xFF
    cases = {
        "bad_magic": (BadMagicError, lambda m: m.read_frame(
            _reader(bytes(bad)))),
        "truncated_payload": (TruncatedFrameError, lambda m: m.read_frame(
            _reader(frame[:-3]))),
        "truncated_header": (TruncatedFrameError, lambda m: m.read_frame(
            _reader(frame[:4]))),
        "boundary": (DisconnectError, lambda m: m.read_frame(_reader(b""))),
        "too_large": (FrameTooLargeError, lambda m: m.read_frame(_reader(
            m.HEADER.pack(m.MAGIC, 1, m.MAX_FRAME + 1)))),
        "send_too_large": (FrameTooLargeError,
                           lambda m: m.pack_frame(1, b"x" * 9)),
        "buffer_truncated": (TruncatedFrameError,
                             lambda m: m.decode_frame(frame[:-1])),
    }
    err, call = cases[case]
    if case == "send_too_large":      # a small ceiling, in both packages
        monkeypatch.setattr(framing, "MAX_FRAME", 8)
        monkeypatch.setattr(jframing, "MAX_FRAME", 8)
    with pytest.raises(err) as ours:
        call(framing)
    assert issubclass(err, WireError)
    jerr = getattr(jframing, err.__name__)
    with pytest.raises(jerr) as theirs:
        call(jframing)
    assert str(ours.value) == str(theirs.value)


# -- round-protocol messages ----------------------------------------------

def _pair(name, **fields):
    return getattr(msgs, name)(**fields), getattr(jmsgs, name)(**fields)


@PROPS
@given(rank=u4, lo=u4, hi=u4)
def test_hello_bytes(rank, lo, hi):
    ours, ref = _pair("Hello", rank=rank, lo=lo, hi=hi)
    assert ours.pack() == ref.pack()
    assert msgs.Hello.unpack(ours.pack()) == ours


@PROPS
@given(round_idx=u4, dim=u4, rows=st.lists(blobs, max_size=4),
       clients=st.lists(st.tuples(u4, u4, u4, st.booleans(), u4),
                        max_size=5))
def test_work_bytes(round_idx, dim, rows, clients):
    ours = msgs.Work(round_idx, dim, tuple(rows), tuple(
        msgs.WorkClient(g, (k0, k1), a, s) for g, k0, k1, a, s in clients))
    ref = jmsgs.Work(round_idx, dim, tuple(rows), tuple(
        jmsgs.WorkClient(g, (k0, k1), a, s) for g, k0, k1, a, s in clients))
    assert ours.pack() == ref.pack()
    assert msgs.Work.unpack(ours.pack()) == ours


@PROPS
@given(round_idx=u4, entries=st.lists(st.tuples(
    u4, u4, u4, st.lists(st.tuples(st.integers(0, 255),
                                   st.integers(-2**31, 2**31 - 1), blobs),
                         max_size=3)), max_size=4))
def test_upload_bytes(round_idx, entries):
    def build(mod):
        return mod.Upload(round_idx, tuple(
            mod.UploadEntry(g, src, stale, tuple(frames))
            for g, src, stale, frames in entries))
    ours = build(msgs)
    assert ours.pack() == build(jmsgs).pack()
    assert msgs.Upload.unpack(ours.pack()) == ours


@PROPS
@given(round_idx=u4, dim=u4, rows=st.lists(blobs, max_size=3),
       j=st.integers(1, 3), clients=st.lists(
           st.tuples(u4, st.booleans(),
                     st.lists(st.integers(-1, 2**31 - 1), min_size=3,
                              max_size=3)), max_size=4))
def test_downlink_bytes(round_idx, dim, rows, j, clients):
    def build(mod):
        return mod.Downlink(round_idx, dim, tuple(rows), tuple(
            mod.DownClient(g, a, tuple(applied[:j]))
            for g, a, applied in clients))
    ours = build(msgs)
    assert ours.pack() == build(jmsgs).pack()
    assert msgs.Downlink.unpack(ours.pack()) == ours


@PROPS
@given(round_idx=u4, acc=st.lists(st.floats(width=32, allow_nan=False),
                                  max_size=8))
def test_eval_bytes(round_idx, acc):
    a = np.asarray(acc, np.float32)
    buf = msgs.Eval(round_idx, a).pack()
    assert buf == jmsgs.Eval(round_idx, a).pack()
    back = msgs.Eval.unpack(buf)
    assert back.round_idx == round_idx
    np.testing.assert_array_equal(back.acc.view(np.int32), a.view(np.int32))


@pytest.mark.parametrize("damage", ["trailing", "truncated"])
def test_message_damage_is_loud(damage):
    buf = msgs.Work(round_idx=0, dim=4, rows=(b"abcd",), clients=()).pack()
    bad = buf + b"\x00" if damage == "trailing" else buf[:-2]
    with pytest.raises(WireError) as ours:
        msgs.Work.unpack(bad)
    with pytest.raises(jframing.WireError) as theirs:
        jmsgs.Work.unpack(bad)
    assert str(ours.value) == str(theirs.value)


def test_msg_kinds_are_the_references():
    assert {k.name: int(k) for k in msgs.MsgKind} == \
        {k.name: int(k) for k in jmsgs.MsgKind}


# -- faults, retry, observed participation ---------------------------------

@PROPS
@given(delay=st.lists(st.tuples(st.integers(0, 3), st.integers(0, 5),
                                st.integers(0, 3)), max_size=4),
       drop=st.lists(st.tuples(st.integers(0, 3), st.integers(0, 5)),
                     max_size=4),
       disconnect=st.lists(st.tuples(st.integers(0, 2), st.integers(0, 4)),
                           max_size=4))
def test_fault_plan_matches_the_reference(delay, drop, disconnect):
    ours = FaultPlan(tuple(delay), tuple(drop), tuple(disconnect))
    ref = jfaults.FaultPlan(tuple(delay), tuple(drop), tuple(disconnect))
    for r in range(4):
        for c in range(6):
            assert ours.delay_for(r, c) == ref.delay_for(r, c)
            assert ours.dropped(r, c) == ref.dropped(r, c)
    for rk in range(3):
        for n in range(5):
            assert ours.disconnects_at(rk, n) == ref.disconnects_at(rk, n)


def test_retry_policy_matches_the_reference():
    assert dataclasses.asdict(RetryPolicy()) == \
        dataclasses.asdict(jfaults.RetryPolicy())
    for mod in (faults, jfaults):
        with pytest.raises(ValueError, match="attempts must be >= 1"):
            mod.RetryPolicy(attempts=0)
    assert FaultPlan(delay=((0, 1, 2), (0, 1, 1))).delay_for(0, 1) == 3


@PROPS
@given(lags=st.lists(st.integers(0, 4), max_size=12))
def test_arrival_participation_matches_the_reference(lags):
    ids = list(range(3, 3 + len(lags)))
    ours = arrival_participation(ids, lags, device="cpu")
    ref = jarrival_participation(ids, lags)
    assert ours.summary() == ref.summary()
    for f in ("idx", "active", "staleness"):
        a, b = getattr(ours, f).numpy(), np.asarray(getattr(ref, f))
        assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("ids,lags", [([1, 2], [0]), ([1], [-1])])
def test_arrival_participation_refusals(ids, lags):
    with pytest.raises(ValueError) as ours:
        arrival_participation(ids, lags, device="cpu")
    with pytest.raises(ValueError) as theirs:
        jarrival_participation(ids, lags)
    assert str(ours.value) == str(theirs.value)


# -- RuntimeConfig's transport checks ---------------------------------------

REFUSED = {
    "unknown": dict(transport="sockets"),
    "no_workers": dict(transport="loopback"),
    "negative_workers": dict(transport="socket", workers=-1),
    "workers_in_process": dict(transport="inprocess", workers=2),
    "async_sparse": dict(transport="socket", workers=2,
                         aggregation="async",
                         codec=dict(name="int8", sparse=True)),
    "mmap_store": dict(transport="loopback", workers=2,
                       client_store="mmap"),
    "mmap_store_ef": dict(transport="loopback", workers=2,
                          client_store="mmap",
                          codec=dict(name="int8", error_feedback=True)),
}


@pytest.mark.parametrize("case", REFUSED)
def test_runtime_config_transport_refusals(case):
    """Each refusal raises ``ValueError`` with the reference's message,
    checked in the reference's order."""
    kw = dict(REFUSED[case])
    codec = kw.pop("codec", None)
    with pytest.raises(ValueError) as ours:
        RuntimeConfig(**kw, **({"codec": CodecConfig(**codec)} if codec
                               else {}))
    with pytest.raises(ValueError) as theirs:
        JRuntimeConfig(**kw, **({"codec": JCodecConfig(**codec)} if codec
                                else {}))
    assert str(ours.value) == str(theirs.value)


@pytest.mark.parametrize("kw", [
    dict(transport="loopback", workers=1),
    dict(transport="socket", workers=4, aggregation="async"),
    dict(transport="loopback", workers=3,
         codec=dict(name="int8", sparse=True))])
def test_runtime_config_transport_accepted(kw):
    kw = dict(kw)
    codec = kw.pop("codec", None)
    extra = {"codec": CodecConfig(**codec)} if codec else {}
    cfg = RuntimeConfig(**kw, **extra)
    assert (cfg.transport, cfg.workers) == (kw["transport"], kw["workers"])
    jextra = {"codec": JCodecConfig(**codec)} if codec else {}
    JRuntimeConfig(**kw, **jextra)

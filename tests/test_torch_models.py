"""The port's model scaffold (``repro_torch.models``) against the JAX
package on the CPU, all ten architectures at their ``reduced()`` size.

Exact: ``transformer.init`` draws the reference's parameters bit for
bit (bfloat16 and float32 leaves, the reference's leaf keys), the MoE
router picks the reference's experts, the decode caches fill the
reference's slots, the int8 KV cache holds the reference's codes.

Float math is held within a stated tolerance.  With float32 parameters
the port's products and the reference's differ only in summation order,
so logits, decode, loss and gradients agree to about 1e-5 (``TOL``); the
single layers and mixers on float32 inputs to about 1e-6 (each check's
``atol``, at most 4x the largest difference measured there).  With the default bfloat16 parameters XLA:CPU and
torch round the bfloat16 activations differently (XLA keeps elementwise
chains between two bfloat16 ops in float32, torch rounds each op), so
the logits drift by up to a few bfloat16 ulps of the activations after
two layers: the bfloat16 bounds in ``TOL``, each at most 4x the largest
difference measured over the ten architectures (the drift is noise, not
a fault: the float32 checks hold the same code to 1e-5)."""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro.models import attention as jattn
from repro.models import config as jcfg
from repro.models import layers as jlayers
from repro.models import mamba as jmamba
from repro.models import moe as jmoe
from repro.models import transformer as jtr
from repro.models import xlstm as jxlstm
from repro.optim import adamw as jadamw
from repro_torch import convert
from repro_torch import random as tr
from repro_torch import tree
from repro_torch.checkpoint import ckpt
from repro_torch.configs import registry
from repro_torch.launch import steps
from repro_torch.models import attention, layers, mamba, moe, transformer
from repro_torch.models import config as mcfg
from repro_torch.models import xlstm
from repro_torch.optim import adamw
from test_torch_gpu import one_torch_thread  # noqa: F401

B, T = 2, 12
# Bounds on the differences below, each at most 4x the largest measured
# over the ten architectures.  float32 parameters (summation order only):
# max |Δ| of logits, decode logits, loss and aux; per leaf max |Δ| over
# max |reference| of the gradients.  bfloat16 parameters: max |Δ| of
# logits, decode logits and loss; per leaf ‖Δ‖ / ‖reference‖ of the
# bfloat16 gradients against the float32 reference's; AdamW's moments
# given the same gradients, per leaf max |Δ| over max |reference|.
TOL = {"logits32": 5e-5, "decode32": 6e-5, "loss32": 1.9e-6, "aux": 1.5e-5,
       "grad32": 1.9e-5, "logits": 0.6, "decode": 0.6, "loss": 0.022,
       "grad": 0.52, "adamw": 2.4e-6}
# measured: logits32 1.27e-5, decode32 1.55e-5, loss32 4.8e-7, aux 3.8e-6,
# grad32 4.9e-6, logits 0.155, decode 0.155, loss 5.5e-3, grad 0.131,
# adamw 6.1e-7
MEASURE = os.environ.get("REPRO_MEASURE_TOL") == "1"


def _f32j(t):
    return jax.tree.map(lambda a: a.astype(jnp.float32)
                        if a.dtype == jnp.bfloat16 else a, t)


def _f32t(t):
    return tree.map(lambda a: a.float() if a.dtype == torch.bfloat16 else a,
                    t)


def _np(x) -> np.ndarray:
    """A JAX array or a tensor as numpy, bfloat16 widened to float32
    (exact)."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        return (x.float() if x.dtype == torch.bfloat16 else x).cpu().numpy()
    x = jnp.asarray(x)
    return np.asarray(x.astype(jnp.float32) if x.dtype == jnp.bfloat16
                      else x)


def jflat(t) -> dict:
    """The reference checkpoint's leaf keys → leaves."""
    return {"/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                     for p in path): x
            for path, x in jax.tree_util.tree_flatten_with_path(t)[0]}


def tflat(t) -> dict:
    """The port checkpoint's leaf keys → leaves (the same keys)."""
    out: dict = {}
    ckpt._map(lambda k, v: out.__setitem__(k, v), t)
    return out


def _rel(got, want) -> float:
    """max |got − want| over max |want| (1 where want is all zeros)."""
    got, want = _np(got), _np(want)
    finite = want > -1e29
    d = np.abs(got - want)[finite].max(initial=0.0)
    return float(d / max(np.abs(want[finite]).max(initial=0.0), 1e-30))


def _relnorm(got, want) -> float:
    """‖got − want‖ over ‖want‖ (Frobenius)."""
    got, want = _np(got), _np(want)
    return float(np.linalg.norm(got - want)
                 / max(np.linalg.norm(want), 1e-30))


def _maxdiff(got, want) -> float:
    got, want = _np(got), _np(want)
    finite = want > -1e29                 # padded-vocab columns: −1e30
    assert np.array_equal(got <= -1e29, ~finite)
    return float(np.abs(got - want)[finite].max(initial=0.0))


def _close(got, want, rtol=0.0, atol=0.0):
    """``np.testing.assert_allclose``; with ``REPRO_MEASURE_TOL=1`` it
    also prints the largest |got − want| at the calling line."""
    if MEASURE:
        import inspect
        g = np.asarray(got, np.float64)
        w = np.asarray(want, np.float64)
        keep = np.isfinite(w) & (w > -1e29)
        line = inspect.stack()[1]
        print(f"CLOSE {line.filename.rsplit('/', 1)[-1]}:{line.lineno} "
              f"{np.abs(g - w)[keep].max(initial=0.0):.3e}")
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


def _check(what, value, bound):
    if MEASURE:
        print(f"MEASURED {what}: {value:.3e} (bound {bound:.1e})")
    assert value <= bound, f"{what}: {value} > {bound}"


def _jdecode(step, params, toks, caches):
    outs = []
    for t in range(toks.shape[1]):
        lg, caches = step(params, toks[:, t:t + 1], caches)
        outs.append(lg)
    return jnp.concatenate(outs, axis=1), caches


def _tdecode(params, cfg, toks, caches):
    outs = []
    with torch.no_grad():
        for t in range(toks.shape[1]):
            lg, caches = transformer.decode_step(params, cfg,
                                                 toks[:, t:t + 1], caches)
            outs.append(lg)
    return torch.cat(outs, dim=1), caches


@dataclasses.dataclass
class Ref:
    arch: str
    jc: object
    tc: object
    jp: dict
    toks: np.ndarray
    labels: np.ndarray
    out: dict


@pytest.fixture(scope="module", params=registry.ARCHS)
def ref(request):
    """One architecture's reference results, computed once: its eager
    ``init`` (what the reference's CLIs call; a jit-compiled init fuses
    the scale into the draw and differs in the last bit), forward and
    decode logits (bfloat16 and float32 parameters), the loss, its
    float32 gradients and one AdamW update from them."""
    arch = request.param
    jc = jcfg.reduced(jregistry.get(arch))
    tc = mcfg.reduced(registry.get(arch))
    jp = jtr.init(jax.random.PRNGKey(0), jc)
    toks = jax.random.randint(jax.random.PRNGKey(1), (B, T), 0, jc.vocab)
    labels = jax.random.randint(jax.random.PRNGKey(2), (B, T), 0, jc.vocab)
    out = {}
    fwd = jax.jit(lambda p, t: jtr.forward(p, jc, tokens=t, remat=False))
    out["logits"], out["aux"] = fwd(jp, toks)
    out["logits32"], _ = fwd(_f32j(jp), toks)
    out["loss"] = jtr._ce_from_logits(out["logits"], labels) + out["aux"]
    dec = jax.jit(lambda p, t, c: jtr.decode_step(p, jc, t, c))
    out["decode"], _ = _jdecode(dec, jp, toks, jtr.init_cache(jc, B, T))
    out["decode32"], caches32 = _jdecode(dec, _f32j(jp), toks,
                                         _f32j(jtr.init_cache(jc, B, T)))
    out["cache_pos"] = [np.asarray(c.pos) for seg in caches32 for c in seg]
    (out["loss32"], out["parts32"]), out["grads32"] = jax.jit(
        jax.value_and_grad(lambda p: jtr.lm_loss(p, jc, toks, labels),
                           has_aux=True))(_f32j(jp))
    out["grads"] = jax.tree.map(lambda g, p: g.astype(p.dtype),
                                out["grads32"], jp)
    out["new_params"], out["new_opt"] = jadamw.update(
        jp, out["grads"], jadamw.init(jp))
    return Ref(arch, jc, tc, jp, np.asarray(toks), np.asarray(labels),
               jax.device_get(out))


def _port_params(r: Ref):
    return transformer.init(tr.PRNGKey(0, "cpu"), r.tc)


def test_init_bit_for_bit(ref):
    """Every leaf: the reference's key, dtype, shape and bits."""
    tp = tflat(_port_params(ref))
    jp = jflat(ref.jp)
    assert list(tp) == list(jp)
    for k, x in jp.items():
        y = tp[k]
        assert str(y.dtype).removeprefix("torch.") == str(x.dtype), k
        assert tuple(y.shape) == x.shape, k
        np.testing.assert_array_equal(_np(y), _np(x), err_msg=k)


def test_forward_logits(ref):
    tp = _port_params(ref)
    toks = torch.from_numpy(ref.toks.copy())
    with torch.no_grad():
        got32, aux32 = transformer.forward(_f32t(tp), ref.tc, tokens=toks,
                                           remat=False)
        got, aux = transformer.forward(tp, ref.tc, tokens=toks, remat=False)
    _check(f"{ref.arch} logits32", _maxdiff(got32, ref.out["logits32"]),
           TOL["logits32"])
    _check(f"{ref.arch} logits", _maxdiff(got, ref.out["logits"]),
           TOL["logits"])
    _check(f"{ref.arch} aux", abs(float(aux) - float(ref.out["aux"])),
           TOL["aux"])


def test_decode_logits(ref):
    """Decode from the cache, token by token, against the reference's
    decode; the caches' positions are the reference's."""
    tp = _port_params(ref)
    toks = torch.from_numpy(ref.toks.copy())
    got32, caches = _tdecode(_f32t(tp), ref.tc, toks, _f32t(
        transformer.init_cache(ref.tc, B, T, device="cpu")))
    _check(f"{ref.arch} decode32", _maxdiff(got32, ref.out["decode32"]),
           TOL["decode32"])
    pos = [_np(c.pos) for seg in caches for c in seg]
    for a, b in zip(pos, ref.out["cache_pos"], strict=True):
        np.testing.assert_array_equal(a, b)
    got, _ = _tdecode(tp, ref.tc, toks,
                      transformer.init_cache(ref.tc, B, T, device="cpu"))
    _check(f"{ref.arch} decode", _maxdiff(got, ref.out["decode"]),
           TOL["decode"])


@pytest.mark.parametrize("arch", ["yi_6b", "deepseek_v3_671b",
                                  "jamba_1_5_large_398b", "xlstm_350m"])
def test_decode_matches_forward(arch):
    """The reference's own contract (``test_transformer.py``), in the
    port: decode reproduces the parallel forward (float32 parameters)."""
    cfg = mcfg.reduced(registry.get(arch))
    tp = _f32t(transformer.init(tr.PRNGKey(0, "cpu"), cfg))
    toks = tr.randint(tr.PRNGKey(1, "cpu"), (2, 10), 0, cfg.vocab)
    dec, _ = _tdecode(tp, cfg, toks, _f32t(
        transformer.init_cache(cfg, 2, 10, device="cpu")))
    with torch.no_grad():
        full, _ = transformer.forward(tp, cfg, tokens=toks, remat=False)
    _close(_np(dec), _np(full), atol=1.4e-5)
    assert float((dec.argmax(-1) == full.argmax(-1)).float().mean()) > 0.9


def test_lm_loss_and_gradients(ref):
    """The loss and every parameter's gradient (the blockwise attention's
    hand-written backward, checkpointed layers) against ``jax.grad`` with
    float32 parameters; with bfloat16 parameters the loss, and gradients
    in the parameters' dtypes near the float32 ones."""
    toks = torch.from_numpy(ref.toks.copy())
    labels = torch.from_numpy(ref.labels.copy())
    want = jflat(ref.out["grads32"])
    loss, parts, grads = steps.value_and_grad(
        lambda p: transformer.lm_loss(p, ref.tc, toks, labels),
        _f32t(_port_params(ref)))
    _check(f"{ref.arch} loss32", abs(float(loss) - float(ref.out["loss32"])),
           TOL["loss32"])
    _check(f"{ref.arch} aux", abs(float(parts["aux"])
                                  - float(ref.out["parts32"]["aux"])),
           TOL["aux"])
    got = tflat(grads)
    assert list(got) == list(want)
    for k, g in got.items():
        assert g.dtype == torch.float32, k
        _check(f"{ref.arch} grad32 {k}", _rel(g, want[k]), TOL["grad32"])

    tp = _port_params(ref)
    loss, _, grads = steps.value_and_grad(
        lambda p: transformer.lm_loss(p, ref.tc, toks, labels), tp)
    _check(f"{ref.arch} loss", abs(float(loss) - float(ref.out["loss"])),
           TOL["loss"])
    for k, g in tflat(grads).items():
        assert g.dtype == tflat(tp)[k].dtype, k
        _check(f"{ref.arch} grad {k}", _relnorm(g, want[k]), TOL["grad"])


def test_adamw_update_given_reference_gradients(ref):
    """One AdamW step from the reference's gradients, in place:
    parameters (their own dtype) and moments."""
    params = convert.lm_params_from_numpy(jax.device_get(ref.jp), "cpu")
    grads = convert.lm_params_from_numpy(ref.out["grads"], "cpu")
    opt = adamw.init(params)
    new_p, new_opt = adamw.update(params, grads, opt)
    assert new_p is params and new_opt.m is opt.m and new_opt.v is opt.v
    want_p, want_opt = jflat(ref.out["new_params"]), ref.out["new_opt"]
    assert int(new_opt.step) == int(want_opt.step) == 1
    for k, p in tflat(new_p).items():
        assert str(p.dtype).removeprefix("torch.") == str(want_p[k].dtype)
        # bf16 parameters: equal, or one bf16 ulp apart
        d = np.abs(_np(p) - _np(want_p[k]))
        ulp = np.abs(_np(want_p[k])) * 2.0 ** -7
        assert np.all(d <= ulp + 1e-30), k
    worst = 0.0
    for mine, theirs in ((new_opt.m, want_opt.m), (new_opt.v, want_opt.v)):
        for k, x in tflat(mine).items():
            worst = max(worst, _rel(x, jflat(theirs)[k]))
    _check(f"{ref.arch} adamw", worst, TOL["adamw"])


def test_param_count_matches_reference(ref):
    assert ref.tc.param_count() == ref.jc.param_count() == sum(
        x.size for x in jax.tree.leaves(ref.jp))


# ---------------------------------------------------------------------------
# Layers and mixers on the same float32 inputs
# ---------------------------------------------------------------------------

def _rand(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale
            ).astype(np.float32)


def _both(a):
    return jnp.asarray(a), torch.from_numpy(np.array(a))


def _cfg(arch, **kw):
    j = jcfg.reduced(jregistry.get(arch))
    t = mcfg.reduced(registry.get(arch))
    return dataclasses.replace(j, **kw), dataclasses.replace(t, **kw)


def _params(jinit, tinit, jc, tc, seed=3):
    """A block's parameters drawn by both packages from one key, as
    float32 (the draws are bit for bit, so the float32 trees are too)."""
    jp = _f32j(jinit(jax.random.PRNGKey(seed), jc))
    tp = _f32t(tinit(tr.PRNGKey(seed, "cpu"), tc))
    for k, v in jflat(jp).items():
        np.testing.assert_array_equal(_np(tflat(tp)[k]), _np(v))
    return jp, tp


def test_layers_match_reference():
    x = _rand(0, 2, 5, 4, 16)
    jx, tx = _both(x)
    scale = _rand(1, 16)
    jsc, tsc = _both(scale)
    _close(
        _np(layers.rmsnorm(tx, tsc, 1e-5)),
        _np(jlayers.rmsnorm(jx, jsc, 1e-5)), atol=9.5e-7)
    pos = np.arange(10, dtype=np.int32).reshape(2, 5) * 37
    jpos, tpos = _both(pos)
    _close(
        _np(layers.apply_rope(tx, tpos, 10000.0)),
        _np(jlayers.apply_rope(jx, jpos, 10000.0)), atol=9.5e-7)
    jp = _f32j(jlayers.mlp_init(jax.random.PRNGKey(2), 16, 24))
    tp = _f32t(layers.mlp_init(tr.PRNGKey(2, "cpu"), 16, 24))
    _close(_np(layers.mlp_apply(tp, tx)),
                               _np(jlayers.mlp_apply(jp, jx)), atol=2.8e-6)


def _naive_attn(q, k, v, causal, window):
    """float64 softmax attention with grouped KV heads."""
    q, k, v = (np.asarray(a, np.float64) for a in (q, k, v))
    B, T, H, D = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    k = np.repeat(k, H // Hkv, axis=2)
    v = np.repeat(v, H // Hkv, axis=2)
    s = np.einsum("bthd,bshd->bhts", q, k) * D ** -0.5
    tpos, spos = np.arange(T)[:, None], np.arange(S)[None, :]
    mask = np.ones((T, S), bool)
    if causal:
        mask &= spos <= tpos
    if window:
        mask &= tpos - spos < window
    s = np.where(mask, s, -np.inf)
    p = np.exp(s - s.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    return np.einsum("bhts,bshd->bthd", p, v)


ATTN_CASES = [  # (T, H, Hkv, window, q_block, kv_block)
    (12, 4, 2, 0, 512, 512), (13, 4, 1, 0, 4, 5), (16, 4, 4, 5, 4, 4),
    (11, 6, 2, 3, 3, 7)]


@pytest.mark.parametrize("case", ATTN_CASES)
def test_blockwise_attention(case):
    """Forward against float64 naive attention and the reference's
    blockwise loop; the hand-written backward against autograd through
    the same loops (``REPRO_NO_FLASH_VJP``'s path) and against the
    reference's custom VJP."""
    T, H, Hkv, window, qb, kb = case
    q, k, v = _rand(0, 2, T, H, 8), _rand(1, 2, T, Hkv, 8), \
        _rand(2, 2, T, Hkv, 8)
    do = _rand(3, 2, T, H, 8)
    kw = dict(causal=True, window=window, q_block=qb, kv_block=kb)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = attention._blockwise_attn(tq, tk, tv, **kw)
    _close(_np(out), _naive_attn(q, k, v, True, window), atol=9.1e-7)
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    jout, jvjp = jax.vjp(lambda a, b, c: jattn._blockwise_attn(a, b, c, **kw),
                         jq, jk, jv)
    _close(_np(out), _np(jout), atol=1.4e-6)
    grads = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(do))
    prev = attention._USE_FLASH_VJP
    attention._USE_FLASH_VJP = False
    try:
        plain = torch.autograd.grad(attention._blockwise_attn(tq, tk, tv, **kw),
                                    (tq, tk, tv), torch.from_numpy(do))
    finally:
        attention._USE_FLASH_VJP = prev
    for g, p, jg in zip(grads, plain, jvjp(jnp.asarray(do))):
        _close(_np(g), _np(p), atol=4.7e-6)
        _close(_np(g), _np(jg), atol=3.0e-6)


def test_quantized_cache_codes_exact():
    """``_quantize`` on the same inputs: the reference's int8 codes (half
    to even) and bfloat16 scales, bit for bit; dequantized within one
    step (half a step, and the scale's bfloat16 rounding times 127)."""
    x = _rand(4, 3, 5, 2, 16, scale=3.0)
    x[0, 0, 0, :4] = [0.5, 1.5, -2.5, 0.0]          # ties at scale 1 …
    x[0, 0, 0, 4] = 127.0                           # … scale = 1 exactly
    for dt_j, dt_t in ((jnp.float32, torch.float32),
                       (jnp.bfloat16, torch.bfloat16)):
        jx = jnp.asarray(x).astype(dt_j)
        tx = torch.from_numpy(x).to(dt_t)
        jq, js = jattn._quantize(jx)
        tq, ts = attention._quantize(tx)
        np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
        np.testing.assert_array_equal(_np(ts), _np(js))
        back = attention._dequantize(tq, ts)
        assert np.all(np.abs(_np(back) - _np(tx)) <= _np(ts)[..., None])


@pytest.mark.parametrize("window,quantized", [(0, False), (0, True),
                                              (4, False), (4, True)])
def test_gqa_decode_slots_and_values(window, quantized):
    """One GQA layer decoding past its cache (a ring buffer when
    windowed, appends clamped at S − 1 otherwise): the cache's slots hold
    the reference's positions and the outputs match the reference's."""
    jc, tc = _cfg("yi_6b")
    jp, tp = _params(jattn.gqa_init, attention.gqa_init, jc, tc)
    S, steps_ = 6, 9
    jcache = _f32j(jattn.gqa_init_cache(jc, 2, S, window, quantized))
    tcache = _f32t(attention.gqa_init_cache(tc, 2, S, window, quantized,
                                            device="cpu"))
    xs = _rand(5, steps_, 2, 1, jc.d_model)
    for t in range(steps_):
        jx, tx = _both(xs[t])
        jy, jcache = jattn.gqa_decode(jp, jx, jcache, jc, window=window)
        with torch.no_grad():
            ty, tcache = attention.gqa_decode(tp, tx, tcache, tc,
                                              window=window)
        slot = attention.decode_slot(tcache.pos - 1, S, window)
        want_slot = (t % S) if window else min(t, S - 1)
        assert slot.tolist() == [want_slot] * 2
        np.testing.assert_array_equal(tcache.pos.numpy(),
                                      np.asarray(jcache.pos))
        _close(_np(ty), _np(jy), atol=2.8e-6)
        for a, b in zip(tcache[:-1], jcache[:-1]):
            if a.dtype == torch.int8:      # codes: at most one step apart
                assert np.abs(_np(a).astype(int) - np.asarray(b)).max() <= 1
            else:
                _close(_np(a), _np(b), atol=9.5e-7)


def test_mla_absorbed_decode_matches_prefill():
    """MLA's absorbed decode against the latent cache reproduces the
    non-absorbed prefill, and the reference's decode."""
    jc, tc = _cfg("deepseek_v3_671b")
    jp, tp = _params(jattn.mla_init, attention.mla_init, jc, tc)
    x = _rand(6, 2, 7, jc.d_model)
    pos = np.broadcast_to(np.arange(7, dtype=np.int32), (2, 7))
    with torch.no_grad():
        full = attention.mla_apply(tp, torch.from_numpy(x),
                                   torch.from_numpy(pos.copy()), tc)
    _close(
        _np(full), _np(jattn.mla_apply(jp, jnp.asarray(x), jnp.asarray(pos),
                                       jc)), atol=4.7e-6)
    tcache = _f32t(attention.mla_init_cache(tc, 2, 7, device="cpu"))
    jcache = _f32j(jattn.mla_init_cache(jc, 2, 7))
    for t in range(7):
        with torch.no_grad():
            y, tcache = attention.mla_decode(tp, torch.from_numpy(
                x[:, t:t + 1].copy()), tcache, tc)
        jy, jcache = jattn.mla_decode(jp, jnp.asarray(x[:, t:t + 1]),
                                      jcache, jc)
        _close(_np(y[:, 0]), _np(full[:, t]), atol=3.8e-6)
        _close(_np(y), _np(jy), atol=4.2e-6)


def test_moe_routing_ids_exact():
    """The router's expert ids (ties to the lower id, as ``lax.top_k``)
    and its weights and aux loss, on the same float32 inputs."""
    jc, tc = _cfg("granite_moe_3b_a800m")
    jp, tp = _params(jmoe.moe_init, moe.moe_init, jc, tc)
    x = _rand(7, 40, jc.d_model)
    x[:8] = 0.0                      # equal logits: every expert ties
    jw, jids, jaux = jmoe._route(jp, jnp.asarray(x), jc)
    tw, tids, taux = moe._route(tp, torch.from_numpy(x), tc)
    np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))
    assert tids[:8].tolist() == [[0, 1]] * 8
    _close(_np(tw), _np(jw), atol=1.0e-6)
    _close(float(taux), float(jaux), atol=0.0)


@pytest.mark.parametrize("impl", ["capacity", "capacity_global", "ragged"])
@pytest.mark.parametrize("arch", ["granite_moe_3b_a800m", "deepseek_v3_671b"])
def test_moe_apply_matches_reference(impl, arch):
    """Each dispatch against the reference's on the same float32 inputs
    (overflow dropped the same way), and the dense oracle where nothing
    is dropped; DeepSeek's shared expert included."""
    jc, tc = _cfg(arch)
    jp, tp = _params(jmoe.moe_init, moe.moe_init, jc, tc)
    x = _rand(8, 2, 16, jc.d_model)
    impl_kw = {} if impl == "ragged" else dict(capacity_factor=1.25)
    jy, jaux = jmoe.moe_apply(jp, jnp.asarray(x), jc, impl=impl, **impl_kw)
    with torch.no_grad():
        ty, taux = moe.moe_apply(tp, torch.from_numpy(x), tc, impl=impl,
                                 **impl_kw)
        dense, _ = moe.moe_apply_dense_ref(tp, torch.from_numpy(x), tc)
    _close(_np(ty), _np(jy), atol=2.3e-6)
    _close(float(taux), float(jaux), atol=3.7e-9)
    jd, _ = jmoe.moe_apply_dense_ref(jp, jnp.asarray(x), jc)
    _close(_np(dense), _np(jd), atol=2.3e-6)
    if impl == "ragged":             # no drops: the dense oracle's sum
        _close(_np(ty), _np(dense), atol=9.5e-7)


@pytest.mark.parametrize("impl", ["capacity", "capacity_global", "ragged"])
def test_moe_gradients_match_reference(impl):
    """Each dispatch's backward (tokens repeated by a view, permuted, and
    gathered back through the inverse order) against ``jax.grad`` of the
    reference's, for the input and every weight, on float32 inputs with
    overflow dropped."""
    jc, tc = _cfg("granite_moe_3b_a800m")
    jp, tp = _params(jmoe.moe_init, moe.moe_init, jc, tc)
    x, r = _rand(10, 2, 16, jc.d_model), _rand(11, 2, 16, jc.d_model)
    kw = {} if impl == "ragged" else dict(capacity_factor=1.25)

    def jloss(p, xx):
        y, aux = jmoe.moe_apply(p, xx, jc, impl=impl, **kw)
        return jnp.sum(y * r) + aux

    jgp, jgx = jax.grad(jloss, argnums=(0, 1))(jp, jnp.asarray(x))
    tp = tree.map(lambda a: a.clone().requires_grad_(True), tp)
    tx = torch.from_numpy(x).requires_grad_(True)
    y, aux = moe.moe_apply(tp, tx, tc, impl=impl, **kw)
    (torch.sum(y * torch.from_numpy(r)) + aux).backward()
    _close(_np(tx.grad), _np(jgx), atol=2.9e-6)
    for k, v in jflat(jgp).items():
        _close(_np(tflat(tp)[k].grad), _np(v), atol=2.9e-5)


def test_mamba_matches_reference():
    """The chunked scan (a chunk shorter than the sequence, so the state
    is carried across chunks) and the one-token decode."""
    jc, tc = _cfg("jamba_1_5_large_398b")
    jp, tp = _params(jmamba.mamba_init, mamba.mamba_init, jc, tc)
    x = _rand(9, 2, 11, jc.d_model, scale=0.5)
    jy = jmamba.mamba_apply(jp, jnp.asarray(x), jc, chunk=4)
    with torch.no_grad():
        ty = mamba.mamba_apply(tp, torch.from_numpy(x), tc, chunk=4)
    _close(_np(ty), _np(jy), atol=6.5e-7)
    tcache = _f32t(mamba.mamba_init_cache(tc, 2, device="cpu"))
    jcache = _f32j(jmamba.mamba_init_cache(jc, 2))
    for t in range(11):
        with torch.no_grad():
            y, tcache = mamba.mamba_decode(tp, torch.from_numpy(
                x[:, t:t + 1].copy()), tcache, tc)
        jd, jcache = jmamba.mamba_decode(jp, jnp.asarray(x[:, t:t + 1]),
                                         jcache, jc)
        _close(_np(y), _np(jd), atol=6.5e-7)
        _close(_np(y[:, 0]), _np(ty[:, t]), atol=1.1e-7)


@pytest.mark.parametrize("impl", ["scan", "chunkwise"])
def test_mlstm_matches_reference(impl):
    jc, tc = _cfg("xlstm_350m")
    jp, tp = _params(jxlstm.mlstm_init, xlstm.mlstm_init, jc, tc)
    x = _rand(10, 2, 13, jc.d_model, scale=0.5)
    jy = jxlstm.mlstm_apply(jp, jnp.asarray(x), jc, chunk=5, impl=impl)
    with torch.no_grad():
        ty = xlstm.mlstm_apply(tp, torch.from_numpy(x), tc, chunk=5,
                               impl=impl)
    _close(_np(ty), _np(jy), atol=3.0e-6)
    tcache = _f32t(xlstm.mlstm_init_cache(tc, 2, device="cpu"))
    jcache = _f32j(jxlstm.mlstm_init_cache(jc, 2))
    for t in range(13):
        with torch.no_grad():
            y, tcache = xlstm.mlstm_decode(tp, torch.from_numpy(
                x[:, t:t + 1].copy()), tcache, tc)
        jd, jcache = jxlstm.mlstm_decode(jp, jnp.asarray(x[:, t:t + 1]),
                                         jcache, jc)
        _close(_np(y), _np(jd), atol=3.3e-6)
        _close(_np(y[:, 0]), _np(ty[:, t]), atol=1.5e-6)


def test_slstm_matches_reference():
    jc, tc = _cfg("xlstm_350m")
    jp, tp = _params(jxlstm.slstm_init, xlstm.slstm_init, jc, tc)
    x = _rand(11, 2, 9, jc.d_model, scale=0.5)
    jy = jxlstm.slstm_apply(jp, jnp.asarray(x), jc, chunk=4)
    with torch.no_grad():
        ty = xlstm.slstm_apply(tp, torch.from_numpy(x), tc, chunk=4)
    _close(_np(ty), _np(jy), atol=6.6e-6)
    tcache = _f32t(xlstm.slstm_init_cache(tc, 2, device="cpu"))
    jcache = _f32j(jxlstm.slstm_init_cache(jc, 2))
    for t in range(9):
        with torch.no_grad():
            y, tcache = xlstm.slstm_decode(tp, torch.from_numpy(
                x[:, t:t + 1].copy()), tcache, tc)
        jd, jcache = jxlstm.slstm_decode(jp, jnp.asarray(x[:, t:t + 1]),
                                         jcache, jc)
        _close(_np(y), _np(jd), atol=6.6e-6)


def test_mtp_loss_remat_and_sharded_ce(monkeypatch):
    """``mtp_loss`` against the reference's; ``remat`` and
    ``REPRO_SHARDED_CE=1`` (no mesh: the fall-through) change nothing."""
    arch = "deepseek_v3_671b"
    jc, tc = _cfg(arch)
    jp = _f32j(jtr.init(jax.random.PRNGKey(0), jc))
    tp = _f32t(transformer.init(tr.PRNGKey(0, "cpu"), tc))
    toks = np.asarray(jax.random.randint(jax.random.PRNGKey(1), (2, 16), 0,
                                         jc.vocab))
    labels = np.roll(toks, -1, axis=1)
    want = jtr.mtp_loss(jp, jc, jnp.asarray(toks), jnp.asarray(labels),
                        depth=1, weight=0.3)
    tt, tl = torch.from_numpy(toks.copy()), torch.from_numpy(labels.copy())
    with torch.no_grad():
        got = transformer.mtp_loss(tp, tc, tt, tl, depth=1, weight=0.3)
        base, _ = transformer.lm_loss(tp, tc, tt, tl)
        monkeypatch.setenv("REPRO_SHARDED_CE", "1")
        sharded, _ = transformer.lm_loss(tp, tc, tt, tl)
    _close(float(got), float(want), atol=9.5e-7)
    assert float(sharded) == float(base)
    monkeypatch.delenv("REPRO_SHARDED_CE")
    g = [steps.value_and_grad(lambda p: (transformer.forward(
        p, tc, tokens=tt, remat=r)[0].square().mean(), {}), tp)[2]
        for r in (True, False)]
    for a, b in zip(tree.leaves(g[0]), tree.leaves(g[1])):
        assert torch.equal(a, b)

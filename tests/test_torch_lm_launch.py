"""The port's LM data path, optimizer, steps and CLIs
(``repro_torch.data.loader``, ``models.stubs``, ``optim``,
``launch.steps`` / ``train`` / ``serve``) against the JAX package on the
CPU.

Exact: the token streams and sampler orders, the checkpoint bytes of a
given tree (bfloat16 leaves included) and the files crossing between the
two packages' ``train.py --save`` / ``--restore``.  Float math within
the stated tolerances, each at most 4x the largest difference measured
(AdamW in float32 agrees exactly): the float32 checks' ``atol``, and the
CLIs' losses and logits at the default bfloat16 parameters
(``TOL_LOSS`` / ``TOL_LOGITS``; the drift of bfloat16 rounding, see
tests/test_torch_models.py)."""
import dataclasses
import re
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import ckpt as jckpt
from repro.configs import registry as jregistry
from repro.data import loader as jloader
from repro.launch import serve as jserve
from repro.launch import steps as jsteps
from repro.launch import train as jtrain
from repro.models import config as jcfg
from repro.models import stubs as jstubs
from repro.models import transformer as jtr
from repro.optim import adamw as jadamw
from repro.optim import schedules as jsched
from repro_torch import convert
from repro_torch import random as tr
from repro_torch import tree
from repro_torch.checkpoint import ckpt
from repro_torch.configs import registry
from repro_torch.data import loader
from repro_torch.launch import serve, steps, train
from repro_torch.models import config as mcfg
from repro_torch.models import stubs, transformer
from repro_torch.optim import adamw, schedules
from test_torch_gpu import one_torch_thread  # noqa: F401
from test_torch_models import _close, _f32j, _f32t, _np, jflat, tflat

TOL_LOSS = 0.019       # train.py's printed losses, bf16 (measured 4.8e-3)
TOL_LOGITS = 0.23      # serve.py's step logits, bf16 (measured 0.058)


@pytest.mark.parametrize("arch", ["yi_6b", "musicgen_large",
                                  "chameleon_34b"])
@pytest.mark.parametrize("reduced", [True, False])
def test_token_batcher_bit_for_bit(arch, reduced):
    """Text, audio and early-fusion VQ streams, several steps."""
    jc, tc = jregistry.get(arch), registry.get(arch)
    if reduced:
        jc, tc = jcfg.reduced(jc), mcfg.reduced(tc)
    jb = jloader.TokenBatcher(jc, 3, 40, seed=5)
    tb = loader.TokenBatcher(tc, 3, 40, seed=5, device="cpu")
    for step in (0, 1, 17):
        want, got = jb(step), tb(step)
        for k in ("tokens", "labels"):
            assert got[k].dtype == torch.int32
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


def test_vq_image_spans_bit_for_bit():
    """``vq_image_tokens``' three-way key split and its span placement,
    at a span shorter than the sequence."""
    jc, tc = jregistry.get("chameleon_34b"), registry.get("chameleon_34b")
    want = jstubs.vq_image_tokens(jax.random.PRNGKey(3), jc, 4, 100,
                                  image_span=16)
    got = stubs.vq_image_tokens(tr.PRNGKey(3, "cpu"), tc, 4, 100,
                                image_span=16)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_federated_sampler_bit_for_bit():
    js = jloader.FederatedSampler(103, 8, seed=11)
    ts = loader.FederatedSampler(103, 8, seed=11, device="cpu")
    for client, rnd_, epoch in ((0, 0, 0), (3, 7, 1), (19, 2, 4)):
        np.testing.assert_array_equal(
            ts.batches(client, rnd_, epoch).numpy(),
            np.asarray(js.batches(client, rnd_, epoch)))


@pytest.mark.parametrize("kind", ["cosine", "linear", "constant"])
def test_schedules_match_reference(kind):
    cfg = dict(peak_lr=3e-4, warmup_steps=10, total_steps=100, kind=kind)
    st = np.arange(0, 120, 7, dtype=np.int32)
    want = jsched.lr_at(jnp.asarray(st), jsched.ScheduleConfig(**cfg))
    got = schedules.lr_at(torch.from_numpy(st),
                          schedules.ScheduleConfig(**cfg))
    _close(got.numpy(), np.asarray(want), atol=2.9e-11)


def _tree(seed):
    rng = np.random.default_rng(seed)
    return {"a": rng.standard_normal((4, 5)).astype(np.float32),
            "b": [rng.standard_normal((3,)).astype(np.float32),
                  (rng.standard_normal((2, 2)).astype(np.float32),)]}


@pytest.mark.parametrize("clip,wd,lr", [(1.0, 0.1, None), (0.0, 0.0, 2e-3),
                                        (1e-3, 0.1, 5e-4)])
def test_adamw_matches_reference(clip, wd, lr):
    """Three AdamW steps on a float32 tree (clipping active and not, the
    schedule's ``lr`` override), in place: the reference's values
    exactly."""
    cfg = dict(lr=1e-2, grad_clip=clip, weight_decay=wd)
    jp, tp = _tree(0), convert.lm_params_from_numpy(_tree(0), "cpu")
    jopt = jadamw.init(jp, jadamw.AdamWConfig(**cfg))
    topt = adamw.init(tp, adamw.AdamWConfig(**cfg))
    for s in range(3):
        g = _tree(10 + s)
        jp, jopt = jadamw.update(jp, g, jopt, jadamw.AdamWConfig(**cfg),
                                 lr=lr)
        tp, topt = adamw.update(tp, convert.lm_params_from_numpy(g, "cpu"),
                                topt, adamw.AdamWConfig(**cfg), lr=lr)
    assert int(topt.step) == int(jopt.step) == 3
    for got, want in ((tp, jp), (topt.m, jopt.m), (topt.v, jopt.v)):
        for a, b in zip(tree.leaves(got), jax.tree.leaves(want)):
            _close(a.numpy(), np.asarray(b), atol=0.0)


def test_steps_match_reference():
    """``ShapeSpec`` / ``needs_window`` and the prefill, serve and train
    steps on a reduced yi-6b (float32 parameters)."""
    assert {k: dataclasses.astuple(v) for k, v in steps.SHAPES.items()} == \
        {k: dataclasses.astuple(v) for k, v in jsteps.SHAPES.items()}
    jc = jcfg.reduced(jregistry.get("yi_6b"))
    tc = mcfg.reduced(registry.get("yi_6b"))
    for name, shape in steps.SHAPES.items():
        assert steps.needs_window(tc, shape) == jsteps.needs_window(
            jc, jsteps.SHAPES[name])
    jp = _f32j(jtr.init(jax.random.PRNGKey(0), jc))
    tp = _f32t(transformer.init(tr.PRNGKey(0, "cpu"), tc))
    batch = jloader.TokenBatcher(jc, 2, 16)(0)
    tbatch = loader.TokenBatcher(tc, 2, 16, device="cpu")(0)
    _close(
        steps.make_prefill_step(tc)(tp, tbatch).numpy(),
        np.asarray(jax.jit(jsteps.make_prefill_step(jc))(jp, batch)), atol=9.0e-6)
    jcache, tcache = _f32j(jtr.init_cache(jc, 2, 4)), _f32t(
        transformer.init_cache(tc, 2, 4, device="cpu"))
    tok = batch["tokens"][:, :1]
    jserve_step = jax.jit(jsteps.make_serve_step(jc))
    for _ in range(3):
        jtok, jcache = jserve_step(jp, tok, jcache)
        ttok, tcache = steps.make_serve_step(tc)(
            tp, torch.from_numpy(np.array(tok)), tcache)
        np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
        tok = jtok
    jnew, jopt, jm = jax.jit(jsteps.make_train_step(jc))(
        jp, jadamw.init(jp), batch)
    tnew, topt, tm = steps.make_train_step(tc)(tp, adamw.init(tp), tbatch)
    for k in ("loss", "ce", "aux"):
        _close(float(tm[k]), float(jm[k]), atol=5.7e-6)
    # AdamW's first step moves each weight by about lr·sign(g): a
    # gradient near 0 amplifies the float32 noise (measured 9.4e-6)
    for a, b in zip(tflat(tnew).values(), jflat(jnew).values()):
        _close(a.numpy(), np.asarray(b), atol=3.7e-5)


_STEP = re.compile(r"step +(\d+) loss=([\d.]+) ce=([\d.]+) aux=([\d.]+)")


def _ref_main(module, argv, monkeypatch, capsys):
    monkeypatch.setattr(sys, "argv", ["prog"] + argv)
    capsys.readouterr()
    module.main()
    return capsys.readouterr().out


def _losses(out):
    return np.array([[float(x) for x in m.groups()[1:]]
                     for m in _STEP.finditer(out)])


@pytest.mark.parametrize("arch", ["yi-6b", "granite-moe-3b-a800m"])
def test_train_cli_matches_reference(arch, monkeypatch, capsys):
    """``train.py --reduced --steps 3``: the same banner and parameter
    count, losses within ``TOL_LOSS`` of the reference's."""
    argv = ["--arch", arch, "--reduced", "--steps", "3", "--seq", "32"]
    want = _ref_main(jtrain, argv, monkeypatch, capsys)
    res = train.main(argv + ["--device", "cpu"])
    got = capsys.readouterr().out
    assert got.splitlines()[:2] == want.splitlines()[:2]
    lw, lg = _losses(want), _losses(got)
    assert lw.shape == lg.shape == (3, 3)
    assert np.abs(lg - lw).max() <= TOL_LOSS, (lg, lw)
    assert np.allclose(lg[:, 0], [m["loss"] for m in res["metrics"]],
                       atol=1e-4)


def test_train_checkpoints_cross_both_ways(tmp_path, monkeypatch, capsys):
    """A reference ``--save`` file (bfloat16 parameters and the AdamW
    state) restores in the port bit for bit, and the port's file restores
    in the reference; both packages write the same bytes for one tree."""
    argv = ["--arch", "yi-6b", "--reduced", "--steps", "2", "--seq", "16"]
    ref_file, port_file = tmp_path / "ref.msgpack", tmp_path / "port.msgpack"
    _ref_main(jtrain, argv + ["--save", str(ref_file)], monkeypatch, capsys)
    res = train.main(argv + ["--device", "cpu", "--restore", str(ref_file),
                             "--steps", "0", "--save", str(port_file)])
    assert "restored from" in capsys.readouterr().out
    assert port_file.read_bytes() == ref_file.read_bytes()
    jc = jcfg.reduced(jregistry.get("yi_6b"))
    like = {"params": jtr.init(jax.random.PRNGKey(0), jc),
            "opt": jadamw.init(jtr.init(jax.random.PRNGKey(0), jc))}
    back = jckpt.restore(port_file, like)
    want = jflat(back)
    got = tflat({"params": res["params"], "opt": res["opt"]})
    assert list(got) == list(want)
    for k, v in want.items():
        assert str(got[k].dtype).removeprefix("torch.") == str(v.dtype), k
        np.testing.assert_array_equal(_np(got[k]), _np(v), err_msg=k)
    assert str(back["opt"].step.dtype) == "int32"
    # the port resumes from its own file: the restored step counts on
    res2 = train.main(argv + ["--device", "cpu", "--restore",
                              str(port_file), "--steps", "1"])
    assert int(res2["opt"].step) == 3


def test_checkpoint_bf16_leaves_round_trip(tmp_path):
    """bfloat16 leaves: written as ``"bfloat16"`` 2-byte words, read back
    bit for bit; the reference writes the same bytes for the same
    tree."""
    words = np.arange(-300, 300, 7, dtype=np.int16).reshape(2, -1)
    t = {"w": torch.from_numpy(words).view(torch.bfloat16),
         "n": torch.arange(3, dtype=torch.int32)}
    ckpt.save(tmp_path / "p.msgpack", t)
    jckpt.save(tmp_path / "j.msgpack",
               {"w": jnp.asarray(words).view(jnp.bfloat16),
                "n": jnp.arange(3, dtype=jnp.int32)})
    assert (tmp_path / "p.msgpack").read_bytes() == \
        (tmp_path / "j.msgpack").read_bytes()
    back = ckpt.restore(tmp_path / "j.msgpack", {
        "w": torch.zeros((2, words.shape[1]), dtype=torch.bfloat16),
        "n": torch.zeros(3, dtype=torch.int32)})
    assert back["w"].dtype == torch.bfloat16
    np.testing.assert_array_equal(back["w"].view(torch.int16).numpy(), words)
    with pytest.raises(ValueError, match="saved bfloat16"):
        ckpt.restore(tmp_path / "j.msgpack", {
            "w": torch.zeros((2, words.shape[1])),
            "n": torch.zeros(3, dtype=torch.int32)})


def _margins_ok(logits: np.ndarray, tol: float) -> np.ndarray:
    """Positions whose top-2 logit margin exceeds ``tol``."""
    top = np.sort(logits, axis=-1)[..., -2:]
    return (top[..., 1] - top[..., 0]) > tol


@pytest.mark.parametrize("quant", [False, True])
def test_serve_cli_matches_reference(quant, monkeypatch, capsys):
    """``serve.py --reduced``: every step's logits within ``TOL_LOGITS``
    of the reference's on the same fed tokens, and the sampled tokens
    equal where the reference's top-2 margin exceeds that tolerance; with
    ``REPRO_QUANT_KV=1`` the int8 cache on both sides."""
    if quant:
        monkeypatch.setenv("REPRO_QUANT_KV", "1")
    argv = ["--arch", "yi-6b", "--reduced", "--prompt-len", "6",
            "--decode-steps", "5", "--batch", "2"]
    res = serve.main(argv + ["--device", "cpu"])
    out = capsys.readouterr().out
    assert "prefill 6 tokens:" in out and "decoded 5 steps" in out
    assert f"sample: {res['generated'][0, :16].tolist()}" in out
    # the reference's decode on the port's fed tokens
    jc = jcfg.reduced(jregistry.get("yi_6b"))
    jp = jtr.init(jax.random.PRNGKey(0), jc)
    caches = jtr.init_cache(jc, 2, 11)
    toks = jnp.asarray(res["tokens"].numpy())
    want = []
    step = jax.jit(lambda p, t, c: jtr.decode_step(p, jc, t, c))
    for t in range(toks.shape[1]):
        lg, caches = step(jp, toks[:, t:t + 1], caches)
        want.append(np.asarray(lg))
    want = np.concatenate(want, axis=1)
    got = res["logits"].numpy()
    finite = want > -1e29
    assert np.abs(got - want)[finite].max() <= TOL_LOGITS
    np.testing.assert_array_equal(
        res["tokens"][:, :6].numpy(),
        np.asarray(jstubs.tokens_for(jc, jax.random.PRNGKey(1), 2, 6)))
    sure = _margins_ok(want, TOL_LOGITS)
    gen = res["generated"].numpy()
    np.testing.assert_array_equal(gen[sure[:, 5:]],
                                  want[:, 5:].argmax(-1)[sure[:, 5:]])
    # the reference's CLI samples the same tokens up to the first one
    # whose margin is within the tolerance (after it, the fed tokens may
    # differ)
    ref_out = _ref_main(jserve, argv, monkeypatch, capsys)
    sample = [int(x) for x in re.search(r"sample: \[(.*)\]",
                                        ref_out).group(1).split(",")]
    n = int(np.argmin(np.append(sure[0, 5:], False)))
    assert sample[:n] == gen[0, :n].tolist()

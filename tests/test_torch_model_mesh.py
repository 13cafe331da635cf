"""The model scaffold on a ``torch.distributed`` mesh
(``repro_torch.launch.model_mesh``): parameters held as their rules'
shards, vocab-parallel logits and cross entropy, expert-parallel MoE,
decode caches held as their ``rules.cache_specs`` blocks
(context-parallel decode).

One 4-rank ``gloo`` world on the CPU runs every job
(``model_mesh.run_steps``): the reduced yi-6b (dense), granite-moe
(``"tp"``), deepseek-v3 (``"ep"``, MLA, a shared expert; one dense and
one MoE layer), jamba (``"ep"``, Mamba) and xlstm-350m (one mLSTM and
one sLSTM layer), with float32 parameters, on a (data 2, model 2) grid,
``REPRO_SHARDED_CE`` / ``REPRO_SHARD_MOE`` off and on, with the MoE
dispatcher the model's layers call (``"capacity"``); a tied-embedding yi
and (pod 2, data 1, model 2) grids (FSDP over a tuple of axes); 1 × 1
grids on rank 0 alone; a bfloat16 granite; decode alone on both grids
for yi's int8 cache (``REPRO_QUANT_KV=1``), yi's window ring (window 4:
it wraps across the blocks) and, on the pod grid, jamba and xlstm.
Every decode runs ``PROMPT + DECODE`` = 6 slots, 3 a block where the
sequence is cut: the higher block holds no valid slot at first, and
the run crosses into it; the JAX decode cases' cache blocks are held
to ``init_cache`` and their first step to one process's.  The other
dispatcher, ``"capacity_global"``,
which no layer calls, is held by ``moe_apply`` itself on both grids,
its output and gradients against the one-process call.  The JAX
reference runs the same train steps, and ``decode_step`` with its
caches placed by its ``rules.cache_specs``, under ``jax.jit`` on a
forced 4-device (2, 2) CPU mesh in two subprocesses started first, so
this module imports no jax (the spawned ranks import it).

Tolerances: the mesh against one process within 1e-5 relative: the
loss, each gradient leaf (max |Δ| over max |reference|), the prefill and
decode logits, the step losses, the parameters after 2 AdamW steps (the
relative norm over the whole tree); the greedy tokens equal.  A leaf of
the parameters is held by its relative norm within ``LEAF_PARAMS`` and
element by element within 2·lr a step: Adam divides the moment by its
own root, so an element whose gradient sits at the summation-order
noise (measured: -3.5e-9 against a leaf's 0.46 on jamba's ``in_proj``)
moves apart by up to 2·lr however well the gradients agree.  A 1 × 1
grid computes the one-process port's bits (an axis of size 1 cuts
nothing).  Against the JAX reference on its mesh: the first step's loss
within ``test_torch_models.py``'s float32 loss bound (``loss32``,
1.9e-6), the second's within ``LOSS32_STEP2``, and the parameters after
the first by leaf within its gradient bound (``grad32``, 1.9e-5, here on
the relative norm, for the reason above); the decode logits and the
gathered caches within its float32 decode bound (``decode32``, 6e-5,
max |Δ|), int8 codes at most one step apart (as
``test_torch_models.py`` holds them), the tokens equal.  The bfloat16
granite within ``test_torch_models.py``'s bfloat16 loss and logits
bounds.
"""
import dataclasses
import gc
import json
import os
import subprocess
import sys
import threading
from functools import lru_cache
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import random as tr
from repro_torch import tree
from repro_torch.checkpoint import ckpt
from repro_torch.configs import registry
from repro_torch.launch import dryrun, steps
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import model_mesh
from repro_torch.models import config as mcfg
from repro_torch.models import moe, transformer
from repro_torch.optim import adamw
from repro_torch.sharding import mesh_ops, rules
from test_torch_gpu import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ("yi_6b", "granite_moe_3b_a800m", "deepseek_v3_671b",
         "jamba_1_5_large_398b", "xlstm_350m")
B, T, PROMPT, DECODE, STEPS = 4, 8, 2, 4, 2
GRID = (("data", "model"), (2, 2))
POD = (("pod", "data", "model"), (2, 1, 2))
ONE = (("data", "model"), (1, 1))
KNOBS = {0: {"REPRO_SHARDED_CE": None, "REPRO_SHARD_MOE": None},
         1: {"REPRO_SHARDED_CE": "1", "REPRO_SHARD_MOE": "1"}}
REL = 1e-5
MEASURE = os.environ.get("REPRO_MEASURE_TOL") == "1"
LOSS32, GRAD32 = 1.9e-6, 1.9e-5          # test_torch_models.TOL
DECODE32 = 6e-5                          # test_torch_models.TOL
# measured, bounds at 4x: jamba's conv_b after 2 steps (1.47e-5, Adam's
# normalized step on gradients at the noise, see above); the JAX
# reference's second step loss, at parameters one Adam step has moved
# apart (jamba 3.34e-6; every first step within LOSS32)
LEAF_PARAMS, LOSS32_STEP2 = 6e-5, 1.4e-5
BF16 = {"logits": 0.6, "loss": 0.022}    # test_torch_models.TOL


def _cfg(arch: str, tied: bool = False) -> mcfg.ModelConfig:
    """The reduced config; deepseek-v3 keeps its first dense and its first
    MoE layer (its first three are dense), xlstm-350m an mLSTM and its
    sLSTM layer (its first two are mLSTM)."""
    cfg = mcfg.reduced(registry.get(arch))
    if arch == "deepseek_v3_671b":
        cfg = dataclasses.replace(cfg, segments=((1, (
            mcfg.LayerSpec("attn", "dense"), mcfg.LayerSpec("attn", "moe"))),))
    if arch == "xlstm_350m":
        cfg = dataclasses.replace(cfg, segments=((1, (
            mcfg.LayerSpec("mlstm", "none"),
            mcfg.LayerSpec("slstm", "none"))),))
    return dataclasses.replace(cfg, tie_embeddings=True) if tied else cfg


@dataclasses.dataclass(frozen=True)
class Case:
    name: str
    arch: str
    knobs: int = 0
    mesh: tuple = GRID
    f32: bool = True
    tied: bool = False
    decode_only: bool = False
    quant: bool = False          # REPRO_QUANT_KV=1: the int8 KV cache
    window: int = 0


INT8 = {"REPRO_QUANT_KV": "1"}


def _cases() -> list[Case]:
    out = []
    for arch in ARCHS:
        for knobs in (0, 1):
            out.append(Case(f"{arch}-{knobs}", arch, knobs))
    out += [Case("yi_6b-tied", "yi_6b", 1, tied=True),
            Case("yi_6b-pod", "yi_6b", 1, mesh=POD),
            Case("deepseek-pod", "deepseek_v3_671b", 1, mesh=POD),
            Case("yi_6b-1x1", "yi_6b", 1, mesh=ONE),
            Case("deepseek-1x1", "deepseek_v3_671b", 1, mesh=ONE),
            Case("granite-bf16", "granite_moe_3b_a800m", 0, f32=False)]
    for grid, suffix in ((GRID, ""), (POD, "-pod")):
        out += [Case(f"yi_6b-int8{suffix}", "yi_6b", mesh=grid,
                     decode_only=True, quant=True),
                Case(f"yi_6b-window{suffix}", "yi_6b", mesh=grid,
                     decode_only=True, window=4)]
    out += [Case("jamba-pod", "jamba_1_5_large_398b", 1, mesh=POD,
                 decode_only=True),
            Case("xlstm-pod", "xlstm_350m", 1, mesh=POD, decode_only=True)]
    return out


def _env(case: Case) -> dict:
    return {**KNOBS[case.knobs], "REPRO_QUANT_KV": "1" if case.quant
            else None}


CASES = _cases()
BY_NAME = {c.name: c for c in CASES}


def _f32(t):
    return tree.map(lambda a: a.float() if a.is_floating_point() else a, t)


def _batch(cfg):
    rng = np.random.default_rng(0)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (B, T))
                            .astype(np.int32))
    return toks, torch.roll(toks, -1, 1)


def _inputs(case: Case):
    cfg = _cfg(case.arch, case.tied)
    params = transformer.init(tr.PRNGKey(0, "cpu"), cfg)
    toks, labels = _batch(cfg)
    return cfg, (_f32(params) if case.f32 else params), toks, labels


def _job(case: Case) -> dict:
    cfg, params, toks, labels = _inputs(case)
    job = dict(mesh=case.mesh, cfg=cfg, params=params,
               dtype=torch.float32 if case.f32 else None, env=_env(case),
               decode={"prompt": toks[:, :PROMPT], "steps": DECODE,
                       "window": case.window, "gather_caches": True})
    if not case.decode_only:
        job.update(grads={"tokens": toks, "labels": labels}, prefill=toks,
                   train={"tokens": toks, "labels": labels, "steps": STEPS},
                   gather_params=True)
    return job


# ---------------------------------------------------------------------------
# Gradient checks of the collectives' autograd Functions, on the grid
# ---------------------------------------------------------------------------

def _grad_checks(mesh) -> dict:
    """The vocab-parallel CE and the expert-parallel combine against
    autograd of their whole-row forms, float64: each rank's gradient
    blocks gathered back whole."""
    g = torch.Generator().manual_seed(3)
    V, M = 12, mesh.shape["model"]
    width, mi = V // M, mesh.coords["model"]
    logits = torch.randn(B, T, V, generator=g, dtype=torch.float64)
    labels = torch.randint(0, V, (B, T), generator=g)
    r = torch.rand(B, T, generator=g, dtype=torch.float64)
    nb, bi = mesh.block(("data",))
    rows = slice(bi * B // nb, (bi + 1) * B // nb)
    out = {}
    with mesh_ops.use_mesh(mesh):
        blk = logits[rows, :, mi * width:(mi + 1) * width].clone() \
            .requires_grad_()
        ce = mesh_ops.vocab_ce(blk, labels[rows], mi * width)
        loss = mesh_ops.reduce_sum((ce * r[rows]).sum(), ("data",), "t")
        loss.backward()
        out["ce"] = mesh_ops.gather_plain(ce.detach(), 0, ("data",), "t")
        d = mesh_ops.gather_plain(blk.grad, 2, ("model",), "t")
        out["ce_grad"] = mesh_ops.gather_plain(d, 0, ("data",), "t")
        out["ce_loss"] = loss.detach()
        # experts: x replicated over model, one bank block a rank
        E, d_in, d_out = 4, 5, 3
        x = torch.randn(B, d_in, generator=g, dtype=torch.float64)
        w = torch.randn(E, d_in, d_out, generator=g, dtype=torch.float64)
        rr = torch.randn(B, E, d_out, generator=g, dtype=torch.float64)
        per = E // M
        xl = x[rows].clone().requires_grad_()
        wl = w[mi * per:(mi + 1) * per].clone().requires_grad_()
        ys = torch.einsum("bd,edf->bef",
                          mesh_ops.copy_in(xl, ("model",), "t"), wl)
        full = mesh_ops.gather_out(ys, 1, ("model",), "t")
        loss = mesh_ops.reduce_sum((torch.tanh(full) * rr[rows]).sum(),
                                     ("data",), "t")
        loss.backward()
        out["ep_out"] = mesh_ops.gather_plain(full.detach(), 0, ("data",),
                                                "t")
        out["ep_dx"] = mesh_ops.gather_plain(xl.grad, 0, ("data",), "t")
        gw = mesh_ops.reduce_plain(wl.grad, ("data",), "t")
        out["ep_dw"] = mesh_ops.gather_plain(gw, 0, ("model",), "t")
    out["inputs"] = dict(logits=logits, labels=labels, r=r, x=x, w=w, rr=rr)
    return out


MOE_ARCHS = ARCHS[1:4]
BANKS = ("gate", "up", "down")


def _moe_inputs(arch: str):
    """One MoE layer of the reduced config, float32 (the router computes
    in float32): its parameters, a (B, T, d) input and the weights of the
    test loss ``Σ y·r + aux``."""
    cfg = _cfg(arch)
    p = _f32(moe.moe_init(tr.PRNGKey(5, "cpu"), cfg))
    g = torch.Generator().manual_seed(7)
    x = torch.randn(B, T, cfg.d_model, generator=g)
    r = torch.randn(B, T, cfg.d_model, generator=g)
    return cfg, p, x, r


def _global_dispatch(mesh) -> dict:
    """``moe_apply(impl="capacity_global")`` called on ``mesh``, each rank
    its batch block and, where ``_constrain_ep`` applies, its experts'
    banks: the output, the aux loss and the gradients of ``Σ y·r + aux``,
    gathered whole."""
    out = {}
    spec = rules.batch_spec(mesh, B)
    for arch in MOE_ARCHS:
        cfg, p, x, r = _moe_inputs(arch)
        for knobs in (0, 1):
            with model_mesh._environ(KNOBS[knobs]), \
                    mesh_ops.use_mesh(mesh, spec[0]):
                axes = mesh_ops.batch_axes()
                ep = moe._constrain_ep(cfg)
                mine = tree.map(lambda a: a.clone().requires_grad_(), p)
                if ep:
                    per = cfg.moe.n_experts // ep[0]
                    for k in BANKS:
                        mine[k] = p[k][ep[1] * per:(ep[1] + 1) * per] \
                            .clone().requires_grad_()
                xl = mesh_ops.cut_tree(x, spec, mesh).requires_grad_()
                y, aux = moe.moe_apply(mine, xl, cfg, impl="capacity_global")
                loss = mesh_ops.reduce_sum(
                    (y * mesh_ops.cut_tree(r, spec, mesh)).sum(), axes,
                    "t") + aux
                loss.backward()
                grads = tree.map(
                    lambda a: mesh_ops.reduce_plain(a.grad, axes, "t"), mine)
                if ep:
                    for k in BANKS:
                        grads[k] = mesh_ops.gather_plain(grads[k], 0,
                                                         ("model",), "t")
                out[f"{arch}-{knobs}"] = dict(
                    y=mesh_ops.gather_plain(y.detach(), 0, axes, "t"),
                    aux=aux.detach(), grads=grads, ep=ep is not None,
                    dx=mesh_ops.gather_plain(xl.grad, 0, axes, "t"))
    return out


def _cyclic_garbage(mesh) -> dict:
    """The objects only a reference cycle keeps alive after a layer's
    leaves are gathered and dropped (with and without a gradient) and
    after decode steps of the reduced yi-6b on caches cut over
    ``model``, counted by the garbage collector (off meanwhile): a
    cycle holding a gathered buffer keeps it on the device until the
    collector happens to run."""
    out = {}
    w = torch.randn(8, 8, generator=torch.Generator().manual_seed(1))
    specs = {"w": ("data", "model"), "b": ("model",)}
    shards = mesh_ops.cut_tree({"w": w, "b": w[0]}, specs, mesh)
    cfg = _cfg("yi_6b")
    params = model_mesh.shard_params(
        transformer.init(tr.PRNGKey(0, "cpu"), cfg), mesh)
    caches, cspecs = steps.cache_blocks(cfg, mesh, B, PROMPT + DECODE)
    tok = torch.zeros(B, 1, dtype=torch.int32)
    for grad in (False, True):
        with mesh_ops.use_mesh(mesh), torch.set_grad_enabled(grad):
            gc.collect()
            gc.disable()
            try:
                for _ in range(3):
                    mesh_ops.gathered(shards, specs, lambda p, leaf: False)
                out[f"gather grad={grad}"] = gc.collect()
            finally:
                gc.enable()
    step = steps.make_serve_step(cfg, mesh=mesh, cache_specs=cspecs)
    gc.collect()
    gc.disable()
    try:
        for _ in range(3):
            _, caches = step(params, tok, caches)
        out["decode"] = gc.collect()
    finally:
        gc.enable()
    return out


def _first_step(mesh) -> dict:
    """For each case of ``JAX_DECODE`` on the (2, 2) grid: this rank's
    cache blocks as ``steps.cache_blocks`` makes them, gathered whole
    before any step, and, after one decode step of the prompt's first
    token in float32, the caches gathered whole and the logits."""
    out = {}
    for name in JAX_DECODE:
        case = BY_NAME[name]
        cfg, params, toks, _ = _inputs(case)
        with model_mesh._environ(_env(case)), torch.no_grad():
            caches, specs = steps.cache_blocks(cfg, mesh, B, PROMPT + DECODE,
                                               case.window)
            init = mesh_ops.gather_tree(caches, specs, mesh, "result")
            lg, _, caches = steps.serve_logits(
                cfg, model_mesh.shard_params(params, mesh,
                                             cfg.moe.sharding if cfg.moe
                                             else "ep"),
                toks[:, :1], _f32(caches), case.window, mesh, specs)
            out[name] = dict(
                init=init,
                caches=mesh_ops.gather_tree(caches, specs, mesh, "result"),
                logits=model_mesh._whole_logits(mesh, cfg, lg[:, 0], B))
    return out


def _rank(world, jobs):
    """Rank worker: every job, then the gradient checks on a (2, 2)
    grid, the first decode step of the JAX decode cases on it, the
    cyclic garbage of a gather and a decode step on it, and the
    global-capacity dispatch on it and on the pod grid."""
    results = model_mesh.run_steps(world, jobs)
    grid = model_mesh.make_model_mesh(*GRID, world.device)
    checks = _grad_checks(grid)
    checks["first"] = _first_step(grid)
    checks["cycles"] = _cyclic_garbage(grid)
    checks["global"] = {"grid": _global_dispatch(grid)}
    pod = model_mesh.make_model_mesh(*POD, world.device)
    checks["global"]["pod"] = _global_dispatch(pod)
    return (results, checks) if world.rank == 0 else None


# ---------------------------------------------------------------------------
# The JAX reference on a forced (2, 2) mesh
# ---------------------------------------------------------------------------

JAX_CODE = """
import dataclasses, json, os, sys
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from repro.configs import registry
from repro.launch import steps
from repro.models import config as mcfg
from repro.models import transformer
from repro.optim import adamw
from repro.sharding import compat, rules

B, T, STEPS, PROMPT, DECODE = {B}, {T}, {STEPS}, {PROMPT}, {DECODE}
mesh = Mesh(np.asarray(jax.devices()[:4]).reshape(2, 2), ("data", "model"))
out, meta = {{}}, {{}}
work = json.loads(sys.argv[2])


def config(arch):
    cfg = mcfg.reduced(registry.get(arch))
    if arch == "deepseek_v3_671b":
        cfg = dataclasses.replace(cfg, segments=((1, (
            mcfg.LayerSpec("attn", "dense"), mcfg.LayerSpec("attn", "moe"))),))
    if arch == "xlstm_350m":
        cfg = dataclasses.replace(cfg, segments=((1, (
            mcfg.LayerSpec("mlstm", "none"),
            mcfg.LayerSpec("slstm", "none"))),))
    return cfg


def f32(tree):
    return jax.tree.map(lambda a: a.astype(jnp.float32)
                        if jnp.issubdtype(a.dtype, jnp.floating) else a, tree)


def key(path):
    return "/".join(f".{{q.name}}" if hasattr(q, "name")
                    else str(getattr(q, "key", getattr(q, "idx", q)))
                    for q in path)


def knobs_env(knobs, quant=0):
    for k in ("REPRO_SHARDED_CE", "REPRO_SHARD_MOE", "REPRO_QUANT_KV"):
        os.environ.pop(k, None)
    for k in ("REPRO_SHARDED_CE", "REPRO_SHARD_MOE")[:2 * knobs]:
        os.environ[k] = "1"
    if quant:
        os.environ["REPRO_QUANT_KV"] = "1"


def placed_params(cfg):
    p = f32(transformer.init(jax.random.PRNGKey(0), cfg))
    return jax.device_put(p, rules.shardings(
        p, mesh, cfg.moe.sharding if cfg.moe else "ep"))


for arch in work["train"]:
    cfg = config(arch)
    toks = np.random.default_rng(0).integers(0, cfg.vocab, (B, T))
    toks = toks.astype(np.int32)
    bs = NamedSharding(mesh, P(*rules.batch_spec(mesh, B)))
    batch = {{"tokens": jax.device_put(toks, bs),
              "labels": jax.device_put(np.roll(toks, -1, 1), bs)}}
    for knobs in (0, 1):
        knobs_env(knobs)
        p = placed_params(cfg)
        opt = adamw.init(p)
        losses, first = [], None
        with compat.set_mesh(mesh):
            step = jax.jit(steps.make_train_step(cfg))
            for _ in range(STEPS):
                p, opt, m = step(p, opt, batch)
                losses.append(float(m["loss"]))
                first = p if first is None else first
        meta[f"{{arch}}-{{knobs}}"] = losses
        for path, x in jax.tree_util.tree_flatten_with_path(first)[0]:
            out[f"{{arch}}-{{knobs}}|{{key(path)}}"] = np.asarray(x)

# decode_step on caches placed by cache_specs: the prompt fed a token a
# step, then greedy steps
for name, arch, knobs, quant, window in work["decode"]:
    knobs_env(knobs, quant)
    cfg = config(arch)
    toks = np.random.default_rng(0).integers(0, cfg.vocab, (B, T))
    toks = toks.astype(np.int32)
    p = placed_params(cfg)
    c = f32(transformer.init_cache(cfg, B, PROMPT + DECODE, window))
    c = jax.tree.map(lambda a, sp: jax.device_put(a, NamedSharding(mesh, sp)),
                     c, rules.cache_specs(c, mesh))
    meta[f"dec|{{name}}"] = [x.sharding.shard_shape(x.shape)
                             for x in jax.tree.leaves(c)]
    bs = NamedSharding(mesh, P(*rules.batch_spec(mesh, B)))
    fed, logits, tokens = toks[:, :1], [], []
    with compat.set_mesh(mesh):
        step = jax.jit(lambda p, t, c: transformer.decode_step(
            p, cfg, t, c, window=window))
        for t in range(PROMPT + DECODE):
            lg, c = step(p, jax.device_put(fed, bs), c)
            logits.append(np.asarray(lg[:, 0]))
            if t + 1 < PROMPT:
                fed = toks[:, t + 1:t + 2]
            else:
                fed = np.asarray(jnp.argmax(lg, -1).astype(jnp.int32))
                tokens.append(fed)
    out[f"dec|{{name}}|logits"] = np.stack(logits, 1)
    out[f"dec|{{name}}|tokens"] = np.concatenate(tokens, 1)
    for path, x in jax.tree_util.tree_flatten_with_path(c)[0]:
        out[f"dec|{{name}}|cache|{{key(path)}}"] = np.asarray(x)
np.savez(sys.argv[1], **out)
print("JAX_META " + json.dumps(meta))
"""

# the decode cases held against the reference on its (2, 2) mesh
JAX_DECODE = ("yi_6b-0", "yi_6b-int8", "yi_6b-window",
              "deepseek_v3_671b-0", "jamba_1_5_large_398b-0", "xlstm_350m-0")


@pytest.fixture(scope="module")
def jax_side(tmp_path_factory):
    """The reference's train steps and decode on its own (2, 2) mesh, in
    two subprocesses started first so they run beside the torch
    world."""
    d = tmp_path_factory.mktemp("jax_mesh")
    code = JAX_CODE.format(B=B, T=T, STEPS=STEPS, PROMPT=PROMPT,
                           DECODE=DECODE)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=str(ROOT / "src"), TMPDIR=str(d))
    for k in _env(Case("", "", 1, quant=True)):
        env.pop(k, None)
    decode = [[n, BY_NAME[n].arch, BY_NAME[n].knobs, int(BY_NAME[n].quant),
               BY_NAME[n].window] for n in JAX_DECODE]
    # two processes: the compiles dominate
    work = ({"train": ARCHS[0::2], "decode": []},
            {"train": ARCHS[1::2], "decode": decode})
    procs = [subprocess.Popen(
        [sys.executable, "-c", code, str(d / f"out{i}.npz"), json.dumps(w)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for i, w in enumerate(work)]

    def result():
        out, meta = {}, {}
        for i, proc in enumerate(procs):
            o, err = proc.communicate(timeout=900)
            assert proc.returncode == 0, err[-3000:]
            meta.update(json.loads(next(x for x in o.splitlines()
                                        if x.startswith("JAX_META "))[9:]))
            out.update(np.load(d / f"out{i}.npz"))
        return out, meta

    yield lru_cache(maxsize=1)(result)
    for proc in procs:
        if proc.poll() is None:
            proc.kill()


@pytest.fixture(scope="module")
def world(jax_side):
    """Every job's results on the 4-rank world, and the gradient checks;
    the one-process runs are computed here meanwhile."""
    box: dict = {}

    def run():
        try:
            box["out"] = mesh_lib.spawn(_rank, 4, [_job(c) for c in CASES],
                                        device="cpu")
        except BaseException as e:  # noqa: BLE001 - re-raised below
            box["err"] = e

    th = threading.Thread(target=run)
    th.start()
    for c in CASES:
        _one_process(c.name)
    th.join()
    if "err" in box:
        raise box["err"]
    results, checks = box["out"]
    return dict(zip((c.name for c in CASES), results)), checks


# ---------------------------------------------------------------------------
# The one-process port on the same inputs
# ---------------------------------------------------------------------------

@lru_cache(maxsize=None)
def _one_process(name: str) -> dict:
    case = BY_NAME[name]
    cfg, params, toks, labels = _inputs(case)
    out = {}
    with model_mesh._environ(_env(case)):
        caches = transformer.init_cache(cfg, B, PROMPT + DECODE,
                                        case.window, device="cpu")
        if case.f32:
            caches = _f32(caches)
        fed, logits, tokens = toks[:, :1], [], []
        for t in range(PROMPT + DECODE):
            with torch.no_grad():
                lg, nxt, caches = steps.serve_logits(cfg, params, fed, caches,
                                                     case.window)
            logits.append(lg[:, 0])
            if t + 1 < PROMPT:
                fed = toks[:, t + 1:t + 2]
            else:
                fed = nxt.to(toks.dtype)
                tokens.append(nxt)
        out["decode_logits"] = torch.stack(logits, 1)
        out["tokens"] = torch.cat(tokens, 1)
        out["caches"] = caches
        if case.decode_only:
            return out
        loss, _, grads = steps.value_and_grad(
            lambda p: transformer.lm_loss(p, cfg, toks, labels), params)
        out["grad_loss"], out["grads"] = float(loss), grads
        out["prefill"] = steps.make_prefill_step(cfg)(params,
                                                      {"tokens": toks})
        p, opt = tree.map(torch.clone, params), adamw.init(params)
        step = steps.make_train_step(cfg)
        out["metrics"], out["params"] = [], []
        for _ in range(STEPS):
            p, opt, m = step(p, opt, {"tokens": toks, "labels": labels})
            out["metrics"].append({k: float(v) for k, v in m.items()})
            out["params"].append(tree.map(torch.clone, p))
    return out


def _flat(t) -> dict:
    out: dict = {}
    ckpt._map(lambda k, v: out.__setitem__(k, v), t)
    return out


def _rel(got, want) -> float:
    """max |got − want| over max |want| (the finite logits)."""
    got, want = got.double(), want.double()
    keep = want > -1e29
    assert torch.equal(got > -1e29, keep)
    d = (got - want).abs()[keep].max() if bool(keep.any()) else 0.0
    return float(d / want.abs()[keep].max().clamp_min(1e-30))


def _absdiff(got, want) -> float:
    """max |got − want| (the finite logits)."""
    got, want = got.double(), want.double()
    keep = want > -1e29
    assert torch.equal(got > -1e29, keep)
    return float((got - want).abs()[keep].max()) if bool(keep.any()) \
        else 0.0


def _relnorm(got, want) -> float:
    got, want = got.double(), want.double()
    return float((got - want).norm() / want.norm().clamp_min(1e-30))


def _check(what, value, bound):
    if MEASURE:
        print(f"MEASURED {what}: {value:.3e} (bound {bound:.1e})")
    assert value <= bound, f"{what}: {value} > {bound}"


def _adam_moves(case: Case) -> float:
    return 2 * adamw.AdamWConfig().lr * STEPS


MESH_CASES = [c.name for c in CASES
              if c.mesh != ONE and c.f32 and not c.decode_only]
DECODE_CASES = [c.name for c in CASES if c.decode_only]


@pytest.mark.parametrize("name", MESH_CASES)
def test_mesh_equals_one_process(world, name):
    """Loss, gradients, prefill and decode logits, greedy tokens, the two
    steps' metrics and the parameters after them: the mesh against the
    one-process port on the same inputs."""
    got, want = world[0][name], _one_process(name)
    _check(f"{name} loss", abs(got["grad_loss"] - want["grad_loss"])
           / abs(want["grad_loss"]), REL)
    gg, gw = _flat(got["grads"]), _flat(want["grads"])
    assert list(gg) == list(gw)
    for k in gw:
        assert gg[k].shape == gw[k].shape, k
        _check(f"{name} grad {k}", _rel(gg[k], gw[k]), REL)
    for a, b in zip(got["metrics"], want["metrics"], strict=True):
        for k in b:
            _check(f"{name} step {k}", abs(a[k] - b[k])
                   / max(abs(b[k]), 1e-3), REL)
    pg, pw = _flat(got["params"][-1]), _flat(want["params"][-1])
    _check(f"{name} params", _relnorm(
        torch.cat([pg[k].reshape(-1) for k in pw]),
        torch.cat([pw[k].reshape(-1) for k in pw])), REL)
    for k in pw:
        _check(f"{name} params {k}", _relnorm(pg[k], pw[k]), LEAF_PARAMS)
        _check(f"{name} params max {k}",
               float((pg[k] - pw[k]).abs().max()), _adam_moves(
                   BY_NAME[name]))
    _check(f"{name} prefill", _rel(got["prefill"], want["prefill"]), REL)
    _check(f"{name} decode", _rel(got["decode_logits"],
                                  want["decode_logits"]), REL)
    assert torch.equal(got["tokens"].long(), want["tokens"].long())


def _caches_close(what, got, want, bound, measure) -> None:
    """Two cache trees, leaf by leaf by key: int8 codes at most one step
    apart, ``pos`` equal, the float leaves within ``bound`` by
    ``measure``."""
    assert list(got) == list(want), what
    for k, w in want.items():
        g = got[k]
        assert tuple(g.shape) == tuple(w.shape), (what, k)
        if k.endswith(".pos"):
            assert torch.equal(g, w), (what, k)
        elif w.dtype == torch.int8:
            assert int((g.int() - w.int()).abs().max()) <= 1, (what, k)
        else:
            _check(f"{what} {k}", measure(g, w), bound)


@pytest.mark.parametrize("name", DECODE_CASES)
def test_context_parallel_decode_equals_one_process(world, name):
    """Decode on caches held as their ``rules.cache_specs`` blocks (the
    int8 cache and the window ring on both grids; jamba's Mamba and
    xlstm's mLSTM and sLSTM state on the pod grid): the logits within
    1e-5 relative of the one-process port's on the whole caches, the
    greedy tokens equal, and the last caches, gathered whole, within
    1e-5 relative (int8 codes one step apart)."""
    got, want = world[0][name], _one_process(name)
    _check(f"{name} decode", _rel(got["decode_logits"],
                                  want["decode_logits"]), REL)
    assert torch.equal(got["tokens"].long(), want["tokens"].long())
    _caches_close(name, _flat(got["caches"]), _flat(want["caches"]), REL,
                  _rel)


@pytest.mark.parametrize("name", JAX_DECODE)
def test_cache_blocks_and_first_step_equal_one_process(world, name):
    """``steps.cache_blocks`` on the (2, 2) grid, gathered whole, is
    ``transformer.init_cache`` bit for bit, every leaf and dtype (the
    xLSTM stabilizers ``m`` too: the stacked init is zeros); after one
    decode step the caches gathered whole, ``m`` included, are within
    1e-5 relative of the one-process port's (int8 codes one step
    apart), and so are the logits."""
    got = world[1]["first"][name]
    case = BY_NAME[name]
    cfg, params, toks, _ = _inputs(case)
    with model_mesh._environ(_env(case)), torch.no_grad():
        init = transformer.init_cache(cfg, B, PROMPT + DECODE, case.window,
                                      device="cpu")
        gi, wi = _flat(got["init"]), _flat(init)
        assert list(gi) == list(wi)
        for k, w in wi.items():
            assert gi[k].dtype == w.dtype and torch.equal(gi[k], w), k
        lg, _, caches = steps.serve_logits(cfg, params, toks[:, :1],
                                           _f32(init), case.window)
    _check(f"{name} first step", _rel(got["logits"], lg[:, 0]), REL)
    _caches_close(f"{name} first step", _flat(got["caches"]),
                  _flat(caches), REL, _rel)


@pytest.mark.parametrize("name", JAX_DECODE)
def test_decode_equals_the_jax_reference_on_a_mesh(world, jax_side, name):
    """The port's context-parallel decode on the (2, 2) grid against the
    reference's ``jax.jit(decode_step)`` on a forced (2, 2) CPU mesh,
    its caches placed by its ``rules.cache_specs`` (yi-6b's full, int8
    and windowed KV cache, deepseek-v3's MLA latents, jamba's Mamba and
    xlstm-350m's mLSTM and sLSTM state): each rank's block the shard
    shape of the reference's placed caches; every step's logits and the
    last caches
    within ``decode32`` (max |Δ|), int8 codes one step apart; the greedy
    tokens equal."""
    jout, meta = jax_side()
    got = world[0][name]
    pre = f"dec|{name}|"
    _check(f"jax {name} decode", _absdiff(
        got["decode_logits"], torch.from_numpy(jout[pre + "logits"])),
        DECODE32)
    assert torch.equal(got["tokens"].long(),
                       torch.from_numpy(jout[pre + "tokens"]).long())
    want = {k[len(pre) + 6:]: torch.from_numpy(v) for k, v in jout.items()
            if k.startswith(pre + "cache|")}
    _caches_close(f"jax {name}", _flat(got["caches"]), want, DECODE32,
                  _absdiff)
    for r in got["ranks"]:
        assert r["cache_shapes"] == [tuple(x) for x in meta[f"dec|{name}"]]


@pytest.mark.parametrize("name", ["yi_6b-1x1", "deepseek-1x1"])
def test_one_by_one_grid_is_the_one_process_port(world, name):
    """On a 1 × 1 grid (rank 0 alone) every result is the one-process
    port's, bit for bit."""
    got, want = world[0][name], _one_process(name)
    assert got["grad_loss"] == want["grad_loss"]
    assert got["metrics"] == want["metrics"]
    for key in ("grads", "params"):
        for a, b in zip(tree.leaves(got[key]), tree.leaves(want[key]),
                        strict=True):
            assert torch.equal(a, b), key
    for key in ("prefill", "decode_logits", "tokens"):
        assert torch.equal(got[key], want[key]), key


def test_bf16_mesh_within_the_bf16_bounds(world):
    """bfloat16 parameters: the mesh's loss and logits against one
    process within ``test_torch_models.py``'s bfloat16 bounds (the
    gradients are reduced in bfloat16 over ``data``), tokens where the
    logits' top-2 margin exceeds the bound."""
    got, want = world[0]["granite-bf16"], _one_process("granite-bf16")
    assert abs(got["grad_loss"] - want["grad_loss"]) <= BF16["loss"]
    for a, b in zip(got["metrics"], want["metrics"], strict=True):
        assert abs(a["loss"] - b["loss"]) <= BF16["loss"]
    for key in ("prefill", "decode_logits"):
        d = (got[key].float() - want[key].float()).abs()
        assert float(d[want[key] > -1e29].max()) <= BF16["logits"], key


@pytest.mark.parametrize("name", [c.name for c in CASES])
def test_shard_shapes_and_bytes(world, name):
    """Each rank's blocks have ``steps.abstract_params``' shard shapes on
    the same grid; with bfloat16 parameters the bytes it holds
    (parameters, AdamW state, its batch block) are
    ``dryrun.argument_bytes``, exactly.  Its decode caches, as the last
    decode step left them, are the dry run's blocks
    (``steps.abstract_cache``' shard shapes: the sequence and the
    recurrent features cut over ``model`` where it divides them), and
    their bytes the dry run's at the held dtypes."""
    case = BY_NAME[name]
    cfg = _cfg(case.arch, case.tied)
    grid = mesh_lib.MeshShape(*case.mesh)
    with model_mesh._environ(_env(case)):
        want = [a.shard_shape for a in tree.leaves(
            steps.abstract_params(cfg, grid), is_leaf=steps.is_abstract)]
        cache = [a.shard_shape for a in tree.leaves(steps.abstract_cache(
            cfg, grid, B, PROMPT + DECODE, case.window),
            is_leaf=steps.is_abstract)]
    ranks = world[0][name]["ranks"]
    assert len(ranks) == grid.size
    for r in ranks:
        assert r["shard_shapes"] == want
        assert r["cache_shapes"] == cache
        c = r["cache_bytes"]
        assert c["held"] == c["dryrun"]
        if not case.f32:
            b = r["bytes"]
            assert b["params"] + b["opt"] + b["batch"] == b["dryrun"]


def test_bf16_shard_bytes_are_the_dry_runs(world):
    """The bytes a rank holds, checked against an independent count:
    ``dryrun.analyse`` of the same config, shape and grid."""
    ranks = world[0]["granite-bf16"]["ranks"]
    cfg = _cfg("granite_moe_3b_a800m")
    grid = mesh_lib.MeshShape(*GRID)
    ana = dryrun.analyse(cfg, steps.ShapeSpec("t", T, B, "train"), grid)
    assert {r["bytes"]["dryrun"] for r in ranks} \
        == {ana["memory"]["argument_bytes"]}
    assert all(r["analytic_collectives"]["all-gather"] > 0 for r in ranks)


def test_gathered_leaves_and_decode_leave_no_reference_cycle(world):
    """A layer's leaves gathered on use and dropped, and decode steps on
    cut caches, leave nothing that only the garbage collector frees: a
    reference cycle holding a gathered buffer would keep every layer's
    gathered parameters on the card until the collector happens to
    run."""
    assert world[1]["cycles"] == {"gather grad=False": 0,
                                  "gather grad=True": 0, "decode": 0}


def test_vocab_parallel_ce_gradient(world):
    """:class:`mesh_ops._VocabCE` on (data, model) blocks against
    autograd of the whole-row cross entropy (float64)."""
    out = world[1]
    i = out["inputs"]
    logits = i["logits"].clone().requires_grad_()
    ce = transformer._ce_rows(logits, i["labels"])
    (ce * i["r"]).sum().backward()
    torch.testing.assert_close(out["ce"], ce.detach(), rtol=1e-12,
                               atol=1e-12)
    torch.testing.assert_close(out["ce_grad"], logits.grad, rtol=1e-12,
                               atol=1e-12)
    torch.testing.assert_close(out["ce_loss"], (ce * i["r"]).sum().detach(),
                               rtol=1e-12, atol=1e-12)


def test_expert_parallel_combine_gradient(world):
    """``copy_in`` → a bank block a rank → ``gather_out`` against autograd
    of the whole product (float64)."""
    out = world[1]
    i = out["inputs"]
    x = i["x"].clone().requires_grad_()
    w = i["w"].clone().requires_grad_()
    full = torch.einsum("bd,edf->bef", x, w)
    (torch.tanh(full) * i["rr"]).sum().backward()
    torch.testing.assert_close(out["ep_out"], full.detach(), rtol=1e-12,
                               atol=1e-12)
    torch.testing.assert_close(out["ep_dx"], x.grad, rtol=1e-12, atol=1e-12)
    torch.testing.assert_close(out["ep_dw"], w.grad, rtol=1e-12, atol=1e-12)


@lru_cache(maxsize=None)
def _global_one_process(arch: str, knobs: int) -> dict:
    cfg, p, x, r = _moe_inputs(arch)
    p = tree.map(lambda a: a.clone().requires_grad_(), p)
    x = x.clone().requires_grad_()
    with model_mesh._environ(KNOBS[knobs]):
        y, aux = moe.moe_apply(p, x, cfg, impl="capacity_global")
    ((y * r).sum() + aux).backward()
    return dict(y=y.detach(), aux=aux.detach(), dx=x.grad,
                grads=tree.map(lambda a: a.grad, p))


@pytest.mark.parametrize("grid", ["grid", "pod"])
@pytest.mark.parametrize("arch", MOE_ARCHS)
@pytest.mark.parametrize("knobs", [0, 1])
def test_global_capacity_dispatch_on_a_mesh(world, grid, arch, knobs):
    """``moe_apply(impl="capacity_global")`` on the (2, 2) and the
    (pod 2, data 1, model 2) grid against the one-process call: each
    slot placed where the whole batch's sort puts it (the counts of the
    blocks before this rank's), expert-parallel where ``REPRO_SHARD_MOE=1``
    meets an ``"ep"`` config; output, aux loss and every gradient within
    1e-5 relative (the router and the combine run in float32)."""
    got = world[1]["global"][grid][f"{arch}-{knobs}"]
    want = _global_one_process(arch, knobs)
    assert got["ep"] == (knobs == 1 and arch != "granite_moe_3b_a800m")
    _check(f"global {grid} {arch}-{knobs} y", _rel(got["y"], want["y"]), REL)
    _check(f"global {grid} {arch}-{knobs} aux",
           abs(float(got["aux"] - want["aux"]))
           / max(abs(float(want["aux"])), 1e-12), REL)
    _check(f"global {grid} {arch}-{knobs} dx", _rel(got["dx"], want["dx"]),
           REL)
    gg, gw = _flat(got["grads"]), _flat(want["grads"])
    assert list(gg) == list(gw)
    for k in gw:
        _check(f"global {grid} {arch}-{knobs} grad {k}",
               _rel(gg[k], gw[k]), REL)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("knobs", [0, 1])
def test_mesh_equals_the_jax_reference_on_a_mesh(world, jax_side, arch,
                                                 knobs):
    """The port's (2, 2) grid against ``jax.jit(steps.make_train_step)``
    of the reference on a forced (2, 2) CPU mesh, parameters placed by
    the reference's ``rules.shardings``: both steps' losses and the
    parameters after the first."""
    jout, meta = jax_side()
    got = world[0][f"{arch}-{knobs}"]
    for a, b, bound in zip([m["loss"] for m in got["metrics"]],
                           meta[f"{arch}-{knobs}"], (LOSS32, LOSS32_STEP2),
                           strict=True):
        _check(f"jax {arch}-{knobs} loss", abs(a - b), bound)
    pre = f"{arch}-{knobs}|"
    want = {k[len(pre):]: v for k, v in jout.items() if k.startswith(pre)}
    params = _flat(got["params"][0])
    assert sorted(params) == sorted(want)
    for k, v in want.items():
        _check(f"jax {arch}-{knobs} params {k}",
               _relnorm(params[k], torch.from_numpy(v)), GRAD32)


def test_decode_on_a_mesh_needs_the_cache_specs():
    """A mesh decode holds the caches as ``rules.cache_specs``' blocks
    only: without the specs the serve step refuses before it runs."""
    cfg = _cfg("yi_6b")
    tok = torch.zeros(B, 1, dtype=torch.int32)
    with pytest.raises(ValueError, match="cache_blocks"):
        steps.serve_logits(cfg, None, tok, None, mesh=object())
    with pytest.raises(ValueError, match="cache_blocks"):
        steps.make_serve_step(cfg, mesh=object())(None, tok, None)


def test_no_mesh_by_default():
    """Outside ``use_mesh`` the model code sees no mesh: every branch
    falls through (``test_torch_models.py`` pins the one-process
    numbers)."""
    assert mesh_ops.current_mesh() is None
    assert mesh_ops.batch_axes() == ()
    assert mesh_ops.model_split() == (1, 0)
    cfg = _cfg("deepseek_v3_671b")
    with model_mesh._environ(KNOBS[1]):
        assert moe._constrain_ep(cfg) is None
        assert transformer._constrain_logits(cfg) is None
    x = torch.ones(2, 3, 4)
    assert transformer._constrain_batch_only(x) is x

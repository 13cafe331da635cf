"""The port's sharding rules (``repro_torch.sharding.rules``) against the
JAX package's on the CPU: every parameter spec of all ten architectures
at full width on the 16 x 16 and 2 x 16 x 16 production meshes, MoE
banks expert- and tensor-parallel, each environment knob on and off;
batch specs; every decode cache's specs, full and int8.  The reference
runs on a device-less ``AbstractMesh`` over its ``eval_shape`` trees; the
port on a :class:`~repro_torch.launch.mesh.MeshShape` over its ``meta``
trees.  A port spec is a tuple equal to ``tuple(jax_spec)``."""
import dataclasses
from functools import partial

import jax
import pytest
from jax.sharding import AbstractMesh
from jax.sharding import PartitionSpec as P

from repro.configs import registry as jregistry
from repro.launch import steps as jsteps
from repro.models import transformer as jtr
from repro.sharding import rules as jrules
from repro_torch import random as rnd
from repro_torch import tree
from repro_torch.configs import registry
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import steps
from repro_torch.models import transformer
from repro_torch.sharding import rules
from test_torch_gpu import one_torch_thread  # noqa: F401

MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
MOE = ("jamba_1_5_large_398b", "deepseek_v3_671b", "granite_moe_3b_a800m")
KNOBS = ("REPRO_MOE_TP_NO_FSDP", "REPRO_XLSTM_R_REPLICATED")


def _meshes(name):
    sizes, axes = MESHES[name]
    return AbstractMesh(sizes, axes), tmesh.MeshShape(axes, sizes)


def _knobs(monkeypatch, on: bool):
    for k in KNOBS:
        if on:
            monkeypatch.setenv(k, "1")
        else:
            monkeypatch.delenv(k, raising=False)


def _jax_keyed(t, is_leaf=None) -> dict:
    flat = jax.tree_util.tree_flatten_with_path(t, is_leaf=is_leaf)[0]
    return {jrules._path_str(p): v for p, v in flat}


def _is_spec(x) -> bool:
    """A port spec: a plain tuple of ``None``, axis names and tuples of
    axis names."""
    def entry(e):
        return e is None or isinstance(e, str) or (
            type(e) is tuple and all(isinstance(a, str) for a in e))
    return type(x) is tuple and all(entry(e) for e in x)


def _keyed(t) -> dict:
    """A spec tree's specs by path string."""
    out = {}
    tree.map_with_path(
        lambda p, x: out.__setitem__(rules._path_str(p), x), t,
        is_leaf=_is_spec)
    return out


@pytest.fixture(scope="module")
def shapes():
    """Each architecture's parameter shapes: the reference's
    ``eval_shape`` tree and the port's ``meta`` tree, once a module."""
    out = {}
    for arch in registry.ARCHS:
        jcfg = jregistry.get(arch)
        out[arch] = (
            jax.eval_shape(partial(jtr.init, cfg=jcfg), jax.random.PRNGKey(0)),
            transformer.init(rnd.PRNGKey(0, "meta"), registry.get(arch)))
    return out


def _param_cases():
    for arch in registry.ARCHS:
        for mesh in MESHES:
            for moe in (("ep", "tp") if arch in MOE else (None,)):
                for knobs in (False, True):
                    yield pytest.param(arch, mesh, moe, knobs,
                                       id=f"{arch}-{mesh}-{moe}-"
                                          f"{'knobs' if knobs else 'plain'}")


@pytest.mark.parametrize("arch,mesh,moe,knobs", list(_param_cases()))
def test_param_specs_equal_the_references(shapes, monkeypatch, arch, mesh,
                                          moe, knobs):
    """Leaf for leaf by path; ``moe`` forced with ``dataclasses.replace``
    on the MoE architectures (granite-moe's own is "tp", the others'
    "ep")."""
    _knobs(monkeypatch, knobs)
    jmesh, tm = _meshes(mesh)
    jcfg, cfg = jregistry.get(arch), registry.get(arch)
    if moe is not None:
        jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(
            jcfg.moe, sharding=moe))
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, sharding=moe))
    jshapes, tshapes = shapes[arch]
    want = _jax_keyed(jrules.param_specs(
        jshapes, jmesh, jcfg.moe.sharding if jcfg.moe else "ep"),
        is_leaf=lambda x: isinstance(x, P))
    got = _keyed(rules.param_specs(
        tshapes, tm, cfg.moe.sharding if cfg.moe else "ep"))
    assert {k: tuple(v) for k, v in want.items()} == got
    # the port's trees are the reference's, leaf for leaf
    jleaves = _jax_keyed(jshapes)
    assert {k: tuple(v.shape) for k, v in jleaves.items()} == {
        k: tuple(v.shape) for k, v in _keyed_tensors(tshapes).items()}


def _keyed_tensors(t) -> dict:
    out = {}
    tree.map_with_path(
        lambda p, x: out.__setitem__(rules._path_str(p), x), t)
    return out


def test_moe_banks_follow_the_configs_sharding(shapes):
    """granite-moe's ``moe.sharding`` is "tp": its expert banks shard
    d_expert over "model" and d over the FSDP axes."""
    _, tm = _meshes("16x16")
    cfg = registry.get("granite_moe_3b_a800m")
    assert cfg.moe.sharding == "tp"
    got = _keyed(rules.param_specs(shapes["granite_moe_3b_a800m"][1], tm,
                                   "tp"))
    assert got["segments/0/0/ffn/gate"] == (None, None, "data", "model")
    assert got["segments/0/0/ffn/down"] == (None, None, "model", "data")


@pytest.mark.parametrize("mesh", ["16x16", "2x16x16", "1x1"])
@pytest.mark.parametrize("batch", [1, 8, 256])
def test_batch_spec_equals_the_references(mesh, batch):
    if mesh == "1x1":
        jmesh = AbstractMesh((1, 1), ("data", "model"))
        tm = tmesh.make_host_mesh()
    else:
        jmesh, tm = _meshes(mesh)
    assert rules.batch_spec(tm, batch) == tuple(
        jrules.batch_spec(jmesh, batch))


def _cache_cases():
    for arch in registry.ARCHS:
        for shape in ("decode_32k", "long_500k"):
            for quant in (False, True):
                yield pytest.param(arch, shape, quant,
                                   id=f"{arch}-{shape}-"
                                      f"{'int8' if quant else 'full'}")


@pytest.mark.parametrize("arch,shape,quant", list(_cache_cases()))
def test_cache_specs_equal_the_references(monkeypatch, arch, shape, quant):
    """Every cache leaf's spec on both meshes, ``long_500k`` with the
    architecture's window; ``REPRO_QUANT_KV=1`` gives the attention
    layers the int8 cache (``QuantKVCache``)."""
    if quant:
        monkeypatch.setenv("REPRO_QUANT_KV", "1")
    else:
        monkeypatch.delenv("REPRO_QUANT_KV", raising=False)
    jcfg, cfg = jregistry.get(arch), registry.get(arch)
    sh = steps.SHAPES[shape]
    window = steps.needs_window(cfg, sh)
    assert window == jsteps.needs_window(jcfg, jsteps.SHAPES[shape])
    jc = jax.eval_shape(lambda: jtr.init_cache(
        jcfg, sh.global_batch, sh.seq_len, window))
    tc = transformer.init_cache(cfg, sh.global_batch, sh.seq_len, window,
                                device="meta")
    assert [[type(c).__name__ for c in seg] for seg in tc] == \
        [[type(c).__name__ for c in seg] for seg in jc]
    for mesh in MESHES:
        jmesh, tm = _meshes(mesh)
        want = _jax_keyed(jrules.cache_specs(jc, jmesh),
                          is_leaf=lambda x: isinstance(x, P))
        got = _keyed(rules.cache_specs(tc, tm))
        assert {k: tuple(v) for k, v in want.items()} == got


def test_path_strings_are_the_references():
    """``tree.map_with_path`` keys dicts, sequences and named tuples as
    jax's key paths do."""
    import torch
    from repro_torch.optim import adamw
    x = torch.zeros(1)
    t = {"a": [(x, {"b": x})], "s": adamw.AdamWState(x, {"w": x}, [x])}
    got = sorted(_keyed_tensors(t))
    want = sorted(_jax_keyed(jax.tree.map(lambda _: 0, t)))
    assert got == want == ["a/0/0", "a/0/1/b", "s/m/w", "s/step", "s/v/0"]


# -- the reference's own cases (tests/test_optim_sharding.py) -------------

def _fake():
    return AbstractMesh((2, 2), ("data", "model")), \
        tmesh.MeshShape(("data", "model"), (2, 2))


@pytest.mark.parametrize("path,shape,moe,want", [
    ("embed", (64, 32), "ep", ("model", "data")),
    ("lm_head", (32, 64), "ep", (None, "model")),
    ("segments/0/mixer/wq", (4, 32, 64), "ep", (None, "data", "model")),
    ("segments/0/mixer/wo", (4, 64, 32), "ep", (None, "model", "data")),
    ("segments/0/ffn/gate", (4, 8, 32, 16), "ep",
     (None, "model", "data", None)),
    ("segments/0/norm1", (4, 32), "ep", (None, None)),
    # divisibility guard: vocab 49155 does not divide 2
    ("embed", (49155, 32), "ep", (None, "data")),
    ("lm_head", (32, 49155), "ep", (None, None)),
])
def test_param_spec_patterns(path, shape, moe, want):
    jmesh, tm = _fake()
    assert rules.param_spec(path, shape, tm, moe) == want
    assert tuple(jrules.param_spec(path, shape, jmesh, moe)) == want


def test_batch_spec_fallback_for_tiny_batch():
    jmesh, tm = _fake()
    assert rules.batch_spec(tm, 8) == ("data", None)
    assert rules.batch_spec(tm, 1) == (None, None)   # long_500k case
    assert tuple(jrules.batch_spec(jmesh, 1)) == (None, None)


def test_meshes_are_the_references_shapes():
    for multi, want in ((False, {"data": 16, "model": 16}),
                        (True, {"pod": 2, "data": 16, "model": 16})):
        m = tmesh.make_production_mesh(multi_pod=multi)
        assert m.shape == want and list(m.axis_names) == list(want)
        assert m.size == (512 if multi else 256)
    assert tmesh.make_host_mesh().shape == {"data": 1, "model": 1}

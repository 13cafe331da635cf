"""The port's abstract inputs and dry run (``repro_torch.launch.steps``,
``hlo_analysis``, ``dryrun``) against the JAX package on the CPU.

``input_specs`` builds the reference's trees leaf for leaf (path, shape,
dtype, spec, one device's block) for all ten architectures at full
width; one device's argument bytes equal the reference's shard-byte sum
and, on a forced 8-device CPU mesh, XLA's own ``argument_size_in_bytes``
(the reference compiled in a subprocess, through its public functions);
``roofline`` is the reference's code by AST and by output; the CLI
reports no field only XLA can give."""
import ast
import json
import os
import subprocess
import sys
from functools import lru_cache
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

from repro.configs import registry as jregistry
from repro.launch import hlo_analysis as jhlo
from repro.launch import steps as jsteps
from repro.optim import adamw as jadamw
from repro.sharding import rules as jrules
from repro_torch import tree
from repro_torch.configs import registry
from repro_torch.launch import dryrun, hlo_analysis, steps
from repro_torch.launch.mesh import MeshShape
from repro_torch.models import config as mcfg
from repro_torch.optim import adamw
from repro_torch.sharding import rules
from test_torch_gpu import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
XLA_ONLY = ("lower_s", "compile_s", "temp_bytes", "peak_bytes_per_device",
            "hlo_flops_per_device", "hlo_bytes_per_device",
            "useful_flops_ratio")


@pytest.fixture(scope="module", autouse=True)
def meta_params_once():
    """Each architecture's ``meta`` parameters built once a module and
    reused across shapes and meshes (jamba's takes seconds)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(steps, "_meta_params", lru_cache(None)(
            steps._meta_params))
        yield


def _jax_leaves(ins: dict) -> dict:
    flat = jax.tree_util.tree_flatten_with_path(
        {k: v for k, v in ins.items() if k != "window"})[0]
    return {jrules._path_str(p): (tuple(x.shape), str(x.dtype),
                                  tuple(x.sharding.spec),
                                  tuple(x.sharding.shard_shape(x.shape)))
            for p, x in flat}


def _leaves(ins: dict) -> dict:
    out = {}
    tree.map_with_path(
        lambda p, a: out.__setitem__(rules._path_str(p), (
            a.shape, str(a.dtype).removeprefix("torch."), a.spec,
            a.shard_shape)),
        {k: v for k, v in ins.items() if k != "window"},
        is_leaf=steps.is_abstract)
    return out


def _shard_bytes(ins: dict) -> int:
    """The reference's per-device argument bytes: each leaf's shard shape
    times its itemsize."""
    return sum(int(np.prod(x.sharding.shard_shape(x.shape)))
               * np.dtype(x.dtype).itemsize
               for k, v in ins.items() if k != "window"
               for x in jax.tree.leaves(v))


def _cases():
    for arch in registry.ARCHS:
        for shape in steps.SHAPES:
            yield pytest.param(arch, shape, "16x16", id=f"{arch}-{shape}")
        for shape in ("train_4k", "long_500k"):
            yield pytest.param(arch, shape, "2x16x16",
                               id=f"{arch}-{shape}-2x16x16")


@pytest.mark.parametrize("arch,shape,mesh", list(_cases()))
def test_input_specs_equal_the_references(arch, shape, mesh):
    """Leaf for leaf: path, shape, dtype, spec and one device's block;
    the same keys, the same window, the same argument bytes."""
    sizes, axes = MESHES[mesh]
    jins = jsteps.input_specs(jregistry.get(arch), jsteps.SHAPES[shape],
                              AbstractMesh(sizes, axes))
    ins = steps.input_specs(registry.get(arch), steps.SHAPES[shape],
                            MeshShape(axes, sizes))
    assert list(ins) == list(jins)
    assert ins.get("window") == jins.get("window")
    assert isinstance(ins["params"], dict)
    if "opt_state" in ins:
        assert isinstance(ins["opt_state"], adamw.AdamWState)
    if "caches" in ins:
        assert isinstance(ins["caches"], list)
    assert _leaves(ins) == _jax_leaves(jins)
    assert all(a.value.device.type == "meta" for a in tree.leaves(
        {k: v for k, v in ins.items() if k != "window"},
        is_leaf=steps.is_abstract))
    assert dryrun.argument_bytes(ins, steps.SHAPES[shape].kind) == \
        _shard_bytes(jins)


def test_bf16_optimizer_state_equals_the_references():
    """``--opt-dtype bf16``: moments in bfloat16 on both sides."""
    sizes, axes = MESHES["16x16"]
    jins = jsteps.input_specs(
        jregistry.get("yi-6b"), jsteps.SHAPES["train_4k"],
        AbstractMesh(sizes, axes),
        jadamw.AdamWConfig(state_dtype=jax.numpy.bfloat16))
    ins = steps.input_specs(
        registry.get("yi-6b"), steps.SHAPES["train_4k"],
        MeshShape(axes, sizes), adamw.AdamWConfig(state_dtype=torch.bfloat16))
    assert _leaves(ins) == _jax_leaves(jins)
    assert dryrun.argument_bytes(ins, "train") == _shard_bytes(jins)


@pytest.mark.parametrize("arch,shape,want", [
    ("yi-6b", "train_4k", 393_535_492),
    ("yi-6b", "decode_32k", 1_152_345_120),
    ("granite-moe-3b-a800m", "train_4k", 179_091_972),
    ("granite-moe-3b-a800m", "decode_32k", 1_109_653_024),
    ("deepseek-v3-671b", "train_4k", 26_841_161_220),
    ("deepseek-v3-671b", "decode_32k", 6_530_108_864),
])
def test_argument_bytes_at_16x16(arch, shape, want):
    """The per-device argument bytes the reference's shard shapes give
    at 16 x 16, written down."""
    ins = steps.input_specs(registry.get(arch), steps.SHAPES[shape],
                            MeshShape(*reversed(MESHES["16x16"])))
    assert dryrun.argument_bytes(ins, steps.SHAPES[shape].kind) == want


# -- roofline: the reference's code ---------------------------------------

def _defs(path: Path) -> dict:
    keep = ("_DTYPE_BYTES", "COLLECTIVES", "roofline")
    out = {}
    for node in ast.parse(path.read_text()).body:
        name = getattr(node, "name", None) or (
            isinstance(node, ast.Assign) and node.targets[0].id)
        if name in keep:
            out[name] = ast.dump(node)
    return out


def test_roofline_is_the_references_code():
    port = _defs(ROOT / "src/repro_torch/launch/hlo_analysis.py")
    assert port == _defs(ROOT / "src/repro/launch/hlo_analysis.py")
    assert len(port) == 3


@pytest.mark.parametrize("model_flops", [197e12 * 256, None])
def test_roofline_terms_equal_the_references(model_flops):
    """The inputs of the reference's test_roofline_terms_and_bottleneck."""
    cost = {"flops": 197e12, "bytes accessed": 819e9 * 2}
    coll = {"all-reduce": int(50e9 * 3)}
    kw = dict(peak_flops=197e12, hbm_bw=819e9, ici_bw=50e9,
              model_flops=model_flops, chips=256, arg_bytes=3e9)
    got = hlo_analysis.roofline(cost, coll, **kw)
    assert got == jhlo.roofline(cost, coll, **kw)
    assert got["bottleneck"] == "collective"
    assert hlo_analysis.COLLECTIVES == jhlo.COLLECTIVES
    assert hlo_analysis._DTYPE_BYTES == jhlo._DTYPE_BYTES


# -- XLA's own argument bytes on a forced 8-device mesh -------------------

XLA_CODE = r"""
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax, numpy as np
from jax.sharding import Mesh
from repro.configs import registry
from repro.launch import steps
from repro.models import config as mcfg
from repro.sharding import compat
mesh = Mesh(np.asarray(jax.devices()[:8]).reshape(2, 4), ("data", "model"))
out = {}
for arch in ("yi-6b", "granite-moe-3b-a800m"):
    cfg = mcfg.reduced(registry.get(arch))
    for kind in ("train", "decode"):
        ins = steps.input_specs(cfg, steps.ShapeSpec("t", 64, 4, kind), mesh)
        with compat.set_mesh(mesh):
            if kind == "train":
                lowered = jax.jit(steps.make_train_step(cfg)).lower(
                    ins["params"], ins["opt_state"], ins["batch"])
            else:
                lowered = jax.jit(steps.make_serve_step(
                    cfg, window=ins["window"])).lower(
                    ins["params"], ins["token"], ins["caches"])
            mem = lowered.compile().memory_analysis()
        out[f"{arch}/{kind}"] = mem.argument_size_in_bytes
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def xla_argument_bytes():
    """One subprocess: 8 forced host devices (a device count is fixed
    when jax starts), the reference's steps compiled on a (2, 4) mesh."""
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", XLA_CODE], env=env,
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-4000:]
    return json.loads(res.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("arch", ["yi-6b", "granite-moe-3b-a800m"])
@pytest.mark.parametrize("kind", ["train", "decode"])
def test_argument_bytes_equal_xlas(xla_argument_bytes, arch, kind):
    """Reduced configs, seq 64, batch 4, on a (2, 4) ("data", "model")
    mesh."""
    cfg = mcfg.reduced(registry.get(arch))
    ins = steps.input_specs(cfg, steps.ShapeSpec("t", 64, 4, kind),
                            MeshShape(("data", "model"), (2, 4)))
    assert dryrun.argument_bytes(ins, kind) == \
        xla_argument_bytes[f"{arch}/{kind}"]


# -- the CLI ----------------------------------------------------------------

def _check_result(r: dict):
    assert {"arch", "shape", "mesh", "chips", "kind", "params",
            "active_params", "memory", "roofline"} <= set(r)
    assert set(r["memory"]) == {"argument_bytes", "output_bytes"}
    rf = r["roofline"]
    assert rf["collective_source"] == "analytic (rules)"
    assert rf["compute_s"] == rf["compute_s_analytic"]
    assert rf["memory_s"] == rf["memory_s_floor"]
    assert set(rf["collective_breakdown"]) == set(hlo_analysis.COLLECTIVES)
    keys = set(r) | set(r["memory"]) | set(rf)
    assert not keys & set(XLA_ONLY)
    assert not any(k.endswith("_hlo") for k in keys)


def test_main_one_combination(capsys):
    [r] = dryrun.main(["--arch", "yi-6b", "--shape", "train_4k"])
    _check_result(r)
    assert json.loads(capsys.readouterr().out.strip()) == r
    assert (r["mesh"], r["chips"], r["kind"]) == ("16x16", 256, "train")
    assert r["memory"]["argument_bytes"] == 393_535_492
    assert r["params"] == r["active_params"] == \
        registry.get("yi-6b").param_count()
    rf = r["roofline"]
    # 6·N·tokens over 256 cards' bf16 peak; argument bytes over HBM3
    assert rf["compute_s_analytic"] == pytest.approx(
        6 * r["params"] * 256 * 4096 / (256 * 989e12))
    assert rf["memory_s_floor"] == pytest.approx(393_535_492 / 3.35e12)
    # each FSDP-sharded leaf gathered twice (forward, backward), its
    # gradient reduce-scattered once
    coll = rf["collective_breakdown"]
    assert coll["all-gather"] == 2 * coll["reduce-scatter"] > 0
    assert coll["all-reduce"] == coll["all-to-all"] == 0
    assert rf["link"] == "NDR 400 Gb/s"


def test_main_all_on_a_reduced_registry(monkeypatch, tmp_path, capsys):
    """``--all --multi-pod --out``: every architecture (reduced) × shape,
    one JSON line and one file each, nothing else written."""
    get = registry.get
    monkeypatch.setattr(registry, "get", lambda a: mcfg.reduced(get(a)))
    out = dryrun.main(["--all", "--multi-pod", "--out", str(tmp_path),
                       "--tag", "t", "--opt-dtype", "bf16"])
    assert len(out) == len(registry.ARCHS) * len(steps.SHAPES)
    assert {r["kind"] for r in out} == {"train", "prefill", "decode"}
    lines = capsys.readouterr().out.strip().splitlines()
    assert [json.loads(x) for x in lines] == out
    for r in out:
        _check_result(r)
        assert r["mesh"] == "2x16x16" and r["chips"] == 512
    assert sorted(p.name for p in tmp_path.iterdir()) == sorted(
        f"dryrun_{r['arch']}_{r['shape']}_2x16x16_t.json" for r in out)

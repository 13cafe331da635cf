"""The federated dry run's collective sections and the abstract round
inputs they read (``launch/fed_dryrun.py``, ``launch/fed_train.py``'s
``abstract_*``) against the JAX package on the CPU.

* every ``abstract_*`` leaf equals the reference's ``ShapeDtypeStruct``
  on an ``AbstractMesh`` (16 x 16, 2 x 16 x 16 and the host mesh, and a
  client count that does not divide the FSDP axes): shape, dtype, spec
  tuple and shard shape, and the client axes returned;
* each section equals XLA's collective bytes, kind by kind, for the
  reference's three programs lowered at a reduced width on 8 forced
  CPU devices (one subprocess of ``tools/fed_dryrun_xla.py``);
* the 16 x 16 figures at paper width, worked out here;
* the CLI needs no card for the sections and writes only under
  ``--out``."""
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import pytest
from jax.sharding import AbstractMesh

from repro.core import federation as jfederation
from repro.core import tm as jtm
from repro.launch import fed_train as jfed_train
from repro_torch import tree
from repro_torch.core import federation, tm
from repro_torch.launch import fed_dryrun, fed_train, hlo_analysis, steps
from repro_torch.launch.mesh import H100_NDR_BW, MeshShape
from test_torch_gpu import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
          "host": ((1, 1), ("data", "model"))}
PAPER = dict(n_classes=10, n_clauses=300, n_features=784, n_states=127,
             s=10.0, T=1000)
SMALL = dict(n_classes=10, n_clauses=16, n_features=64, n_states=127,
             s=10.0, T=1000)
SMALL_DATA = dict(n_train=8, n_test=4, n_conf=4)


def _jax_leaves(t) -> list:
    return [(tuple(x.shape), str(x.dtype), tuple(x.sharding.spec),
             tuple(x.sharding.shard_shape(x.shape)))
            for x in jax.tree_util.tree_leaves(t)]


def _leaves(t) -> list:
    return [(a.shape, str(a.dtype).removeprefix("torch."), a.spec,
             a.shard_shape)
            for a in tree.leaves(t, is_leaf=steps.is_abstract)]


def _meshes(name):
    sizes, names = MESHES[name]
    return AbstractMesh(sizes, names), MeshShape(names, sizes)


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("n_clients", [256, 100])
def test_abstract_round_inputs_equal_the_references(mesh_name, n_clients):
    jmesh, mesh = _meshes(mesh_name)
    jcfg = (jtm.TMConfig(**PAPER), jfederation.FedConfig(n_clients=n_clients))
    cfg = (tm.TMConfig(**PAPER), federation.FedConfig(n_clients=n_clients))
    want = jfed_train.abstract_round_inputs(*jcfg, jmesh)
    got = fed_train.abstract_round_inputs(*cfg, mesh)
    assert got[-1] == want[-1]                    # the client axes
    assert _leaves(got[:-1]) == _jax_leaves(want[:-1])
    assert len(_leaves(got[:-1])) == 2 + 1 + 7 + 1 + 2
    assert type(got[1]).__name__ == "ServerState"
    assert all(a.value.device.type == "meta"
               for a in tree.leaves(got[:-1], is_leaf=steps.is_abstract))
    kw = dict(n_train=8, n_test=3, n_conf=5)
    assert _leaves(fed_train.abstract_fed_inputs(*cfg, mesh, **kw)) == \
        _jax_leaves(jfed_train.abstract_fed_inputs(*jcfg, jmesh, **kw))


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("n_clients,j_slots", [(256, 1), (128, 2), (100, 1)])
def test_abstract_async_inputs_equal_the_references(mesh_name, n_clients,
                                                    j_slots):
    jmesh, mesh = _meshes(mesh_name)
    want = jfed_train.abstract_async_inputs(
        jtm.TMConfig(**PAPER), jfederation.FedConfig(n_clients=n_clients),
        jmesh, capacity=96, j_slots=j_slots)
    got = fed_train.abstract_async_inputs(
        tm.TMConfig(**PAPER), federation.FedConfig(n_clients=n_clients),
        mesh, capacity=96, j_slots=j_slots)
    assert got[-1] == want[-1]
    assert _leaves(got[:-1]) == _jax_leaves(want[:-1])
    assert got[1][0].shape == (n_clients * j_slots, 300)


# -- the sections against XLA's collectives --------------------------------

CASES = {"4x2": dict(sizes=(4, 2), names=("data", "model"), j=1),
         "2x2x2": dict(sizes=(2, 2, 2), names=("pod", "data", "model"), j=1),
         "1x8": dict(sizes=(1, 8), names=("data", "model"), j=1),
         "4x2-j2": dict(sizes=(4, 2), names=("data", "model"), j=2)}
N_SMALL, CAP_SMALL = 8, 16


@pytest.fixture(scope="module")
def xla_collectives():
    """One subprocess (``tools/fed_dryrun_xla.py``): 8 forced host
    devices (a device count is fixed when jax starts), the reference's
    three programs lowered on each mesh of ``CASES``."""
    spec = dict(tm=SMALL, n=N_SMALL, cap=CAP_SMALL, data=SMALL_DATA,
                cases=[dict(c, id=k) for k, c in CASES.items()])
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, str(ROOT / "tools" /
                                              "fed_dryrun_xla.py"),
                          json.dumps(spec)], env=env, capture_output=True,
                         text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-4000:]
    return json.loads(res.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("case", sorted(CASES))
def test_sections_equal_xlas_collectives(xla_collectives, case):
    c = CASES[case]
    got = fed_dryrun.collectives(
        tm.TMConfig(**SMALL),
        federation.FedConfig(n_clients=N_SMALL, rounds=1, local_epochs=1,
                             top_classes=c["j"]),
        MeshShape(c["names"], c["sizes"]), CAP_SMALL, **SMALL_DATA)
    for name in fed_dryrun.SECTIONS:
        assert got[name]["breakdown"] == xla_collectives[f"{case}/{name}"], \
            name
        assert got[name]["collective_source"] == "analytic"
    if case == "1x8":          # XLA drops the mean over one client device
        assert got["fedavg_tm"]["collective_bytes_per_device"] == 0


def test_sections_at_16x16_and_paper_width(capsys):
    C, m, L, n = 10, 300, 2 * 784, 256
    psum = 4 * C * (m + 1)                       # accumulator + totals
    lanes = n * (4 * m + 4 + 4 + 4 + 1)          # vecs, slot, ready, w, ok
    state = 4 * C * m * L + 4 * C * m            # TA states + weights, f32
    assert (psum, lanes, state) == (12_040, 310_528, 18_828_000)
    for multi_pod in (False, True):
        out = fed_dryrun.run(multi_pod=multi_pod)
        assert out["mesh"] == ("2x16x16" if multi_pod else "16x16")
        assert out["tpfl"]["breakdown"]["all-reduce"] == psum
        assert out["tpfl"]["collective_bytes_per_device"] == 12_040
        assert out["tpfl_async"]["breakdown"]["all-gather"] == lanes
        assert out["tpfl_async"]["breakdown"]["all-reduce"] == psum
        assert out["tpfl_async"]["collective_bytes_per_device"] == 322_568
        fedavg = out["fedavg_tm"]
        assert fedavg["payload_bytes"] == state
        assert fedavg["mean_accuracy_bytes"] == 4
        assert fedavg["breakdown"]["all-reduce"] == \
            fedavg["collective_bytes_per_device"] == 18_828_004
        assert "not_counted" in fedavg
        assert out["fedavg_over_tpfl"] == 18_828_004 / 12_040
        for name in fed_dryrun.SECTIONS:
            sec = out[name]
            assert set(sec["breakdown"]) == set(hlo_analysis.COLLECTIVES)
            assert sec["link"] == "NDR 400 Gb/s"
            assert sec["collective_s"] == \
                sec["collective_bytes_per_device"] / H100_NDR_BW
    assert "FedAvg-TM moves 1563.8× the collective bytes of TPFL" in \
        capsys.readouterr().out


def test_cli_sections_need_no_card(monkeypatch, tmp_path, capsys):
    import torch

    def no_cuda():
        raise AssertionError("the dry run initialized CUDA")

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(torch.cuda, "_lazy_init", no_cuda)
    out = fed_dryrun.main(["--skip-client-scale", "--multi-pod", "--out",
                           str(tmp_path)])
    assert "client_scale" not in out
    assert [p.name for p in tmp_path.iterdir()] == ["fed_dryrun_2x16x16.json"]
    assert json.loads((tmp_path / "fed_dryrun_2x16x16.json").read_text()) \
        == json.loads(json.dumps(out))
    with pytest.raises(SystemExit, match="100 clients do not divide"):
        fed_dryrun.main(["--skip-client-scale", "--clients", "100"])
    # the population section still draws on the card unless asked not to
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fed_dryrun.main(["--population", "100", "--active", "2"])
    capsys.readouterr()

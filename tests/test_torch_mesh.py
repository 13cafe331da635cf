"""The clients mesh on ``torch.distributed`` (``repro_torch.launch.mesh``),
the sharded forms of ``repro_torch.fl.masked_collectives``, the mesh CLI
(``fed_train --mesh``) and the dry run's client-store section.

The sharded forms run at W = 1, 2 and 4 in one 4-rank ``gloo`` world
(the W = 1 and 2 meshes are subgroups of it), against the port's host
forms and against the JAX package's ``shard_map`` forms at the same W.
The JAX side runs in a subprocess with ``--xla_force_host_platform_
device_count=4`` (a test worker may have started jax already, with one
device), so this module imports no jax: the spawned ranks import it for
its worker functions.  Integer values at power-of-two weights are held
exactly; other values within atol 1e-6 / rtol 1e-5 (the ranks' partial
sums add in another order than one device's, as in the reference).

The CLI runs ``--device cpu --mesh clients:4`` (4 ``gloo`` processes):
sync on ``gather`` and async on ``psum``, each interrupted after round 1
and resumed, against the uninterrupted in-process CLI's round lines and
checkpoint files, byte for byte; and on an empty ``--data-dir``, whose
mirror rank 0 writes alone.
"""
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core import clustering
from repro_torch.fl import masked_collectives as mc
from repro_torch.launch import fed_dryrun, fed_train
from repro_torch.launch import mesh as mesh_lib
from test_torch_gpu import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
WIDTHS = (1, 2, 4)
C_G, C_W, C_B, C_S = 10, 3, 4, 3     # clusters of each case
TOL = dict(atol=1e-6, rtol=1e-5)


def _cases() -> dict[str, np.ndarray]:
    """The inputs, from a seed: ``int`` integer values at power-of-two
    weights, ``frac`` normal values at uniform weights.  Seven gathered
    rows and a buffer of 7 divide neither 2 nor 4."""
    rng = np.random.default_rng(0)
    out = {}
    for kind in ("int", "frac"):
        def vals(*shape):
            if kind == "int":
                return rng.integers(-8, 9, shape).astype(np.float32)
            return rng.standard_normal(shape).astype(np.float32)

        def weights(n):
            if kind == "int":
                return (0.5 ** rng.integers(0, 3, n)).astype(np.float32)
            return rng.uniform(0, 1, n).astype(np.float32)

        out[f"g_{kind}_vals"] = vals(7, 20)
        out[f"g_{kind}_slots"] = rng.integers(-1, C_G, 7).astype(np.int32)
        out[f"w_{kind}_vals"] = vals(8, 12)
        out[f"w_{kind}_slots"] = rng.integers(-1, C_W, 8).astype(np.int32)
        out[f"w_{kind}_weights"] = weights(8)
        out[f"b_{kind}_vals"] = vals(7, 6)
        out[f"b_{kind}_slots"] = rng.integers(-1, C_B, 7).astype(np.int32)
        out[f"b_{kind}_weights"] = weights(7)
        out[f"s_{kind}_vals"] = vals(4, 9)
    out["s_clusters"] = np.asarray([0, 2, 0, 1], np.int32)
    return out


def _block(a: torch.Tensor, k: int, w: int, rank: int, fill=None):
    """Rank ``rank``'s block of ``ceil(k / w)`` rows, padded past ``k``."""
    blk = -(-k // w)
    part = a[rank * blk:min((rank + 1) * blk, k)]
    pad = blk - part.shape[0]
    if pad:
        tail = a[:1].repeat(pad, *([1] * (a.ndim - 1))) if fill is None \
            else torch.full((pad,) + tuple(a.shape[1:]), fill, dtype=a.dtype)
        part = torch.cat([part, tail])
    return part


def _collectives(world, cases, tmp):
    """Rank worker: every sharded form at each W, on the W-rank subgroup;
    returns every rank's outputs and meters to rank 0.  First, what the
    ranks read of a file rank 0 writes late under ``rank_zero_first``."""
    t = {k: torch.from_numpy(v) for k, v in cases.items()}
    out = {}
    path = Path(tmp) / "filled_by_rank_0"
    with mesh_lib.rank_zero_first(world):
        if world.rank == 0:
            time.sleep(0.5)
            path.write_text("whole")
        out["rank_zero_first"] = path.read_text()
    for w in WIDTHS:
        mesh = mesh_lib.make_clients_mesh(w, device="cpu")
        if mesh is None:
            continue
        r = mesh.rank
        for kind in ("int", "frac"):
            pre = f"{kind}_{w}"
            v, s = t[f"g_{kind}_vals"], t[f"g_{kind}_slots"]
            mesh.meter.reset()
            mean, counts = mc.clustered_mean_gathered(
                _block(v, 7, w, r), _block(s, 7, w, r, -1), C_G, mesh,
                n_valid=7)
            out[f"g_{pre}"] = (mean.numpy(), counts.numpy(),
                               mesh.meter.payload("aggregate"))
            v, s, wt = (t[f"w_{kind}_{x}"]
                        for x in ("vals", "slots", "weights"))
            mesh.meter.reset()
            mean, total = mc.clustered_weighted_mean_sharded(
                _block(v, 8, w, r), _block(s, 8, w, r),
                _block(wt, 8, w, r), C_W, mesh,
                exact_products=kind == "int")
            out[f"w_{pre}"] = (mean.numpy(), total.numpy(),
                               mesh.meter.payload("aggregate"))
            v, s, wt = (t[f"b_{kind}_{x}"]
                        for x in ("vals", "slots", "weights"))
            mean, total = mc.buffered_weighted_mean_sharded(
                v, s, wt, C_B, mesh, exact_products=kind == "int")
            out[f"b_{pre}"] = (mean.numpy(), total.numpy())
            mine = mc.clustered_mean_sharded(
                t[f"s_{kind}_vals"][r], t["s_clusters"][r], C_S, mesh)
            out[f"s_{pre}"] = mine.numpy()
    return mesh_lib.gather_object(world, out)


JAX_CODE = """
import json, sys
import numpy as np
import jax
from jax.experimental.shard_map import shard_map
from jax.sharding import Mesh, PartitionSpec as P
from repro.fl import masked_collectives as mc
from repro.fl.obs import build_manifest

cases = dict(np.load(sys.argv[1]))
out = {}
spec = P("clients")


def pad(a, w, fill=None):
    k = a.shape[0]
    extra = (-k) % w
    tail = np.repeat(a[:1], extra, 0) if fill is None \\
        else np.full((extra,) + a.shape[1:], fill, a.dtype)
    return np.concatenate([a, tail])


for w in (1, 2, 4):
    mesh = Mesh(np.asarray(jax.devices()[:w]), ("clients",))
    for kind in ("int", "frac"):
        pre = f"{kind}_{w}"
        v, s = cases[f"g_{kind}_vals"], cases[f"g_{kind}_slots"]
        f = shard_map(lambda a, b: mc.clustered_mean_gathered(
            a, b, 10, "clients", n_valid=7), mesh=mesh,
            in_specs=(spec, spec), out_specs=(P(), P()), check_rep=False)
        m, c = jax.jit(f)(pad(v, w), pad(s, w, -1))
        out[f"g_{pre}_mean"], out[f"g_{pre}_counts"] = m, c
        v, s, wt = (cases[f"w_{kind}_{x}"]
                    for x in ("vals", "slots", "weights"))
        f = shard_map(lambda a, b, c: mc.clustered_weighted_mean_sharded(
            a, b, c, 3, "clients"), mesh=mesh, in_specs=(spec,) * 3,
            out_specs=(P(), P()), check_rep=False)
        out[f"w_{pre}_mean"], out[f"w_{pre}_total"] = jax.jit(f)(v, s, wt)
        v, s, wt = (cases[f"b_{kind}_{x}"]
                    for x in ("vals", "slots", "weights"))
        f = shard_map(lambda a, b, c: mc.buffered_weighted_mean_sharded(
            a, b, c, 4, "clients", w), mesh=mesh, in_specs=(P(),) * 3,
            out_specs=(P(), P()), check_rep=False)
        out[f"b_{pre}_mean"], out[f"b_{pre}_total"] = jax.jit(f)(v, s, wt)
        f = shard_map(lambda a, b: mc.clustered_mean_sharded(
            a[0], b[0], 3, "clients")[None], mesh=mesh,
            in_specs=(spec, spec), out_specs=spec, check_rep=False)
        out[f"s_{pre}"] = jax.jit(f)(cases[f"s_{kind}_vals"][:w],
                                     cases["s_clusters"][:w])
np.savez(sys.argv[2], **{k: np.asarray(v) for k, v in out.items()})
meta = {"payload": {c: [mc.collective_payload_bytes(c, n, d, k)
                        for n, d, k in ((7, 20, 10), (8, 12, 3),
                                        (6, 8, 10))]
                    for c in ("gather", "psum")},
        "mesh": build_manifest(mesh=Mesh(np.asarray(jax.devices()[:4]),
                                         ("clients",)))["mesh"]}
from repro.launch import fed_dryrun
meta["client_scale"] = fed_dryrun.client_scale(2000, 16)
print("JAX_META " + json.dumps(meta))
"""


@pytest.fixture(scope="module")
def jax_side(tmp_path_factory):
    """The JAX package's sharded forms on 4 virtual CPU devices, in a
    subprocess started first so it runs beside the torch world."""
    d = tmp_path_factory.mktemp("jax_side")
    np.savez(d / "cases.npz", **_cases())
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=str(ROOT / "src"), TMPDIR=str(d))
    proc = subprocess.Popen(
        [sys.executable, "-c", JAX_CODE, str(d / "cases.npz"),
         str(d / "out.npz")], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)

    def result():
        out, err = proc.communicate(timeout=600)
        assert proc.returncode == 0, err[-3000:]
        meta = json.loads(next(x for x in out.splitlines()
                               if x.startswith("JAX_META "))[9:])
        return dict(np.load(d / "out.npz")), meta

    yield result
    if proc.poll() is None:
        proc.kill()


@pytest.fixture(scope="module")
def world(jax_side, tmp_path_factory):
    """Every rank's outputs of the sharded forms (one 4-rank world)."""
    return mesh_lib.spawn(_collectives, 4, _cases(),
                          str(tmp_path_factory.mktemp("rank_zero_first")),
                          device="cpu")


def _host(kind: str):
    """The port's host forms on the whole inputs."""
    t = {k: torch.from_numpy(v) for k, v in _cases().items()}
    g = clustering.aggregate(t[f"g_{kind}_vals"], t[f"g_{kind}_slots"], C_G)
    out = {"g": (g.cluster_weights.numpy(), g.counts.numpy())}
    for form, c in (("w", C_W), ("b", C_B)):
        out[form] = mc.clustered_weighted_mean(
            t[f"{form}_{kind}_vals"], t[f"{form}_{kind}_slots"],
            t[f"{form}_{kind}_weights"], c,
            exact_products=kind == "int").numpy()
    v, cl = t[f"s_{kind}_vals"], t["s_clusters"]
    out["s"] = {w: torch.stack([
        clustering.aggregate(v[:w], cl[:w], C_S).cluster_weights[cl[i]]
        for i in range(w)]).numpy() for w in WIDTHS}
    return out


def _check(got, want, exact: bool, what: str):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype, what
    if exact:
        np.testing.assert_array_equal(got, want, err_msg=what)
    else:
        np.testing.assert_allclose(got, want, err_msg=what, **TOL)


@pytest.mark.parametrize("w", WIDTHS)
@pytest.mark.parametrize("kind", ["int", "frac"])
def test_sharded_forms_against_host_forms(world, kind, w):
    """Every rank of the W-rank group holds the same result; the gathered
    form is the host ``aggregate`` bit for bit at any values, the psum
    forms are exact on integer values at power-of-two weights and close
    elsewhere; each collective moves ``collective_payload_bytes``."""
    host = _host(kind)
    exact = kind == "int"
    pre = f"{kind}_{w}"
    ranks = [out for out in world if f"g_{pre}" in out]
    assert len(ranks) == w
    for out in ranks:
        for key in ("g", "w", "b"):
            for a, b in zip(out[f"{key}_{pre}"][:2], ranks[0][f"{key}_{pre}"]):
                np.testing.assert_array_equal(a, b)
    g_mean, g_counts, g_bytes = ranks[0][f"g_{pre}"]
    _check(g_mean, host["g"][0], True, "gathered mean")
    _check(g_counts, host["g"][1], True, "gathered counts")
    assert g_bytes == mc.collective_payload_bytes("gather", 7, 20, C_G)
    w_mean, w_total, w_bytes = ranks[0][f"w_{pre}"]
    _check(w_mean, host["w"], exact, "weighted mean")
    assert w_bytes == mc.collective_payload_bytes("psum", 8, 12, C_W)
    _check(ranks[0][f"b_{pre}"][0], host["b"], exact, "buffered mean")
    mine = np.stack([out[f"s_{pre}"] for out in ranks])
    _check(mine, host["s"][w], exact, "one client a rank")


@pytest.mark.parametrize("w", WIDTHS)
@pytest.mark.parametrize("kind", ["int", "frac"])
def test_sharded_forms_against_the_jax_sharded_forms(world, jax_side, kind,
                                                     w):
    """The same forms against the JAX package's ``shard_map`` forms at the
    same W: the gathered form bit for bit; the psum forms exact on
    integer values at power-of-two weights, within atol 1e-6 / rtol 1e-5
    elsewhere (a buffer of 7 rows divides neither W = 2 nor 4)."""
    jout, _ = jax_side()
    exact = kind == "int"
    pre = f"{kind}_{w}"
    out = world[0]
    _check(out[f"g_{pre}"][0], jout[f"g_{pre}_mean"], True, "gathered")
    _check(out[f"g_{pre}"][1], jout[f"g_{pre}_counts"], True, "counts")
    for key in ("w", "b"):
        _check(out[f"{key}_{pre}"][0], jout[f"{key}_{pre}_mean"], exact,
               f"{key} mean")
        _check(out[f"{key}_{pre}"][1], jout[f"{key}_{pre}_total"], exact,
               f"{key} total")
    mine = np.stack([o[f"s_{pre}"] for o in world if f"s_{pre}" in o])
    _check(mine, jout[f"s_{pre}"], exact, "one client a rank")


def test_rank_zero_first_finishes_rank_0_before_the_others_start(world):
    """``mesh.rank_zero_first`` (how a mesh run fills an empty data
    cache): rank 0 writes a file half a second late inside the block,
    and every other rank, reading it inside the block, finds it
    whole."""
    assert [out["rank_zero_first"] for out in world] == ["whole"] * 4


def test_payload_bytes_and_manifest_mesh_are_the_references(jax_side):
    _, meta = jax_side()
    for c in ("gather", "psum"):
        assert [mc.collective_payload_bytes(c, n, d, k) for n, d, k in (
            (7, 20, 10), (8, 12, 3), (6, 8, 10))] == meta["payload"][c]
    with pytest.raises(ValueError, match="unknown collective"):
        mc.collective_payload_bytes("ring", 1, 1, 1)
    from repro_torch.fl import obs

    class Four:
        shape = {"clients": 4}

    assert obs.build_manifest(mesh=Four())["mesh"] == meta["mesh"]
    assert obs.build_manifest()["mesh"] is None


def test_dryrun_client_scale_meters_are_the_references(jax_side, tmp_path):
    """``fed_dryrun.client_scale`` (the reference's host-side section):
    the same rows resident, the same bytes read and written, the
    round trip intact, on a 2000-client store."""
    _, meta = jax_side()
    got = fed_dryrun.client_scale(2000, 16, device="cpu",
                                  root=str(tmp_path / "store"))
    want = meta["client_scale"]
    for k in ("n_clients", "k_active", "row_bytes", "resident_rows",
              "resident_bytes", "io_read_bytes", "io_written_bytes",
              "roundtrip_ok"):
        assert got[k] == want[k], k
    assert got["roundtrip_ok"] is True


def _fail_on_rank_one(mesh):
    if mesh.rank == 1:
        raise RuntimeError("rank 1 failed")
    return mesh.rank


def test_a_failing_rank_fails_the_run():
    """``spawn(..., join=True)`` re-raises a rank's error in the caller:
    nothing catches it."""
    with pytest.raises(Exception, match="rank 1 failed"):
        mesh_lib.spawn(_fail_on_rank_one, 2, device="cpu")


def test_mesh_refusals():
    """More ranks than a host has GPUs, or a GPU mesh on a host without
    one, is refused; no rank falls back to the CPU unasked."""
    with pytest.raises(ValueError, match="mesh ranks"):
        mesh_lib.ranks_for(0, "cpu")
    assert mesh_lib.ranks_for(None, "cpu") == 1
    assert mesh_lib.ranks_for(4, "cpu") == 4
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            mesh_lib.ranks_for(2, "cuda")
        with pytest.raises(RuntimeError, match="no CUDA device"):
            fed_train.main(["--mesh", "clients:2", "--clients", "4"])
    else:
        with pytest.raises(ValueError, match="mesh devices but"):
            mesh_lib.ranks_for(torch.cuda.device_count() + 1, "cuda")


@pytest.mark.parametrize("flags, message", [
    (["--backend", "inprocess", "--mesh", "clients:2"],
     "--backend inprocess contradicts --mesh"),
    (["--mesh", "data:2"], "--mesh must be clients[:N], got 'data:2'"),
])
def test_mesh_cli_refusals(flags, message):
    """The reference's CLI refusals, message for message."""
    with pytest.raises(SystemExit) as exc:
        fed_train.main(["--device", "cpu", *flags])
    assert str(exc.value) == message


BASE = ["--device", "cpu", "--clients", "6", "--rounds", "2", "--clauses",
        "8", "--local-epochs", "1"]
MODES = {"sync_gather": [],
         "async_psum": ["--mode", "async", "--straggler", "0.5",
                        "--async-min-uploads", "2", "--buffer-capacity",
                        "5", "--collective", "psum"]}


@pytest.mark.parametrize("mode", sorted(MODES))
def test_mesh_cli_resume_equals_in_process(mode, tmp_path, capfd):
    """``fed_train --device cpu --mesh clients:4`` with a checkpoint a
    round, interrupted after round 1 and resumed: its round lines are
    the uninterrupted in-process CLI's and so are its checkpoint files,
    byte for byte.  Rank 0 alone prints and writes the telemetry (the
    manifest's ``mesh`` and ``collective_payload_bytes``), and every
    rank's aggregation moved exactly that payload a round."""
    flags = BASE + MODES[mode]
    ck = ["--ckpt-dir", str(tmp_path / "mesh"), "--ckpt-every", "1",
          "--mesh", "clients:4"]
    ref = fed_train.main(flags + ["--ckpt-dir", str(tmp_path / "ref"),
                                  "--ckpt-every", "1"])
    capfd.readouterr()
    first = fed_train.main(flags[:5] + ["1"] + flags[6:] + ck + [
        "--telemetry-dir", str(tmp_path / "tel")])
    text = capfd.readouterr().out
    assert text.count("shard_map over 4-device clients mesh") == 1
    assert sum(line.startswith("round ") for line in text.splitlines()) == 1
    manifest = json.loads((tmp_path / "tel" / "manifest.json").read_text())
    collective = "psum" if "psum" in flags else "gather"
    assert manifest["mesh"] == {"clients": 4}
    assert manifest["config"]["backend"] == "shardmap"
    assert manifest["collective_payload_bytes"] \
        == first["mesh"]["collective_payload_bytes"] \
        == mc.collective_payload_bytes(collective, 6, 8, 10)
    for meter in first["mesh"]["meter"]:
        assert meter["bytes"]["aggregate"] - meter["pad"]["aggregate"] \
            == manifest["collective_payload_bytes"]

    resumed = fed_train.main(flags + ck + ["--resume"])
    text = capfd.readouterr().out
    assert text.count("resumed from") == 1
    assert first["round_lines"] + resumed["round_lines"] \
        == ref["round_lines"]
    for r in (1, 2):
        name = f"round_{r:06d}.msgpack"
        assert (tmp_path / "mesh" / name).read_bytes() \
            == (tmp_path / "ref" / name).read_bytes(), name


def test_mesh_cli_fills_an_empty_data_dir_once(tmp_path):
    """``--mesh clients:4 --dataset mnist`` on an empty ``--data-dir``:
    rank 0 writes the IDX mirror and its sidecars before the other ranks
    read them, so the run is the in-process CLI's on its own fresh cache,
    round lines and every cache file (sidecars included) byte for
    byte."""
    flags = ["--device", "cpu", "--dataset", "mnist", "--clients", "4",
             "--rounds", "1", "--clauses", "8", "--local-epochs", "1"]
    ref = fed_train.main(flags + ["--data-dir", str(tmp_path / "ref")])
    out = fed_train.main(flags + ["--data-dir", str(tmp_path / "mesh"),
                                  "--mesh", "clients:4"])
    assert out["round_lines"] == ref["round_lines"]
    files = sorted(p.relative_to(tmp_path / "ref")
                   for p in (tmp_path / "ref").rglob("*") if p.is_file())
    assert any(f.name.endswith(".sha256") for f in files)
    assert files == sorted(p.relative_to(tmp_path / "mesh")
                           for p in (tmp_path / "mesh").rglob("*")
                           if p.is_file())
    for f in files:
        assert (tmp_path / "mesh" / f).read_bytes() \
            == (tmp_path / "ref" / f).read_bytes(), f


def test_backend_shardmap_without_mesh_takes_every_visible_device(capfd):
    """``--backend shardmap`` without ``--mesh`` is ``--mesh clients``,
    every visible device: on the CPU that is one ``gloo`` rank, and the
    run is the in-process run."""
    flags = ["--device", "cpu", "--clients", "4", "--rounds", "1",
             "--clauses", "8", "--local-epochs", "1"]
    ref = fed_train.main(flags)
    capfd.readouterr()
    out = fed_train.main(flags + ["--backend", "shardmap"])
    assert "shard_map over 1-device clients mesh (gather)" \
        in capfd.readouterr().out
    assert out["round_lines"] == ref["round_lines"]
    assert (out["mesh"]["ranks"], out["mesh"]["backend"],
            out["mesh"]["devices"]) == (1, "gloo", ["cpu"])

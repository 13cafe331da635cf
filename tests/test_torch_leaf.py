"""The LEAF half of the data path against the JAX package, on the CPU.

* ``data/ingest/leaf.py`` and ``fetch.py`` are the reference's code
  below their docstrings; the LEAF mirror writes the reference's shard,
  index and sidecar bytes (``synthfemnist`` side 8, 600 samples, 12
  writers, seeds 0 and 6); ``read_shards`` / ``read_index`` /
  ``ensure_index`` / ``read_writers`` return the reference's values and
  refuse what it refuses;
* ``registry.load`` gives the reference's writer-tagged ``Pool`` (x, y,
  writers) for ``synthfemnist`` and ``femnist``, and ``load_stream`` its
  ``StreamPool``; ``natural.partition_writers`` its ``ClientData`` bit
  for bit (padded clients, a single-sample client, too few writers);
* ``fetch`` verifies and places files through ``file://`` URLs only:
  nothing is downloaded;
* a 62-class TPFL federation on the writer split equals the JAX engine
  bit for bit, sync and async on float32 and sync on int8 (non-integer
  uploads, summed in XLA's four-lane order: ROADMAP queue C item 4),
  and ``fed_train --dataset synthfemnist --data-dir`` prints the
  reference CLI's round lines;
* the full-width FEMNIST scenario ``chip_smoke.py`` path (G) runs (20
  writer-natural clients at 28x28) has the live reference's pool and
  ClientData digests, the constants the card's run is held to."""
import ast
import importlib.util
import json
import re
import shutil
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import tm as jtm
from repro.data.ingest import fetch as jfetch
from repro.data.ingest import leaf as jleaf
from repro.data.ingest import natural as jnatural
from repro.data.ingest import registry as jregistry
from repro.fl.runtime import CodecConfig as JCodecConfig
from repro.fl.runtime import Engine as JEngine
from repro.fl.runtime import RuntimeConfig as JRuntimeConfig
from repro.fl.runtime import TPFLStrategy as JTPFLStrategy
from repro.fl.store import StreamingClientData as JStreamingClientData
from repro.launch import fed_train as jfed_train
from repro_torch import convert
from repro_torch import random as tr
from repro_torch.core import clustering
from repro_torch.core import tm as ttm
from repro_torch.data import partition
from repro_torch.data.ingest import fetch, idx, leaf, mirror, natural, registry
from repro_torch.fl.runtime import (CodecConfig, Engine, RuntimeConfig,
                                    SchedulerConfig, TPFLStrategy)
from repro_torch.fl.store import StreamingClientData
from repro_torch.launch import fed_train
from test_torch_data import _same_client_data
from test_torch_gpu import one_torch_thread  # noqa: F401
from test_torch_round import _report_lines, _same, _same_reports, _same_state

ROOT = Path(__file__).resolve().parents[1]
SEEDS = (0, 6)
MIRROR = dict(n_samples=600, side=8, n_writers=12)


def _files(root: Path) -> dict:
    return {p.name: p.read_bytes() for p in sorted(root.iterdir())}


@pytest.fixture(scope="module")
def mirrors(tmp_path_factory):
    """Each package's ``synthfemnist`` mirror per seed, written by its
    registry under ``<root>/<who><seed>/synthfemnist``."""
    root = tmp_path_factory.mktemp("leaf")
    for seed in SEEDS:
        jregistry.load("synthfemnist", root / f"jax{seed}", seed=seed,
                       **MIRROR)
        registry.load("synthfemnist", root / f"port{seed}", seed=seed,
                      device="cpu", **MIRROR)
    return root


def _dirs(mirrors, seed, name="synthfemnist"):
    return mirrors / f"jax{seed}" / name, mirrors / f"port{seed}" / name


# -- the modules copied ------------------------------------------------------

def _body(path: Path) -> list[str]:
    """The module below its docstring, without the import of ``idx``
    (each package imports its own)."""
    tree = ast.parse(path.read_text())
    return [ast.dump(n) for n in tree.body[1:]
            if not (isinstance(n, ast.ImportFrom) and n.module
                    and n.module.endswith("data.ingest"))]


@pytest.mark.parametrize("name", ["leaf", "fetch"])
def test_module_is_the_references_code(name):
    ours = ROOT / "src" / "repro_torch" / "data" / "ingest" / f"{name}.py"
    ref = ROOT / "src" / "repro" / "data" / "ingest" / f"{name}.py"
    assert _body(ours) == _body(ref)


# -- the mirror and the shard readers ---------------------------------------

@pytest.mark.parametrize("seed", SEEDS)
def test_mirror_files_byte_identical(mirrors, seed):
    """12 writers, 10 to a shard: two shards, the index and three
    sidecars, each file the reference's bytes."""
    jdir, pdir = _dirs(mirrors, seed)
    got, want = _files(pdir), _files(jdir)
    assert sorted(got) == sorted(want) == [
        "all_data_0.json", "all_data_0.json.sha256", "all_data_1.json",
        "all_data_1.json.sha256", "index.json", "index.json.sha256"]
    assert got == want


@pytest.mark.parametrize("seed", SEEDS)
def test_shard_readers_equal_the_reference(mirrors, seed, tmp_path):
    jdir, pdir = _dirs(mirrors, seed)
    ours, ref = leaf.read_shards(pdir), jleaf.read_shards(jdir)
    assert ours.users == ref.users and len(ours.users) == 12
    for f in ("x", "y", "writers"):
        a, b = getattr(ours, f), getattr(ref, f)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert leaf.read_index(pdir) == jleaf.read_index(jdir)
    wids = [11, 0, 7, 3, 7]
    got, want = leaf.read_writers(pdir, wids), jleaf.read_writers(jdir, wids)
    assert sorted(got) == sorted(want) == [0, 3, 7, 11]
    for w in want:
        for a, b in zip(got[w], want[w]):
            np.testing.assert_array_equal(a, b)
    for mod, d in ((leaf, pdir), (jleaf, jdir)):
        with pytest.raises(ValueError, match="out of range"):
            mod.read_writers(d, [12])
    # a deleted index is rebuilt to the same bytes by each package
    for who, (mod, d) in {"port": (leaf, pdir), "jax": (jleaf, jdir)}.items():
        copy = tmp_path / who
        shutil.copytree(d, copy)
        for name in (leaf.INDEX_NAME, leaf.INDEX_NAME + ".sha256"):
            (copy / name).unlink()
        assert mod.ensure_index(copy) == mod.read_index(d)
    assert _files(tmp_path / "port") == _files(tmp_path / "jax") \
        == _files(pdir)


def _malformed(mod, root: Path, case: str) -> None:
    users = ["wa", "wb"]
    xs = [np.zeros((2, 4), np.float32), np.ones((3, 4), np.float32)]
    ys = [np.zeros(2, np.int32), np.ones(3, np.int32)]
    mod.write_shards(root, users, xs, ys)
    path = root / "all_data_0.json"
    shard = json.loads(path.read_text())
    if case == "missing_user":
        shard = dict(shard, user_data={"wa": shard["user_data"]["wa"]})
    elif case == "lying_count":
        shard = dict(shard, num_samples=[2, 99])
    elif case == "count_length":
        shard = dict(shard, num_samples=[2])
    elif case == "no_users":
        shard = {k: v for k, v in shard.items() if k != "users"}
    elif case == "ragged":
        shard["user_data"]["wb"]["y"] = [1, 1]
    path.write_text(json.dumps(shard))
    idx.write_checksum(path)


@pytest.mark.parametrize("case,match", [
    ("missing_user", "missing from"), ("lying_count", "declares"),
    ("count_length", "entries"), ("no_users", "missing key"),
    ("ragged", "has x")])
def test_malformed_shards_rejected(tmp_path, case, match):
    """As the reference's ``test_leaf_malformed_shards_rejected``: each
    package refuses the same malformed shard with the same message."""
    msgs = []
    for who, mod in (("port", leaf), ("jax", jleaf)):
        root = tmp_path / who
        _malformed(mod, root, case)
        with pytest.raises(mod.LeafFormatError, match=match) as exc:
            mod.read_shards(root)
        msgs.append(str(exc.value).replace(str(root), "ROOT"))
    assert msgs[0] == msgs[1]


def test_stale_index_and_checksums_are_refused(mirrors, tmp_path):
    """A shard set that drifted under its index is refused by name, and
    a tampered shard by its sidecar, in both packages."""
    jdir, pdir = _dirs(mirrors, 0)
    for who, (mod, d) in {"port": (leaf, pdir), "jax": (jleaf, jdir)}.items():
        root = tmp_path / who
        shutil.copytree(d, root)
        src, dup = root / "all_data_1.json", root / "all_data_2.json"
        shutil.copy(src, dup)
        with pytest.raises(mod.LeafFormatError, match="stale"):
            mod.read_index(root)
        raw = bytearray(src.read_bytes())
        raw[-2] ^= 0x01
        src.write_bytes(bytes(raw))
        with pytest.raises(ValueError, match="checksum mismatch"):
            mod.read_shards(root)
    with pytest.raises(FileNotFoundError, match="no LEAF shards"):
        leaf.read_shards(tmp_path / "empty")


# -- the registry ------------------------------------------------------------

def _same_pool(ref, ours):
    assert (ours.n_classes, ours.n_features, ours.name) == (
        ref.n_classes, ref.n_features, ref.name)
    for f in ("x", "y", "writers"):
        a, b = np.asarray(getattr(ref, f)), getattr(ours, f).numpy()
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("encoding", ["bool", "thermometer:3", "quantile:2"])
def test_synthfemnist_pool_bit_identical(mirrors, seed, encoding):
    """The mirror's files (written once) read back through each
    registry, encoded: the same bits, labels and writer ids."""
    kw = dict(MIRROR, seed=seed, encoding=encoding)
    ref = jregistry.load("synthfemnist", mirrors / f"jax{seed}", **kw)
    ours = registry.load("synthfemnist", mirrors / f"port{seed}",
                         device="cpu", **kw)
    assert ours.writers is not None and ours.n_classes == 62
    _same_pool(ref, ours)


def test_femnist_pool_bit_identical(tmp_path):
    """``femnist`` at its native side 28 (784 features), 400 samples of
    9 writers: shards and pool the reference's; a second load reads the
    files the first wrote, whatever the mirror arguments."""
    kw = dict(n_samples=400, seed=3, n_writers=9)
    ref = jregistry.load("femnist", tmp_path / "jax", **kw)
    ours = registry.load("femnist", tmp_path / "port", device="cpu", **kw)
    assert ours.n_features == 784 and int(ours.writers.max()) == 8
    _same_pool(ref, ours)
    assert _files(tmp_path / "port" / "femnist") \
        == _files(tmp_path / "jax" / "femnist")
    again = registry.load("femnist", tmp_path / "port", n_samples=50,
                          seed=9, n_writers=3, device="cpu")
    assert torch.equal(again.x, ours.x) and torch.equal(again.writers,
                                                        ours.writers)


def _encoder_fields(enc) -> tuple:
    return type(enc).__name__, sorted(vars(enc).items())


@pytest.mark.parametrize("encoding", ["bool", "bool:0.3", "thermometer:3"])
def test_stream_pool_fields_equal(mirrors, encoding):
    """``load_stream`` over the mirror's files: the writer table (names
    and per-writer counts from the index), the classes, the encoded
    width and the encoder are the reference's."""
    ref = jregistry.load_stream("synthfemnist", mirrors / "jax6",
                                encoding=encoding)
    ours = registry.load_stream("synthfemnist", mirrors / "port6",
                                encoding=encoding, device="cpu")
    assert ours.root == mirrors / "port6" / "synthfemnist"
    for f in ("users", "writer_sizes", "n_classes", "n_features", "name",
              "verify"):
        assert getattr(ours, f) == getattr(ref, f), f
    assert len(ours.users) == 12 and min(ours.writer_sizes) >= 4
    assert _encoder_fields(ours.encoder) == _encoder_fields(ref.encoder)


def test_stream_pool_refusals_and_index_rebuild(mirrors, tmp_path):
    """Quantile needs the pool, IDX kinds and a missing data dir are
    refused, as in the reference; a missing index is rebuilt, and an
    empty cache is mirrored."""
    for mod, kw in ((registry, dict(device="cpu")), (jregistry, {})):
        with pytest.raises(ValueError, match="needs the pool"):
            mod.load_stream("synthfemnist", mirrors / "jax0",
                            encoding="quantile:2", **kw)
        with pytest.raises(ValueError, match="idx"):
            mod.load_stream("mnist", tmp_path, **kw)
        with pytest.raises(ValueError, match="file-backed"):
            mod.load_stream("femnist", None, **kw)
    copy = tmp_path / "copy" / "synthfemnist"
    shutil.copytree(mirrors / "port0" / "synthfemnist", copy)
    (copy / leaf.INDEX_NAME).unlink()
    (copy / (leaf.INDEX_NAME + ".sha256")).unlink()
    rebuilt = registry.load_stream("synthfemnist", tmp_path / "copy",
                                   device="cpu")
    assert rebuilt.writer_sizes == jregistry.load_stream(
        "synthfemnist", mirrors / "jax0").writer_sizes
    fresh = registry.load_stream("synthfemnist", tmp_path / "fresh",
                                 seed=6, device="cpu", **MIRROR)
    assert _files(tmp_path / "fresh" / "synthfemnist") \
        == _files(mirrors / "jax6" / "synthfemnist")
    assert fresh.users == rebuilt.users


# -- the writer split --------------------------------------------------------

def _tiny_pools(sizes, f=12, n_classes=5, seed=9):
    """Each package's writer-tagged pool of writers of ``sizes`` rows
    (distinct float rows, so a row's bytes name it)."""
    rng = np.random.default_rng(seed)
    xs = [rng.random((n, f)).astype(np.float32) for n in sizes]
    ys = [rng.integers(0, n_classes, n).astype(np.int32) for n in sizes]
    x, y = np.concatenate(xs), np.concatenate(ys)
    w = np.concatenate([np.full(n, i, np.int32) for i, n in
                        enumerate(sizes)])
    ref = jregistry.Pool(x=jnp.asarray(x), y=jnp.asarray(y),
                         writers=jnp.asarray(w), n_classes=n_classes,
                         n_features=f, name="tiny")
    ours = registry.Pool(x=torch.from_numpy(x), y=torch.from_numpy(y),
                         writers=torch.from_numpy(w), n_classes=n_classes,
                         n_features=f, name="tiny")
    return ref, ours


SPLITS = {  # pool, n_clients, n_train / n_test / n_conf, key
    "mirror_5": ("mirror", 5, (24, 8, 8), 0),
    "mirror_12": ("mirror", 12, (16, 8, 8), 1),
    "mirror_2": ("mirror", 2, (80, 40, 40), 7),
    "padded": ((3, 5, 4, 30, 3, 6), 6, (16, 8, 8), 2),
    "single_sample": ((1, 7, 2, 40, 1), 5, (6, 3, 3), 3),
    "grouped": ((1, 1, 2, 9, 4, 4, 30), 3, (8, 4, 4), 4),
}


@pytest.mark.parametrize("case", SPLITS)
def test_partition_writers_bit_identical(mirrors, case):
    """The mirror's pool over 2, 5 and all 12 writers' clients, and
    hand-made pools whose clients are padded by wraparound, hold one
    sample, or group several writers: every field, ``sizes`` (the real
    per-writer counts) and ``mixtures`` (float64 histograms cast to
    float32) included."""
    pool, n_clients, (n_train, n_test, n_conf), seed = SPLITS[case]
    if pool == "mirror":
        ref = jregistry.load("synthfemnist", mirrors / "jax6", **MIRROR)
        ours = registry.load("synthfemnist", mirrors / "port6",
                             device="cpu", **MIRROR)
    else:
        ref, ours = _tiny_pools(pool)
    kw = dict(n_clients=n_clients, n_train=n_train, n_test=n_test,
              n_conf=n_conf)
    want = jnatural.partition_writers(ref, key=jax.random.PRNGKey(seed),
                                      **kw)
    got = natural.partition_writers(ours, key=tr.PRNGKey(seed, "cpu"), **kw)
    _same_client_data(want, got)
    assert int(got.sizes.sum()) == ours.x.shape[0]
    via = natural.partition_pool(ours, key=tr.PRNGKey(seed, "cpu"),
                                 experiment=2, **kw)
    assert partition.sha256(via) == partition.sha256(got)


def test_partition_writers_refusals(mirrors):
    ref = jregistry.load("synthfemnist", mirrors / "jax6", **MIRROR)
    ours = registry.load("synthfemnist", mirrors / "port6", device="cpu",
                         **MIRROR)
    kw = dict(n_clients=13, n_train=4, n_test=2, n_conf=2)
    msgs = []
    for mod, pool, key in ((jnatural, ref, jax.random.PRNGKey(0)),
                           (natural, ours, tr.PRNGKey(0, "cpu"))):
        with pytest.raises(ValueError, match="12 writers cannot fill") as e:
            mod.partition_writers(pool, key=key, **kw)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]
    plain = registry.load("synthmnist", n_samples=50, side=8, device="cpu")
    with pytest.raises(ValueError, match="no writer identities"):
        natural.partition_writers(plain, n_clients=2, n_train=4, n_test=2,
                                  n_conf=2, key=tr.PRNGKey(0, "cpu"))


# -- streaming cohorts (StreamingClientData) ----------------------------------

STREAMS = {  # n_clients, cohort ids, encoding, n_train / n_test / n_conf
    "le_writers": (5, [4, 0, 2], "bool", (24, 8, 8)),
    "all_writers": (12, [11, 3, 7, 0], "thermometer:3", (16, 8, 8)),
    "cyclic": (30, [29, 3, 15, 12, 0, 3], "bool", (16, 8, 8)),
}


def _streams(mirrors, case, seed=4):
    n, ids, encoding, (n_train, n_test, n_conf) = STREAMS[case]
    kw = dict(n_clients=n, n_train=n_train, n_test=n_test, n_conf=n_conf)
    ref = JStreamingClientData(
        jregistry.load_stream("synthfemnist", mirrors / "jax6",
                              encoding=encoding),
        key=jax.random.PRNGKey(seed), **kw)
    ours = StreamingClientData(
        registry.load_stream("synthfemnist", mirrors / "port6",
                             encoding=encoding, device="cpu"),
        key=tr.PRNGKey(seed, "cpu"), device="cpu", **kw)
    return ref, ours, np.asarray(ids), kw, encoding


@pytest.mark.parametrize("case", STREAMS)
def test_streaming_gather_equals_the_reference(mirrors, case):
    """``gather_clients(ids)`` equals the JAX one field for field, over
    fewer clients than writers (contiguous writer groups), one a writer
    and more clients than writers (cyclic), with repeated ids; the
    ``sizes`` table too.  Up to the writer count the rows are the port's
    ``partition_writers`` rows of the materialized pool, and the live
    reference's."""
    ref, ours, ids, kw, encoding = _streams(mirrors, case)
    np.testing.assert_array_equal(ours.sizes, ref.sizes)
    assert ours.sizes.dtype == np.int64 and ours.device.type == "cpu"
    got = ours.gather_clients(ids)
    _same_client_data(ref.gather_clients(ids), got)
    if kw["n_clients"] <= 12:
        pool = registry.load("synthfemnist", mirrors / "port6",
                             encoding=encoding, device="cpu", **MIRROR)
        full = natural.partition_writers(pool, key=tr.PRNGKey(4, "cpu"),
                                         **kw)
        jfull = jnatural.partition_writers(
            jregistry.load("synthfemnist", mirrors / "jax6",
                           encoding=encoding, **MIRROR),
            key=jax.random.PRNGKey(4), **kw)
        _same_client_data(jfull, full)
        for f, a in zip(full._fields, full):
            assert torch.equal(getattr(got, f), a[torch.as_tensor(ids)]), f
        np.testing.assert_array_equal(ours.sizes, full.sizes.numpy())


def test_streaming_parses_only_the_cohorts_shards(mirrors, monkeypatch):
    """A spy on the shard reader: a cohort whose writers all live in the
    first shard parses that shard alone; adding a client of the last
    writer parses the second too; the constructor parses none."""
    parsed = []
    real = leaf._parse_shard

    def spy(path, verify=True):
        parsed.append(Path(path).name)
        return real(path, verify)

    monkeypatch.setattr(leaf, "_parse_shard", spy)
    _, ours, _, _, _ = _streams(mirrors, "cyclic")
    assert parsed == []
    ours.gather_clients([0, 3, 15])           # writers 0, 3, 3
    assert parsed == ["all_data_0.json"]
    parsed.clear()
    ours.gather_clients([0, 23])              # writers 0, 11
    assert parsed == ["all_data_0.json", "all_data_1.json"]
    with pytest.raises(ValueError, match="out of range"):
        ours.gather_clients([30])


def test_streaming_data_needs_the_store(mirrors):
    """The resident engine refuses a streamed population with the
    reference's message; the mmap engine takes its size, device and
    weighted-sampling table from it."""
    ref, ours, _, _, _ = _streams(mirrors, "cyclic")
    jstrat = JTPFLStrategy(jtm.TMConfig(n_classes=62, n_clauses=8,
                                        n_features=64, n_states=63, s=5.0,
                                        T=10), local_epochs=1)
    tstrat = TPFLStrategy(ttm.TMConfig(n_classes=62, n_clauses=8,
                                       n_features=64, n_states=63, s=5.0,
                                       T=10), local_epochs=1)
    msgs = []
    for eng, strat, data, cfg in (
            (JEngine, jstrat, ref, JRuntimeConfig), (Engine, tstrat, ours,
                                                     RuntimeConfig)):
        with pytest.raises(ValueError, match="streaming client data") as e:
            eng(strat, data, cfg(rounds=1))
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]
    eng = Engine(tstrat, ours, RuntimeConfig(
        rounds=1, client_store="mmap",
        scheduler=SchedulerConfig(participation=0.1, sampling="weighted")))
    assert eng.n == 30 and eng.device.type == "cpu"
    assert torch.equal(eng.scheduler.p, torch.as_tensor(
        ours.sizes, dtype=torch.float32) / float(ours.sizes.sum()))


STREAM_FLAGS = ["--dataset", "synthfemnist", "--writers", "8", "--n-clients",
                "20", "--active", "4", "--client-store", "mmap",
                "--store-eval", "sampled", "--sampling", "weighted",
                "--clauses", "8", "--local-epochs", "1", "--rounds", "2"]


def test_fed_train_streaming_prints_the_reference_lines(tmp_path, capsys):
    """``fed_train --n-clients 20 --client-store mmap --store-eval
    sampled`` over 8 writers (cyclic) on the CPU: the JAX CLI's round,
    totals, weighted-sampling, store and decile lines, and its dict
    (accuracies, bytes, store bytes); the store directories hold the
    same bytes.  The reference's refusals are kept."""
    flags = STREAM_FLAGS + ["--data-dir"]
    ours = fed_train.main(["--device", "cpu", *flags, str(tmp_path / "p"),
                           "--store-dir", str(tmp_path / "ps")])
    port_text = capsys.readouterr().out
    ref = jfed_train.main([*flags, str(tmp_path / "j"), "--store-dir",
                           str(tmp_path / "js")])
    ref_text = capsys.readouterr().out
    assert "streamed (8 writers, cyclic)" in port_text
    keep = ("client store:",)
    lines = [ln for ln in port_text.splitlines() if ln.startswith(keep)]
    assert lines == [ln for ln in ref_text.splitlines()
                     if ln.startswith(keep)] and len(lines) == 1
    assert _report_lines(port_text) == _report_lines(ref_text)
    np.testing.assert_allclose(ours["acc_per_round"], ref["acc_per_round"],
                               rtol=0, atol=1e-6)
    for f in ("upload_bytes", "download_bytes_broadcast",
              "download_bytes_per_client", "store_read_bytes",
              "store_written_bytes"):
        assert ours[f] == ref[f], f
    assert ours["store_written_bytes"] > 0
    assert _files(tmp_path / "ps") == _files(tmp_path / "js")
    for extra, match in ((["--client-store", "resident"], "requires"),
                         (["--strategy", "flis_dc"], "probe set")):
        with pytest.raises(SystemExit, match=match):
            fed_train.main(["--device", "cpu", *flags, str(tmp_path / "p"),
                            *extra])
    with pytest.raises(SystemExit, match="needs --data-dir"):
        fed_train.main(["--device", "cpu", *STREAM_FLAGS])


# -- fetch, through file:// URLs only ----------------------------------------

def test_fetch_constants_are_the_references():
    assert fetch.ARCHIVES == jfetch.ARCHIVES
    assert (fetch.MNIST_BASES, fetch.FASHION_BASES) == (
        jfetch.MNIST_BASES, jfetch.FASHION_BASES)


def _staged(root: Path, seed: int = 0, sidecars: bool = False) -> Path:
    mirror.write_idx_mirror(root, "synthmnist", 40, 8, seed, device="cpu")
    if not sidecars:
        for f in root.glob("*.sha256"):
            f.unlink()                  # a raw download has no sidecar
    return root


def test_fetch_place_verifies_then_lands_in_the_cache(tmp_path):
    staging = _staged(tmp_path / "staging")
    cache = tmp_path / "cache"
    for name in (mirror.IMAGES_FILE, mirror.LABELS_FILE):
        src = staging / name
        dest = fetch.place(src, cache, "synthmnist", name,
                           expect=fetch.sha256_path(src))
        assert dest.exists() and idx.checksum_path(dest).exists()
        assert not src.exists()
    pool = registry.load("synthmnist", cache, side=8, n_samples=40,
                         device="cpu")
    assert pool.x.shape[0] == 40


def test_fetch_wrong_digest_places_nothing(tmp_path):
    src = _staged(tmp_path / "staging") / mirror.IMAGES_FILE
    with pytest.raises(fetch.FetchError, match="sha256 mismatch"):
        fetch.place(src, tmp_path / "cache", "synthmnist",
                    mirror.IMAGES_FILE, expect="0" * 64)
    assert not (tmp_path / "cache" / "synthmnist").exists() and src.exists()


def test_fetch_refuses_to_overwrite_cache_files(tmp_path):
    _staged(tmp_path / "mnist", sidecars=True)
    src = _staged(tmp_path / "staging", seed=1) / mirror.IMAGES_FILE
    with pytest.raises(fetch.FetchError, match="refusing to overwrite"):
        fetch.place(src, tmp_path, "mnist", mirror.IMAGES_FILE,
                    expect=fetch.sha256_path(src))


def test_fetch_through_file_urls(tmp_path, monkeypatch):
    """The whole fetch (copy from a ``file://`` URL, the pinned digest,
    placement) with the pins swapped for the staged files' digests; a
    second call finds every file in place and fetches nothing."""
    staging = _staged(tmp_path / "staging")
    urls = {f.name: f.as_uri() for f in sorted(staging.glob("*.gz"))}
    digests = {n: fetch.sha256_path(staging / n) for n in urls}
    monkeypatch.setitem(fetch.ARCHIVES, "mnist", digests)
    placed = fetch.fetch("mnist", tmp_path / "cache", urls=urls)
    assert sorted(p.name for p in placed) == sorted(digests)
    for p in placed:
        assert p.parent == tmp_path / "cache" / "mnist"
        fetch.verify_file(p, digests[p.name])
    assert fetch.fetch("mnist", tmp_path / "cache", urls=urls) == []
    bad = dict(urls, **{mirror.LABELS_FILE: (tmp_path / "nope").as_uri()})
    monkeypatch.setitem(fetch.ARCHIVES, "mnist", dict(
        digests, **{mirror.LABELS_FILE: "1" * 64}))
    (tmp_path / "cache" / "mnist" / mirror.LABELS_FILE).unlink()
    with pytest.raises(fetch.FetchError, match="could not download"):
        fetch.fetch("mnist", tmp_path / "cache", urls=bad)


def test_fetch_refusals(tmp_path):
    """No pinned archive for the LEAF kinds; a mirror stand-in under an
    archive's name is never taken for the real file (the check runs
    before any download, so nothing is fetched)."""
    with pytest.raises(ValueError, match="femnist"):
        fetch.fetch("femnist", tmp_path)
    _staged(tmp_path / "mnist", sidecars=True)
    with pytest.raises(fetch.FetchError, match="stand-in"):
        fetch.fetch("mnist", tmp_path, urls={})


# -- 62 classes through the engine and the CLI ------------------------------

TM62 = dict(n_classes=62, n_clauses=16, n_states=63, s=5.0, T=40)
CASES_62 = {
    "sync_float32": dict(),
    "async_float32": dict(aggregation="async", async_min_uploads=2,
                          buffer_capacity=8),
    "sync_int8": dict(codec="int8"),
}


@pytest.fixture(scope="module")
def populations_62(mirrors):
    """Each package's 8 writer-natural clients of the seed-6 mirror."""
    kw = dict(n_clients=8, n_train=24, n_test=8, n_conf=8)
    ref = jregistry.load("synthfemnist", mirrors / "jax6", **MIRROR)
    ours = registry.load("synthfemnist", mirrors / "port6", device="cpu",
                         **MIRROR)
    return (jnatural.partition_writers(ref, key=jax.random.PRNGKey(1), **kw),
            natural.partition_writers(ours, key=tr.PRNGKey(1, "cpu"), **kw),
            ours.n_features)


@pytest.mark.parametrize("case", CASES_62)
def test_62_class_rounds_bit_identical(populations_62, case):
    """Two TPFL rounds at 62 classes (one cluster a class; the vote's
    62-lane sums take XLA's windowed order) on 8 writer-natural clients:
    every report field, the client state, the server rows and the
    buffer's lanes, bit for bit.  On int8 the decoded uploads are
    ``q·scale``, not integers, and the sync mean adds the 8 rows of 16
    features into 62 clusters in XLA's four lanes (the order itself is
    held on lossy rows, three and more to a cluster, by
    ``tests/test_torch_codec.py``)."""
    jdata, tdata, n_features = populations_62
    kw = dict(CASES_62[case])
    wire = {"name": kw.pop("codec")} if "codec" in kw else {}
    jeng = JEngine(JTPFLStrategy(jtm.TMConfig(n_features=n_features, **TM62),
                                 local_epochs=2), jdata,
                   JRuntimeConfig(rounds=2, codec=JCodecConfig(**wire),
                                  **kw))
    teng = Engine(TPFLStrategy(ttm.TMConfig(n_features=n_features, **TM62),
                               local_epochs=2), tdata,
                  RuntimeConfig(rounds=2, codec=CodecConfig(**wire), **kw))
    jstate, jreps = jeng.run(jax.random.PRNGKey(3))
    tstate, treps = teng.run(convert.key_from_numpy(jax.random.PRNGKey(3),
                                                    "cpu"))
    _same_reports(jreps, treps)
    _same_state(jstate, tstate)
    for lane in convert.BUF_LANES:
        _same(getattr(jstate, lane), getattr(tstate, lane))
    if wire:
        slots = tstate.server.slots
        assert bool((slots != slots.round()).any())      # non-integers
        assert clustering.four_lanes(62, 8, 16)


def test_fed_train_synthfemnist_prints_the_reference_lines(tmp_path, capsys):
    """``--dataset synthfemnist --data-dir`` with ``--writers``: each
    CLI writes its own mirror (the same bytes) and prints the same round,
    totals, weighted-sampling and decile lines; the banner names the
    writer-natural split."""
    flags = ["--dataset", "synthfemnist", "--clients", "6", "--writers",
             "8", "--clauses", "16", "--rounds", "2", "--local-epochs", "1",
             "--sampling", "weighted", "--participation", "0.5"]
    ours = fed_train.main(["--device", "cpu", "--data-dir",
                           str(tmp_path / "port"), *flags])
    port_text = capsys.readouterr().out
    ref = jfed_train.main(["--data-dir", str(tmp_path / "jax"), *flags])
    ref_text = capsys.readouterr().out
    assert "writer-natural" in port_text and "writer-natural" in ref_text
    assert _report_lines(port_text) == _report_lines(ref_text)
    assert len(_report_lines(port_text)) == 2 + 2 + 1
    np.testing.assert_allclose(ours["acc_per_round"], ref["acc_per_round"],
                               rtol=0, atol=1e-6)
    assert _files(tmp_path / "port" / "synthfemnist") \
        == _files(tmp_path / "jax" / "synthfemnist")
    index = json.loads((tmp_path / "port" / "synthfemnist" /
                        leaf.INDEX_NAME).read_text())
    assert sum(len(s["users"]) for s in index["shards"]) == 8


# -- the full-width FEMNIST scenario (chip_smoke.py path G) -----------------

def _chip_smoke():
    path = ROOT / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_full_width_femnist_scenario_digests(tmp_path):
    """Path (G)'s scenario: ``femnist`` (28x28) through the LEAF mirror,
    25 writers (``max(25, 20)``), 20 writer-natural clients of 80 / 40 /
    40, drawn by each package from seed 0: the pools and ClientData are
    bit for bit the same, and their digests are the constants
    chip_smoke.py holds the card's draw to."""
    jpool, jdata, *_ = jfed_train.build_scenario(
        dataset="femnist", data_dir=str(tmp_path / "jax"), clients=20,
        clauses=8)
    ours, cfg, _, _ = fed_train.build_scenario(
        dataset="femnist", data_dir=str(tmp_path / "port"), clients=20,
        clauses=8, device="cpu")
    assert cfg.n_classes == 62 and cfg.n_features == 1568 // 2
    _same_client_data(jdata, ours)
    pool = registry.load("femnist", tmp_path / "port", device="cpu")
    _same_pool(jpool, pool)
    smoke = _chip_smoke()
    assert registry.sha256(pool) == registry.sha256(jpool) \
        == smoke.FEMNIST_POOL_SHA256
    assert partition.sha256(ours) == partition.sha256(jdata) \
        == smoke.FEMNIST_SHA256
    assert re.fullmatch(r"[0-9a-f]{64}", smoke.FEMNIST_SHA256)

"""The port's ingestion is the reference's: the IDX codec copy writes
the same bytes; the offline mirror writes byte-identical IDX files and
``.sha256`` sidecars; ``registry.load`` gives the same pool bits for
every encoding, from the mirror, from a real-style drop-in (grayscale
train and t10k pairs) and from the in-memory fallback; the LEAF kinds
are refused with the ROADMAP item that brings them."""
import pathlib

import numpy as np
import pytest
import torch

from repro.data.ingest import encode as jencode
from repro.data.ingest import idx as jidx
from repro.data.ingest import mirror as jmirror
from repro.data.ingest import registry as jregistry
from repro_torch import random as tr
from repro_torch.data.ingest import encode, idx, mirror, natural, registry
from repro_torch.launch import fed_train
from test_torch_gpu import one_torch_thread  # noqa: F401

ENCODINGS = ["bool", "bool:0.3", "thermometer:3", "quantile:3"]


def _files(root: pathlib.Path) -> dict:
    return {p.name: p.read_bytes() for p in sorted(root.iterdir())}


@pytest.mark.parametrize("dtype", ["u1", "i1", ">i2", ">i4", ">f4", ">f8"])
def test_idx_codec_bytes_equal_the_reference(dtype):
    rng = np.random.default_rng(0)
    a = (rng.standard_normal((3, 4, 5)) * 100).astype(np.dtype(dtype)
                                                      .newbyteorder("="))
    assert idx.encode(a) == jidx.encode(a)
    np.testing.assert_array_equal(idx.decode(idx.encode(a)), a)


@pytest.mark.parametrize("flavour,side", [("synthmnist", 12),
                                          ("synthfashion", 12),
                                          ("synthmnist", 28)])
def test_mirror_files_byte_identical(tmp_path, flavour, side):
    mirror.write_idx_mirror(tmp_path / "port", flavour, 300, side, 4,
                            device="cpu")
    jmirror.write_idx_mirror(tmp_path / "jax", flavour, 300, side, 4)
    got, want = _files(tmp_path / "port"), _files(tmp_path / "jax")
    assert sorted(got) == sorted(want) == [
        mirror.IMAGES_FILE, mirror.IMAGES_FILE + ".sha256",
        mirror.LABELS_FILE, mirror.LABELS_FILE + ".sha256"]
    assert got == want


def _same_pool(ref, ours):
    assert (ours.n_classes, ours.n_features, ours.name) == (
        ref.n_classes, ref.n_features, ref.name)
    assert ours.writers is None and ref.writers is None
    assert ours.x.dtype == torch.uint8 and ours.y.dtype == torch.int32
    np.testing.assert_array_equal(ours.x.numpy(), np.asarray(ref.x))
    np.testing.assert_array_equal(ours.y.numpy(), np.asarray(ref.y))


@pytest.mark.parametrize("encoding", ENCODINGS)
@pytest.mark.parametrize("name,data_dir", [("mnist", True),
                                           ("synthfashion", True),
                                           ("synthmnist", False)])
def test_pool_bits_equal_for_each_encoding(tmp_path, name, data_dir,
                                           encoding):
    kw = dict(encoding=encoding, n_samples=400, side=12, seed=3)
    ref = jregistry.load(name, tmp_path / "jax" if data_dir else None, **kw)
    ours = registry.load(name, tmp_path / "port" if data_dir else None,
                         device="cpu", **kw)
    _same_pool(ref, ours)


@pytest.mark.parametrize("encoding", ["bool", "thermometer:4", "quantile:4",
                                      "quantile:7"])
def test_real_style_drop_in(tmp_path, encoding):
    """Grayscale train and t10k pairs dropped into the cache (the mirror
    writes nothing): the t10k pair is folded into the pool, and the
    quantile thresholds fall between distinct grey levels."""
    for who in ("jax", "port"):
        root = tmp_path / who / "mnist"
        for prefix, n in (("train", 300), ("t10k", 60)):
            r = np.random.default_rng(n)
            idx.write(root / f"{prefix}-images-idx3-ubyte.gz",
                      r.integers(0, 256, (n, 28, 28)).astype(np.uint8))
            idx.write(root / f"{prefix}-labels-idx1-ubyte.gz",
                      r.integers(0, 10, n).astype(np.uint8))
    ref = jregistry.load("mnist", tmp_path / "jax", encoding=encoding)
    ours = registry.load("mnist", tmp_path / "port", encoding=encoding,
                         device="cpu")
    assert ours.x.shape[0] == 360
    _same_pool(ref, ours)


def test_quantile_thresholds_equal_the_reference():
    rng = np.random.default_rng(2)
    pool = rng.uniform(0, 1, (257, 9)).astype(np.float32)
    pool[:, 0] = np.round(pool[:, 0] * 4) / 4          # ties
    for levels in (1, 3, 4, 9):
        want = np.asarray(jencode.Quantile.fit(pool, levels).thresholds)
        got = encode.Quantile.fit(torch.from_numpy(pool), levels).thresholds
        np.testing.assert_array_equal(got.numpy().view(np.int32),
                                      want.view(np.int32))


def test_registry_names_and_refusals(tmp_path):
    assert registry.names() == jregistry.names()
    with pytest.raises(ValueError, match="file-backed"):
        registry.load("mnist", device="cpu")
    with pytest.raises(ValueError, match="file-backed"):
        fed_train.main(["--device", "cpu", "--dataset", "mnist"])
    with pytest.raises(ValueError, match="unknown dataset"):
        registry.get("cifar")
    for name in ("synthfemnist", "femnist"):
        with pytest.raises(NotImplementedError, match="A7"):
            registry.load(name, tmp_path, device="cpu")
    assert not (tmp_path / "synthfemnist").exists()
    with pytest.raises(ValueError, match="unknown encoding"):
        registry.load("synthmnist", encoding="gray", n_samples=10,
                      device="cpu")
    pool = registry.load("synthmnist", n_samples=10, device="cpu")
    with pytest.raises(NotImplementedError, match="A7"):
        natural.partition_pool(
            pool._replace(writers=torch.zeros(10, dtype=torch.int32)),
            n_clients=2, n_train=2, n_test=1, n_conf=1,
            key=tr.PRNGKey(0, "cpu"))


def test_partial_pair_and_checksum_are_refused(tmp_path):
    root = tmp_path / "mnist"
    idx.write(root / mirror.IMAGES_FILE,
              np.zeros((2, 28, 28), np.uint8))
    with pytest.raises(FileNotFoundError, match="partial train"):
        registry.load("mnist", tmp_path, device="cpu")
    idx.write(root / mirror.LABELS_FILE, np.zeros(2, np.uint8))
    (root / mirror.LABELS_FILE).write_bytes(b"tampered")
    with pytest.raises(idx.ChecksumError):
        registry.load("mnist", tmp_path, device="cpu")


def test_mirror_is_written_once_and_reused(tmp_path):
    """A second load reads the files the first wrote, byte for byte."""
    a = registry.load("synthmnist", tmp_path, n_samples=50, seed=1,
                      device="cpu")
    before = _files(tmp_path / "synthmnist")
    b = registry.load("synthmnist", tmp_path, n_samples=999, seed=7,
                      device="cpu")
    assert _files(tmp_path / "synthmnist") == before
    assert torch.equal(a.x, b.x) and torch.equal(a.y, b.y)

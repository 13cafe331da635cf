"""The port's data path is the reference's, bit for bit: the synthetic
pools (``synthetic.make_dataset``, all three flavours), and the
Dirichlet partition (``partition.partition``: mixtures, sizes and all
six splits) on the same pool and key, over seeds and experiments, and
at full width through the registry and the IDX mirror (the reference's
``build_scenario(dataset="mnist", data_dir=...)`` at 20 clients)."""
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import partition as jpartition
from repro.data import synthetic as jsynthetic
from repro.launch import fed_train as jfed_train
from repro_torch import random as tr
from repro_torch.data import partition, synthetic
from repro_torch.data.ingest import registry
from repro_torch.launch import fed_train
from test_torch_gpu import one_torch_thread  # noqa: F401



def _chip_smoke_digest() -> str:
    """The full-width ClientData digest chip_smoke.py holds the card's
    draw to."""
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.FULL_WIDTH_SHA256


def _same_client_data(ref, ours):
    for name in ref._fields:
        a, b = np.asarray(getattr(ref, name)), getattr(ours, name).numpy()
        assert a.shape == b.shape and a.dtype == b.dtype, name
        if a.dtype == np.float32:
            a, b = a.view(np.int32), b.view(np.int32)
        np.testing.assert_array_equal(a, b, err_msg=name)


@pytest.mark.parametrize("seed", [0, 1, 42])
@pytest.mark.parametrize("name,side", [
    ("synthmnist", 12), ("mnist", 28), ("synthfashion", 12),
    ("synthfemnist", 12)])
def test_pool_bit_identical(name, side, seed):
    flavour = registry.get(name).flavour
    x, y, cfg = synthetic.make_dataset(flavour, 2000, tr.PRNGKey(seed, "cpu"),
                                       side=side)
    jx, jy, jcfg = jsynthetic.make_dataset(
        flavour, 2000, jax.random.PRNGKey(seed), side=side)
    assert (cfg.side, cfg.n_features, cfg.flip, cfg.n_strokes,
            cfg.n_classes) == (jcfg.side, jcfg.n_features, jcfg.flip,
                               jcfg.n_strokes, jcfg.n_classes)
    assert x.dtype == torch.uint8 and y.dtype == torch.int32
    np.testing.assert_array_equal(x.numpy(), np.asarray(jx))
    np.testing.assert_array_equal(y.numpy(), np.asarray(jy))


@pytest.mark.parametrize("flavour", ["synthmnist", "synthfemnist"])
def test_prototypes_bit_identical(flavour):
    """synthfemnist's thin strokes (at most 2 wide) included."""
    cfg = synthetic.dataset_config(flavour, side=28)
    want = jsynthetic.class_prototypes(
        jsynthetic.dataset_config(flavour, side=28), jax.random.PRNGKey(3))
    got = synthetic.class_prototypes(cfg, tr.PRNGKey(3, "cpu"))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("experiment", [1, 5])
@pytest.mark.parametrize("seed", [0, 1, 42])
def test_partition_bit_identical(seed, experiment):
    x, y, _ = synthetic.make_dataset("synthmnist", 600, tr.PRNGKey(0, "cpu"),
                                     side=12)
    ours = partition.partition(x, y, 10, n_clients=6, experiment=experiment,
                               key=tr.PRNGKey(seed, "cpu"), n_train=8,
                               n_test=4, n_conf=4)
    ref = jpartition.partition(jnp.asarray(x.numpy()),
                               jnp.asarray(y.numpy()), 10, n_clients=6,
                               experiment=experiment,
                               key=jax.random.PRNGKey(seed), n_train=8,
                               n_test=4, n_conf=4)
    _same_client_data(ref, ours)


def test_partition_with_62_classes_and_an_absent_class():
    """synthfemnist's 62 classes (the softmax sum over 62 lanes goes
    through XLA's windowed order) on a pool too small to hold every
    class, so some drawn labels have no row and take the full-row pick."""
    x, y, _ = synthetic.make_dataset("synthfemnist", 40,
                                     tr.PRNGKey(2, "cpu"), side=12)
    assert len(torch.unique(y)) < 62
    ours = partition.partition(x, y, 62, n_clients=5, experiment=3,
                               key=tr.PRNGKey(7, "cpu"), n_train=6,
                               n_test=3, n_conf=3)
    ref = jpartition.partition(jnp.asarray(x.numpy()),
                               jnp.asarray(y.numpy()), 62, n_clients=5,
                               experiment=3, key=jax.random.PRNGKey(7),
                               n_train=6, n_test=3, n_conf=3)
    labels = ours.y_train.unique()
    assert not torch.isin(labels, y).all()
    _same_client_data(ref, ours)


def test_partition_rejects_an_unknown_experiment():
    x, y, _ = synthetic.make_dataset("synthmnist", 20, tr.PRNGKey(0, "cpu"),
                                     side=12)
    with pytest.raises(ValueError, match="1..5"):
        partition.partition(x, y, 10, n_clients=2, experiment=6,
                            key=tr.PRNGKey(0, "cpu"), n_train=2, n_test=2,
                            n_conf=2)


def test_full_width_scenario_bit_identical(tmp_path):
    """The chip smoke's scenario: mnist (28×28) through the IDX mirror,
    20 clients of 80 / 40 / 40, drawn by each package from seed 0; its
    digest is the constant chip_smoke.py holds the card's draw to, so
    that constant is the live reference's."""
    _, ref, *_ = jfed_train.build_scenario(
        dataset="mnist", data_dir=str(tmp_path / "jax"), clients=20,
        clauses=8)
    ours, cfg, _, _ = fed_train.build_scenario(
        dataset="mnist", data_dir=str(tmp_path / "port"), clients=20,
        clauses=8, device="cpu")
    assert cfg.n_features == 784 and ours.x_train.shape == (20, 80, 784)
    _same_client_data(ref, ours)
    assert partition.sha256(ours) == partition.sha256(ref) \
        == _chip_smoke_digest()

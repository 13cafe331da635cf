"""The port's pool is the reference's: ``synthetic.make_pool`` equals
``repro.data.synthetic.make_dataset`` bit for bit at side 12
(``synthmnist``) and side 28 (``mnist``).  The partition is still drawn
with numpy: on that same pool its Dirichlet mixtures differ."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.data import partition as jpartition
from repro.data import synthetic as jsynthetic
from repro_torch import random as tr
from repro_torch.data import partition, synthetic
from test_torch_gpu import one_torch_thread  # noqa: F401


@pytest.mark.parametrize("seed", [0, 1, 42])
@pytest.mark.parametrize("name,side", [("synthmnist", 12), ("mnist", 28)])
def test_pool_bit_identical(name, side, seed):
    x, y, cfg = synthetic.make_pool(name, 2000, seed)
    jx, jy, jcfg = jsynthetic.make_dataset(
        "synthmnist", 2000, jax.random.PRNGKey(seed), side=side)
    assert (cfg.side, cfg.n_features, cfg.flip, cfg.n_strokes) == (
        jcfg.side, jcfg.n_features, jcfg.flip, jcfg.n_strokes)
    assert x.dtype == np.uint8 and y.dtype == np.int32
    np.testing.assert_array_equal(x, np.asarray(jx))
    np.testing.assert_array_equal(y, np.asarray(jy))


def test_prototypes_bit_identical():
    cfg = synthetic.dataset_config("mnist")
    want = jsynthetic.class_prototypes(
        jsynthetic.dataset_config("synthmnist", side=28),
        jax.random.PRNGKey(3))
    got = synthetic.class_prototypes(cfg, tr.PRNGKey(3, "cpu"))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_partition_mixtures_still_differ():
    """The open half of the data fault: the same pool, split by each
    package, gives other Dirichlet mixtures (so every split differs)."""
    x, y, _ = synthetic.make_pool("synthmnist", 600, 0)
    ours = partition.partition(x, y, 10, n_clients=6, experiment=5, seed=1,
                               n_train=8, n_test=4, n_conf=4, device="cpu")
    ref = jpartition.partition(jnp.asarray(x), jnp.asarray(y), 10,
                               n_clients=6, experiment=5,
                               key=jax.random.PRNGKey(1), n_train=8,
                               n_test=4, n_conf=4)
    np.testing.assert_array_equal(ours.x_train.shape, ref.x_train.shape)
    assert not np.array_equal(ours.mixtures.numpy(),
                              np.asarray(ref.mixtures))

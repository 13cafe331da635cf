"""The CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA device and skips without one; the file
imports neither jax nor the JAX package, so it runs on the GPU machine:

    PYTHONPATH=src python -m pytest -q --noconftest tests/test_torch_gpu.py

The input helpers and the ``one_torch_thread`` fixture are shared with
the other test_torch_* files, which hold the port against the JAX
package on the CPU."""
import numpy as np
import pytest
import torch

from repro_torch import convert
from repro_torch import random as tr
from repro_torch.core import tm as ttm
from repro_torch.data import partition, synthetic
from repro_torch.fl.runtime import Engine, RuntimeConfig, TPFLStrategy
from repro_torch.kernels import draws, ops, ref

VOTE_SHAPES = [  # (N, C, m, L, B): test_kernels.py's, and C·m = 99, L = 130
    (3, 4, 16, 32, 8), (4, 3, 33, 130, 5), (2, 3, 33, 130, 11)]
TM = dict(n_classes=10, n_clauses=16, n_features=144, n_states=63, s=5.0,
          T=40)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Test workers run side by side: one intra-op thread each keeps
    torch's CPU kernels from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _vote_inputs(rng, N, C, m, L, B):
    include = (rng.random((N, C, m, L)) < 2.0 / L).astype(np.int32)
    include[:, :, ::5] = 0                        # empty clauses
    lits = rng.integers(0, 2, (N, B, L)).astype(np.int32)
    wpol = rng.integers(-7, 8, (N, C, m)).astype(np.int32)
    return include, lits, wpol


def _epoch_inputs(rng, N, S, C, m, o, n_states):
    L = 2 * o
    ta = rng.integers(n_states - 3, n_states + 1, (N, C, m, L))
    inc = rng.random((N, C, m, L)) < 3.0 / L
    ta[inc] = rng.integers(n_states + 1, n_states + 4, int(inc.sum()))
    ta[:, :, 0, :2] = [1, 2 * n_states]           # clamp edges
    w = rng.integers(0, 5, (N, C, m))
    x = (rng.random((N, S, o)) < 0.4).astype(np.int32)
    lits = np.concatenate([x, 1 - x], -1)
    return ta.astype(np.int32), w.astype(np.int32), lits


def _draws(rng, N, S, C, m, L):
    target = rng.integers(0, C, (N, S))
    neg = (target + rng.integers(1, C, (N, S))) % C
    cls2 = np.stack([target, neg], -1).astype(np.int32)
    u_act = (rng.integers(0, 1 << 23, (N, S, 2, m)) * 2.0 ** -23
             ).astype(np.float32)
    coin = rng.integers(0, 4, (N, S, 2, m, L)).astype(np.int8)
    return cls2, u_act, coin


def _t(*arrays, device="cpu"):
    return [torch.as_tensor(a, device=device) for a in arrays]


@pytest.mark.gpu
@pytest.mark.parametrize("shape", VOTE_SHAPES + [(20, 10, 300, 1568, 40)])
@pytest.mark.parametrize("predict", [True, False])
def test_fused_votes_kernel_matches_plain_on_gpu(cuda, shape, predict):
    include, lits, wpol = _vote_inputs(np.random.default_rng(3), *shape)
    args = _t(include.astype(bool), lits, wpol, device=cuda)
    n = ops.LAUNCHES["fused_votes_batched"]
    got = ops.fused_votes_batched(*args, predict)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["fused_votes_batched"] == n + 1
    want = ref.fused_votes_batched_ref(*args, predict)
    assert torch.equal(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("N,S,C,m,o", [(4, 17, 3, 33, 65), (3, 8, 10, 300, 784)])
def test_train_epoch_kernel_matches_plain_on_gpu(cuda, N, S, C, m, o):
    rng = np.random.default_rng(4)
    ta, w, lits = _epoch_inputs(rng, N, S, C, m, o, 63)
    args = _t(ta, w, lits, *_draws(rng, N, S, C, m, 2 * o), device=cuda)
    n = ops.LAUNCHES["train_epoch_fused"]
    got = ops.train_epoch_fused(*args, n_states=63, T=15)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["train_epoch_fused"] == n + 1
    want = ref.train_epoch_ref(*args, n_states=63, T=15)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert torch.equal(args[0].cpu(), torch.as_tensor(ta))   # input intact


@pytest.mark.gpu
def test_epoch_draws_same_on_gpu_and_cpu(cuda):
    keys = tr.split(tr.PRNGKey(9, "cpu"), 3)
    a = draws.epoch_draws(keys, 6, 33, 130, 10, 0.8, 0.2)
    b = draws.epoch_draws(keys.to(cuda), 6, 33, 130, 10, 0.8, 0.2)
    for x, y in zip(a, b):
        assert torch.equal(x, y.cpu())


@pytest.mark.gpu
@pytest.mark.parametrize("strategy_kw", [
    {}, dict(top_classes=2, conf_threshold=2.0, weighted_confidence=True)])
def test_gpu_round_matches_cpu_round(cuda, strategy_kw):
    """The kernel path on the card equals the plain path on the CPU, for
    Alg. 1 as written and for the §7 multi-cluster, thresholded and
    weighted-confidence variant."""
    x, y, _ = synthetic.make_pool("synthmnist", 400, seed=0)
    runs = []
    for dev in ("cpu", "cuda"):
        data = partition.partition(x, y, 10, n_clients=4, experiment=5,
                                   seed=1, n_train=16, n_test=8, n_conf=8,
                                   device=dev)
        eng = Engine(TPFLStrategy(ttm.TMConfig(**TM), local_epochs=2,
                                  **strategy_kw),
                     data, RuntimeConfig(rounds=2))
        runs.append(eng.run(tr.PRNGKey(5, "cpu")))
    (s0, r0), (s1, r1) = runs
    for a, b in zip(convert.to_numpy([*s0.client_state, s0.server.slots]),
                    convert.to_numpy([*s1.client_state, s1.server.slots])):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(r0, r1):
        for f in ("per_client_accuracy", "assignment", "cluster_counts"):
            assert torch.equal(getattr(a, f), getattr(b, f).cpu()), f
        assert a.upload_bytes == b.upload_bytes

"""The port's kernel path against the JAX package's, on inputs made with
numpy: ``epoch_draws`` and every kernel's plain version are bit-equal to
``repro.kernels`` (Pallas in interpret mode on the CPU).  The CUDA
kernels are held against these plain versions in test_torch_gpu.py."""
import ctypes
import shutil
import subprocess
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import clause_eval as jce
from repro.kernels import draws as jdraws
from repro.kernels import ops as jops
from repro.kernels import ta_update as jta
from repro_torch import random as tr
from repro_torch.kernels import draws, ops, ref
from repro_torch.kernels import clause_eval as tce
from test_torch_gpu import (TA_P, VOTE_CASES, VOTE_SHAPES,  # noqa: F401
                            _draws, _epoch_inputs, _keys, _step_inputs, _t,
                            _ta_inputs, _vote_inputs, one_torch_thread)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("S,m,L,C", [(17, 33, 130, 3), (4, 16, 32, 10)])
def test_epoch_draws_bit_equal(seed, S, m, L, C):
    jk = jax.random.PRNGKey(seed)
    a = jdraws.epoch_draws(jk, S, m, L, C, 2.0 / 3.0, 1.0 / 3.0)
    b = draws.epoch_draws(tr.PRNGKey(seed, "cpu"), S, m, L, C, 2.0 / 3.0, 1.0 / 3.0)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(np.asarray(x), y.numpy())
    # batched keys = vmap over per-client keys
    jks = jax.random.split(jk, 3)
    a = jax.vmap(lambda k: jdraws.epoch_draws(k, S, m, L, C, 0.8, 0.2))(jks)
    b = draws.epoch_draws(tr.split(tr.PRNGKey(seed, "cpu"), 3), S, m, L, C, 0.8, 0.2)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(np.asarray(x), y.numpy())


@pytest.mark.parametrize("p", [0.2, 1.0 / 3.0, 2.0 / 3.0, 1e-7, 1.0])
def test_int_threshold(p):
    assert draws.int_threshold(p) == jdraws.int_threshold(p)


@pytest.mark.parametrize("shape", VOTE_SHAPES)
@pytest.mark.parametrize("predict", [True, False])
@pytest.mark.parametrize("seed", [0, 1])
def test_fused_votes_batched_ref_matches_jax(shape, predict, seed):
    include, lits, wpol = _vote_inputs(np.random.default_rng(seed), *shape)
    want = np.asarray(jops.fused_votes_batched(
        jnp.asarray(include), jnp.asarray(lits), jnp.asarray(wpol),
        predict=predict))
    got = ref.fused_votes_batched_ref(*_t(include, lits, wpol), predict)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    # CPU tensors dispatch to the plain version, uncounted
    before = dict(ops.LAUNCHES)
    np.testing.assert_array_equal(
        ops.fused_votes_batched(*_t(include, lits, wpol), predict).numpy(),
        want)
    assert ops.LAUNCHES == before


@pytest.mark.parametrize("shape", VOTE_SHAPES[:2])
@pytest.mark.parametrize("predict", [True, False])
def test_clause_outputs_and_fused_votes_ref_match_pallas(shape, predict):
    """Kernels 3 and 4 of the single-model path (C·m = 64 at L = 32, and
    the tile-unaligned C·m = 99 at L = 130), one model at a time, and the
    plain versions' leading batch axis."""
    N, C, m, L, B = shape
    include, lits, wpol = _vote_inputs(np.random.default_rng(5), *shape)
    fired = ref.clause_outputs_ref(*_t(include.reshape(N, C * m, L), lits),
                                   predict)
    votes = ref.fused_votes_ref(*_t(include, lits, wpol), predict)
    for n in range(N):
        want = jce.clause_outputs_pallas(
            jnp.asarray(include[n].reshape(C * m, L)), jnp.asarray(lits[n]),
            predict=predict, interpret=True)
        got = ops.clause_outputs(*_t(include[n].reshape(C * m, L), lits[n]),
                                 predict)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        np.testing.assert_array_equal(fired[n].numpy(), np.asarray(want))
        want = jce.fused_votes_pallas(
            jnp.asarray(include[n]), jnp.asarray(lits[n]),
            jnp.asarray(wpol[n]), predict=predict, interpret=True)
        got = ops.fused_votes(*_t(include[n], lits[n], wpol[n]), predict)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        np.testing.assert_array_equal(votes[n].numpy(), np.asarray(want))


@pytest.mark.parametrize("case", [c for c in VOTE_CASES if c[3] <= 256])
@pytest.mark.parametrize("predict", [True, False])
def test_vote_ops_match_pallas_at_kernel_cases(case, predict):
    """Kernels 2 and 4 at the GPU tests' cases that run quickly here:
    B = 1, 40, 130, the ragged L = 130, m = 33 and 300, banks with every
    clause empty and with none, |wpol| up to 2**15 (exact in the Pallas
    kernels' float32)."""
    *shape, banks, wmax = case
    include, lits, wpol = _vote_inputs(np.random.default_rng(10), *shape,
                                       banks=banks, wmax=wmax)
    want = np.asarray(jce.fused_votes_batched_pallas(
        jnp.asarray(include), jnp.asarray(lits), jnp.asarray(wpol),
        predict=predict, interpret=True))
    got = ops.fused_votes_batched(*_t(include.astype(bool), lits, wpol),
                                  predict)
    np.testing.assert_array_equal(got.numpy(), want)
    want1 = jce.fused_votes_pallas(
        jnp.asarray(include[0]), jnp.asarray(lits[0]), jnp.asarray(wpol[0]),
        predict=predict, interpret=True)
    got1 = ops.fused_votes(*_t(include[0].astype(bool), lits[0], wpol[0]),
                           predict)
    np.testing.assert_array_equal(got1.numpy(), np.asarray(want1))
    np.testing.assert_array_equal(want[0], np.asarray(want1))


# votes_mma_kernel's warps per block and literals per ring stage
# (csrc/votes_plan.h): the kernel's own index arithmetic, then the
# launcher's plan built from that header by the host compiler
WARPS, CHUNK = 8, 64


@pytest.mark.parametrize("m,L", [(300, 1568), (33, 130), (300, 256),
                                 (1, 20000), (16, 32), (0, 130)])
@pytest.mark.parametrize("cluster,ks", [(1, 1), (8, 2), (2, 4), (1, 8)])
def test_vote_split_covers_every_tile_and_chunk_once(m, L, cluster, ks):
    """The kernel's split of a (client, class) pair, in its own index
    arithmetic: block ``rank`` of the cluster takes tiles
    [rank·T/G, (rank+1)·T/G), warp (slot, kp) takes every slots-th of
    them (``live_iters`` of its ``iters``) and every ks-th 64-literal
    chunk from kp (``nck`` of them)."""
    tiles, chunks = -(-m // 16), -(-L // CHUNK)
    slots = WARPS // ks
    seen = []
    for rank in range(cluster):
        t0, t1 = rank * tiles // cluster, (rank + 1) * tiles // cluster
        iters = -(-(t1 - t0) // slots)
        for warp in range(WARPS):
            slot, kp = divmod(warp, ks)
            live = -(-(t1 - t0 - slot) // slots) if t1 - t0 > slot else 0
            nck = -(-(chunks - kp) // ks) if kp < chunks else 0
            assert live <= iters
            for it in range(iters):
                tile = t0 + slot + it * slots
                assert (it < live) == (tile < t1)
                if it < live:
                    seen += [(tile, kp + j * ks) for j in range(nck)]
    assert sorted(seen) == [(t, k) for t in range(tiles)
                            for k in range(chunks)]


def _ring_run(items: int, stages: int, passes: int):
    """A warp's ring as the kernel drives it: per pass, ``stages - 1``
    fills ahead, then one fill before each read.  Yields (stage, parity,
    item expected, item the stage holds, fills of the stage, reads of
    the stage before this one) at every read."""
    held, fills, reads = [None] * stages, [0] * stages, [0] * stages
    fill_at = read_at = parity = 0
    for _ in range(passes):
        nxt = 0

        def fill_next():
            nonlocal nxt, fill_at
            if nxt < items:
                held[fill_at] = nxt
                fills[fill_at] += 1
                nxt += 1
                fill_at = (fill_at + 1) % stages

        for _ in range(stages - 1):
            fill_next()
        for q in range(items):
            fill_next()
            yield (read_at, parity, q, held[read_at], fills[read_at],
                   reads[read_at])
            reads[read_at] += 1
            read_at += 1
            if read_at == stages:
                read_at, parity = 0, parity ^ 1
    assert fill_at == read_at


@pytest.mark.parametrize("items,stages", [(0, 2), (1, 8), (3, 2), (13, 8),
                                          (25, 4), (75, 3)])
def test_vote_ring_reads_each_chunk_once_filled(items, stages):
    """Each read finds its own chunk in the stage: filled exactly once
    more than the stage was read before (so the mbarrier's phase of that
    parity is the fill it waits for, and no later fill has overwritten
    it), over passes that go on from where the last one left the ring."""
    for stage, parity, q, held, fills, reads in _ring_run(items, stages, 3):
        assert held == q
        assert fills == reads + 1
        assert parity == reads % 2


@pytest.fixture(scope="module")
def host_plan(tmp_path_factory):
    """The vote launcher's planner (``csrc/votes_plan.h``, plain C++, the
    header the CUDA source includes) built alone by the host compiler, as
    ``clause_eval.plan`` would call it from the kernel library."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("needs a host C++ compiler to build csrc/votes_plan.h")
    header = Path(tce.__file__).with_name("csrc") / "votes_plan.h"
    lib = tmp_path_factory.mktemp("votes_plan") / "libvotes_plan.so"
    subprocess.run([cxx, "-std=c++17", "-O1", "-shared", "-fPIC", "-x",
                    "c++", "-", "-o", str(lib)],
                   input=f'#include "{header}"\n', text=True, check=True)
    query = ctypes.CDLL(str(lib)).votes_plan
    query.argtypes = [ctypes.c_int] * 6 + [ctypes.c_void_p]
    query.restype = ctypes.c_int
    return lambda N, C, m, L, B, sms: tce.plan_from(query, N, C, m, L, B,
                                                   sms)


PLAN_SHAPES = [  # (N, C, m, L, B)
    (1, 10, 300, 1568, 1), (1, 10, 300, 1568, 40), (20, 10, 300, 1568, 40),
    (32, 10, 300, 1568, 1), (2, 3, 33, 130, 130), (3, 4, 33, 130, 1),
    (1, 10, 300, 1568, 300), (1, 3, 0, 130, 5), (1, 3, 33, 0, 5),
    (4, 2, 1, 20000, 17), (1, 1, 16, 32, 1000), (2, 3, 33, 130, 24)]
SMEM_BLOCK = 232448        # shared memory a block may use on sm_90
SMEM_TWO = 233472 // 2 - 1024   # each of two blocks an SM


@pytest.mark.parametrize("shape", PLAN_SHAPES)
def test_vote_plan_fits_the_kernel(host_plan, shape):
    """Every plan of the launcher is one the kernel can launch: a
    power-of-two cluster no wider than the portable 8 or the class's
    tiles, K parts that divide the block's warps, whole n-tiles, 2 to 16
    ring stages a warp (as many as the budget holds), shared memory
    within the block's limit (and two blocks an SM at up to 8 n-tiles,
    where the smallest ring allows it, when the grid has more blocks than
    SMs);
    all samples go in one pass (the include plane is read once) whenever
    they fit."""
    N, C, m, L, B = shape
    p = host_plan(*shape, sms=132)
    tiles, chunks = -(-m // 16), -(-L // 64)
    one_wave = N * C * p.cluster <= 132
    assert p.cluster & (p.cluster - 1) == 0
    assert p.cluster <= min(8, max(tiles, 1))
    assert 8 % p.ks == 0 and p.ks <= max(1, 1 << (chunks - 1).bit_length())
    assert p.samples % 8 == 0 and 8 <= p.samples <= 128
    assert p.nt in (1, 2, 4, 8, 16) and p.samples <= 8 * p.nt < 2 * p.samples + 8
    assert 2 <= p.stages <= 16
    stride = -(-L // 128) * 128 + 64
    counts = 8 * p.nt * 128 * 4 if p.ks > 1 else 0
    assert p.smem == p.samples * stride + counts + p.stages * 8 * 1024
    assert p.smem + p.static_smem <= SMEM_BLOCK
    two = p.samples * stride + counts + 2 * 8 * 1024 + p.static_smem
    if not one_wave and p.nt <= 8 and two <= SMEM_TWO:
        assert p.smem + p.static_smem <= SMEM_TWO
    if p.stages < 16:          # as many as the budget holds
        cap = SMEM_TWO if p.smem + p.static_smem <= SMEM_TWO \
            and not one_wave else SMEM_BLOCK
        assert p.smem + 8 * 1024 + p.static_smem > cap
    b8 = -(-B // 8) * 8
    if b8 <= 128 and b8 * stride + 2 * 8 * 1024 + p.static_smem <= SMEM_BLOCK:
        assert p.samples == b8


def test_vote_plan_fills_the_card(host_plan):
    """One model of 10 classes spreads over 8-block clusters (80 of 132
    SMs) and splits a tile's chunks over two warps, with 16 ring stages
    each (all 13 of a warp's chunks in flight at once); the round's 200
    (client, class) pairs and serving's 320 need no more than one block
    each, two blocks an SM."""
    one = host_plan(1, 10, 300, 1568, 1, sms=132)
    assert (one.cluster, one.ks, one.samples, one.nt, one.stages) \
        == (8, 2, 8, 1, 16)
    rnd = host_plan(20, 10, 300, 1568, 40, sms=132)
    assert (rnd.cluster, rnd.ks, rnd.samples, rnd.nt) == (1, 1, 40, 8)
    assert rnd.smem + rnd.static_smem <= SMEM_TWO
    assert host_plan(32, 10, 300, 1568, 1, sms=132).cluster == 1
    assert host_plan(1, 10, 300, 1568, 1, sms=8).cluster == 1
    assert host_plan(2, 3, 33, 130, 130, sms=132).samples == 128   # two passes
    assert host_plan(1, 10, 300, 1568, 300, sms=132).samples < 128  # three


def test_vote_plan_refuses_what_it_cannot_hold(host_plan):
    with pytest.raises(ValueError, match="no plan"):
        host_plan(1, 10, 300, 30000, 1, sms=132)
    with pytest.raises(ValueError, match="no plan"):
        host_plan(1, 10, 300, 1568, 0, sms=132)


def test_vote_operands_view_the_main_path_dtypes():
    """At tm's dtypes (bool include, int32 lits and wpol) nothing is
    copied: the bool plane's bytes are the 0/1 bytes the kernel reads,
    and an expanded wpol (unit weights) keeps its strides.  Other dtypes
    become 0/1 bytes and int32, and a strided plane is made contiguous."""
    include, lits, wpol = _vote_inputs(np.random.default_rng(2), 2, 3, 5,
                                       40, 4)
    inc_b, lit, wp = _t(include.astype(bool), lits, wpol)
    unit = torch.tensor([1, -1, 1, -1, 1], dtype=torch.int32).expand(2, 3, 5)
    i8, l32, w32 = tce.vote_operands(inc_b, lit, unit)
    assert i8 is inc_b and l32 is lit and w32 is unit
    assert w32.stride() == (0, 0, 1)
    u8 = inc_b.to(torch.uint8)
    assert tce.vote_operands(u8, lit, wp)[0] is u8
    i8, l32, w32 = tce.vote_operands(_t(include * 3)[0],
                                     lit.to(torch.int64),
                                     wp.to(torch.int16))
    assert i8.element_size() == 1 and torch.equal(
        i8.view(torch.uint8), torch.as_tensor(include.astype(np.uint8)))
    assert l32.dtype == torch.int32 and torch.equal(l32, lit)
    assert w32.dtype == torch.int32 and torch.equal(w32, wp)
    strided = torch.cat([inc_b, inc_b], -1)[..., :40]
    got = tce.vote_operands(strided, lit[:, :, ::1], wp)
    assert got[0].is_contiguous() and torch.equal(got[0], inc_b)
    got = tce.vote_operands(inc_b, lit.transpose(1, 2).contiguous()
                            .transpose(1, 2), wp)
    assert got[1].is_contiguous() and torch.equal(got[1], lit)


def test_vote_wrappers_refuse_shapes_that_disagree():
    include, lits, wpol = _t(*_vote_inputs(np.random.default_rng(0), 2, 3,
                                           5, 40, 4))
    bad = [(include, lits[:, :, :-1], wpol), (include, lits, wpol[:, :, :-1]),
           (include, lits, wpol[:, :-1])]
    for args in bad:
        with pytest.raises(ValueError, match="disagree"):
            tce.fused_votes_batched(*args)
        with pytest.raises(ValueError, match="disagree"):
            tce.fused_votes(*(a[0] for a in args))
    with pytest.raises(ValueError, match=r"\(N,C,m,L\)"):
        tce.fused_votes_batched(include[0], lits[0], wpol[0])
    with pytest.raises(ValueError, match=r"\(C,m,L\)"):
        tce.fused_votes(include, lits, wpol)


@pytest.mark.parametrize("m,L", [(16, 128), (33, 130)])
def test_ta_update_ref_matches_pallas(m, L):
    """Kernel 5's oracle (behind ta_update.ta_update_plain), one bank at
    a time and with the leading batch axis.  A third of the uniforms equal
    float32(p), which lies below p: a float64 compare would move those
    states, the reference's float32 one does not."""
    NB, n_states = 3, 63
    args = _ta_inputs(np.random.default_rng(m), NB, m, L, n_states)
    kw = dict(p_inc=TA_P[0], p_dec=TA_P[1], n_states=n_states)
    got = ref.ta_update_ref(*_t(*args), **kw)
    assert got.dtype == torch.int32
    for n in range(NB):
        want = jta.ta_update_pallas(*(jnp.asarray(a[n]) for a in args),
                                    interpret=True, **kw)
        np.testing.assert_array_equal(got[n].numpy(), np.asarray(want))
    assert (got.numpy() != args[0]).any()
    u_inc = args[5]
    assert ((u_inc.astype(np.float64) < TA_P[0])
            != (u_inc < np.float32(TA_P[0]))).any()


@pytest.mark.parametrize("epochs", [1, 2])
def test_train_epoch_ref_matches_jax(epochs):
    """N = 4, S = 17, C = 3, m = 33, o = 65, fed the same numpy draws: the
    coin-plane oracle behind the keyed plain version
    (train_epoch.train_epoch_plain)."""
    N, S, C, m, o, n_states, T = 4, 17, 3, 33, 65, 63, 15
    rng = np.random.default_rng(epochs)
    ta, w, lits = _epoch_inputs(rng, N, S, C, m, o, n_states)
    jta, jw = jnp.asarray(ta), jnp.asarray(w)
    tta, tw = _t(ta, w)
    for _ in range(epochs):
        cls2, u_act, coin = _draws(rng, N, S, C, m, 2 * o)
        jta, jw = jops.train_epoch_fused(
            jta, jw, jnp.asarray(lits), jnp.asarray(cls2),
            jnp.asarray(u_act), jnp.asarray(coin), n_states=n_states, T=T)
        tta, tw = ref.train_epoch_ref(tta, tw, *_t(lits, cls2, u_act, coin),
                                      n_states=n_states, T=T)
    np.testing.assert_array_equal(tta.numpy(), np.asarray(jta))
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
    assert (tta.numpy() != ta).any() and (tw.numpy() != w).any()


def test_wrappers_refuse_cpu_tensors():
    from repro_torch.kernels import clause_eval, ta_update, train_epoch
    include, lits, wpol = _vote_inputs(np.random.default_rng(0), 1, 2, 4,
                                       8, 3)
    with pytest.raises(ValueError, match="CUDA"):
        clause_eval.fused_votes_batched(*_t(include, lits, wpol))
    with pytest.raises(ValueError, match="CUDA"):
        clause_eval.fused_votes(*_t(include[0], lits[0], wpol[0]))
    with pytest.raises(ValueError, match="CUDA"):
        clause_eval.clause_outputs(*_t(include[0].reshape(8, 8), lits[0]))
    *step, keys = _step_inputs(np.random.default_rng(0), 2, 3, 4, 8)
    with pytest.raises(ValueError, match="CUDA"):
        ta_update.ta_update_(*_t(*step), tr.split(torch.as_tensor(keys), 3),
                             T=15, p_inc=0.9, p_dec=0.1, n_states=63)
    ta, w, lt = _epoch_inputs(np.random.default_rng(0), 1, 2, 2, 4, 4, 63)
    cls2, role_keys = _keys(np.random.default_rng(1), 1, 2, 2)
    with pytest.raises(ValueError, match="CUDA"):
        train_epoch.train_epoch_fused(*_t(ta, w, lt, cls2, role_keys),
                                      n_states=63, T=15, p_inc=0.8,
                                      p_dec=0.2)


@pytest.mark.parametrize("T", [15, 40, 1000])
def test_constant_divide_is_a_reciprocal_multiply(T):
    """The reference's p_act = (T - v) / (2.0 * T) runs, as XLA compiles
    it, as (T - v) * f32(1/2T), which is not the correctly rounded
    quotient for every v.  The port's plain version and kernel multiply
    by ref.reciprocal_f32, and so does accuracy's / B."""
    v = np.arange(-T, T + 1, dtype=np.int32)
    got = np.asarray(jax.jit(lambda v: (T - v) / (2.0 * T))(jnp.asarray(v)))
    num = (T - v).astype(np.float32)
    mul = num * np.float32(ref.reciprocal_f32(2 * T))
    np.testing.assert_array_equal(got.view(np.int32), mul.view(np.int32))
    assert (num / np.float32(2 * T) != mul).any()
    hits = jnp.asarray([1] * 7 + [0] * (T - 7), bool)
    want = np.float32(jnp.mean(hits))
    assert np.float32(7) * np.float32(ref.reciprocal_f32(T)) == want

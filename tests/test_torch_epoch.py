"""The fused epoch's in-kernel draws and launch plan on the CPU.

``csrc/threefry.h`` and ``csrc/epoch_plan.h`` are plain C++ that the CUDA
kernel includes; here the host compiler builds them alone, and they are
held against ``jax.random`` and the JAX package's coin plane
(``repro.kernels.draws.epoch_draws``) bit for bit, and the plan against
the card's limits.  The keyed epoch (``draws.epoch_keys`` and the keyed
``ops.train_epoch_fused``) is held against the JAX key chain and the
Pallas epoch kernel fed by JAX draws."""
import ctypes
import shutil
import subprocess

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.extend.random import threefry_2x32

from repro.kernels import draws as jdraws
from repro.kernels import ops as jops
from repro_torch import random as tr
from repro_torch.kernels import _build, draws, ops
from test_torch_gpu import _epoch_inputs, _t, one_torch_thread  # noqa: F401

_SHIM = r"""
#include "threefry.h"
#include "epoch_plan.h"
using namespace epoch_layout;

extern "C" void tf_bits(uint32_t k0, uint32_t k1, const uint32_t* ctr, int n,
                        uint32_t* out) {
  const threefry::Key k = threefry::make_key(k0, k1);
  for (int i = 0; i < n; ++i) out[i] = threefry::bits(k, ctr[i]);
}
extern "C" void tf_uniform(uint32_t k0, uint32_t k1, int n, float* out) {
  const threefry::Key k = threefry::make_key(k0, k1);
  for (int i = 0; i < n; ++i)
    out[i] = threefry::uniform(threefry::bits(k, i));
}
extern "C" float tf_uniform_of(uint32_t bits) {
  return threefry::uniform(bits);
}
extern "C" int tf_below(uint32_t bits, uint32_t t) {
  return threefry::mantissa(bits) < t;
}
// the coins of one role, (hit, m, L) for hit = 0, 1
extern "C" void tf_coins(const uint32_t* k, uint32_t t_inc, uint32_t t_dec,
                         int m, int L, uint8_t* out) {
  const threefry::Key k1 = threefry::make_key(k[0], k[1]);
  const threefry::Key k2 = threefry::make_key(k[2], k[3]);
  for (int hit = 0; hit < 2; ++hit)
    for (int j = 0; j < m; ++j)
      for (int l = 0; l < L; ++l)
        *out++ = threefry::coin(k1, k2, t_inc, t_dec,
                                threefry::coin_counter(j, l, L), hit);
}
extern "C" int tf_counters_fit(long long m, long long L) {
  return threefry::counters_fit(m, L);
}
extern "C" int ep_plan(int N, int C, int m, int L, int kmax, const int* fit,
                       int* out) {
  EpochPlan p;
  if (!plan_epoch(N, C, m, L, kmax, fit, &p)) return 1;
  const int v[5] = {p.cluster, p.owned, p.smem, p.waves, p.smallest};
  for (int i = 0; i < 5; ++i) out[i] = v[i];
  return 0;
}
extern "C" int ep_clause_begin(int m, int K, int r) {
  return clause_begin(m, K, r);
}
extern "C" long long ep_smem(int C, int m, int L, int K) {
  return smem_bytes(C, m, L, K);
}
extern "C" void ep_layout(int C, int owned, int W, int* out) {
  const Layout a = layout(C, owned, W);
  const int v[11] = {a.inc, a.w, a.lit, a.keys, a.cls, a.rows, a.fired,
                     a.vote, a.red, a.nrows, a.bytes};
  for (int i = 0; i < 11; ++i) out[i] = v[i];
}
extern "C" int ep_smem_block() { return kSmemBlock; }
"""

SMS = 132
GPCS = (18, 18, 16, 16, 16, 16, 16, 16)   # 132 SMs in GPCs of 16 and 18


@pytest.fixture(scope="module")
def host(tmp_path_factory):
    """``threefry.h`` and ``epoch_plan.h`` built alone by the host
    compiler, behind a few C entry points."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("needs a host C++ compiler to build csrc/threefry.h and "
                    "csrc/epoch_plan.h")
    lib = tmp_path_factory.mktemp("epoch_host") / "libepoch_host.so"
    subprocess.run([cxx, "-std=c++17", "-O2", "-shared", "-fPIC", "-I",
                    str(_build.CSRC), "-x", "c++", "-", "-o", str(lib)],
                   input=_SHIM, text=True, check=True)
    h = ctypes.CDLL(str(lib))
    u32, i32, ptr = ctypes.c_uint32, ctypes.c_int, ctypes.c_void_p
    for name, args, res in (
            ("tf_bits", [u32, u32, ptr, i32, ptr], None),
            ("tf_uniform", [u32, u32, i32, ptr], None),
            ("tf_uniform_of", [u32], ctypes.c_float),
            ("tf_below", [u32, u32], i32),
            ("tf_coins", [ptr, u32, u32, i32, i32, ptr], None),
            ("tf_counters_fit", [ctypes.c_longlong] * 2, i32),
            ("ep_plan", [i32] * 5 + [ptr, ptr], i32),
            ("ep_clause_begin", [i32] * 3, i32),
            ("ep_smem", [i32] * 4, ctypes.c_longlong),
            ("ep_layout", [i32] * 3 + [ptr], None),
            ("ep_smem_block", [], i32)):
        f = getattr(h, name)
        f.argtypes, f.restype = args, res
    return h


def _p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


def _bits(host, key, ctr):
    ctr = np.ascontiguousarray(ctr, dtype=np.uint32)
    out = np.empty_like(ctr)
    host.tf_bits(int(key[0]), int(key[1]), _p(ctr), ctr.size, _p(out))
    return out


def _uniform(host, key, n):
    out = np.empty(n, np.float32)
    host.tf_uniform(int(key[0]), int(key[1]), n, _p(out))
    return out


def _coins(host, k_s1, k_s2, t_inc, t_dec, m, L):
    k = np.ascontiguousarray(np.concatenate([k_s1, k_s2]), dtype=np.uint32)
    out = np.empty((2, m, L), np.uint8)
    host.tf_coins(_p(k), t_inc, t_dec, m, L, _p(out))
    return out


@pytest.mark.parametrize("seed", [0, 42, 2 ** 31 - 1])
def test_threefry_bits_equal_jax(host, seed):
    """bits(key, i) is element i of jax.random.bits, over a whole shape
    and at counters up to 2**31 - 1 (jax's threefry on (0, i))."""
    for key in (jax.random.PRNGKey(seed),
                jax.random.split(jax.random.PRNGKey(seed), 3)[2]):
        k = np.asarray(key)
        want = np.asarray(jax.random.bits(key, (33, 130), jnp.uint32))
        np.testing.assert_array_equal(
            _bits(host, k, np.arange(33 * 130)).reshape(33, 130), want)
        ctr = np.array([0, 1, 4289, 2 ** 24 + 3, 2 ** 30, 2 ** 31 - 2,
                        2 ** 31 - 1], np.uint32)
        h = np.asarray(threefry_2x32(
            key, jnp.concatenate([jnp.zeros_like(jnp.asarray(ctr)),
                                  jnp.asarray(ctr)]))).reshape(2, -1)
        np.testing.assert_array_equal(_bits(host, k, ctr), h[0] ^ h[1])


@pytest.mark.parametrize("seed", [0, 7])
def test_threefry_uniform_equals_jax(host, seed):
    key = jax.random.split(jax.random.PRNGKey(seed))[1]
    want = np.asarray(jax.random.uniform(key, (300,)))
    got = _uniform(host, np.asarray(key), 300)
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("p", [0.75, 0.25, 0.8, 0.2, 2.0 / 3.0, 1.0 / 3.0,
                               1.0])
def test_coin_compare_is_the_float_compare_at_ties(host, p):
    """mantissa(bits) < int_threshold(p) exactly where jax's
    uniform(bits) < float32(p), on the mantissas around the threshold (p =
    0.75, 0.25: float32(p)·2**23 is an integer and the uniform can equal
    float32(p); the others round up)."""
    t = draws.int_threshold(p)
    assert t == jdraws.int_threshold(p)
    for mant in range(max(0, t - 2), min(1 << 23, t + 2)):
        for low in (0, 0x1FF):
            b = (mant << 9) | low
            u = np.float32(host.tf_uniform_of(b))
            assert u == np.float32(mant * 2.0 ** -23)
            assert bool(host.tf_below(b, t)) == bool(u < np.float32(p))


def _jax_role_keys(jk, S):
    """split(split(split(key, S)[i], 3)[1 + r], 3): (S, 2, 3, 2) uint32."""
    def per_sample(k):
        sub = jax.random.split(k, 3)
        return jnp.stack([jax.random.split(sub[1], 3),
                          jax.random.split(sub[2], 3)])
    return np.asarray(jax.vmap(per_sample)(jax.random.split(jk, S)))


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("S,m,L,C", [(17, 33, 130, 3), (4, 16, 32, 10)])
@pytest.mark.parametrize("p_inc,p_dec", [(0.75, 0.25), (0.8, 0.2),
                                         (2.0 / 3.0, 1.0 / 3.0)])
def test_coin_helper_equals_jax_coin_plane(host, seed, S, m, L, C, p_inc,
                                           p_dec):
    """Over every (sample, role, clause, literal, hit): the helper's coin
    is bit 1 of the JAX coin plane where the literal is hit, bit 2 where
    it is not; uniform(bits(k_act, j)) is the plane's u_act."""
    jk = jax.random.PRNGKey(seed)
    _, u_act, coin = (np.asarray(a) for a in jdraws.epoch_draws(
        jk, S, m, L, C, p_inc, p_dec))
    rk = _jax_role_keys(jk, S)
    t_inc, t_dec = draws.int_threshold(p_inc), draws.int_threshold(p_dec)
    for s in range(S):
        for r in range(2):
            got = _coins(host, rk[s, r, 1], rk[s, r, 2], t_inc, t_dec, m, L)
            np.testing.assert_array_equal(got[1], coin[s, r] & 1)
            np.testing.assert_array_equal(got[0], (coin[s, r] >> 1) & 1)
            np.testing.assert_array_equal(
                _uniform(host, rk[s, r, 0], m).view(np.int32),
                u_act[s, r].view(np.int32))


def test_counters_refused_from_2_31(host):
    assert host.tf_counters_fit(300, 1568)
    assert host.tf_counters_fit(1, 2 ** 31 - 1)
    assert not host.tf_counters_fit(1, 2 ** 31)
    assert not host.tf_counters_fit(2 ** 16, 2 ** 15)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("S,C", [(17, 3), (80, 10)])
def test_epoch_keys_equal_jax_key_chain(seed, S, C):
    """Offsets as JAX epoch_draws', role keys as the split chain; also for
    a batch of client keys (vmap over keys)."""
    jk = jax.random.PRNGKey(seed)
    offs, rk = draws.epoch_keys(tr.PRNGKey(seed, "cpu"), S, C)
    np.testing.assert_array_equal(
        offs.numpy(), np.asarray(jdraws.epoch_draws(jk, S, 4, 8, C, 0.8,
                                                    0.2)[0]))
    assert rk.shape == (S, 2, 3, 2) and rk.dtype == torch.int64
    np.testing.assert_array_equal(rk.numpy(),
                                  _jax_role_keys(jk, S).astype(np.int64))
    jks = jax.random.split(jk, 3)
    offs, rk = draws.epoch_keys(tr.split(tr.PRNGKey(seed, "cpu"), 3), S, C)
    np.testing.assert_array_equal(
        offs.numpy(), np.asarray(jax.vmap(lambda k: jdraws.epoch_draws(
            k, S, 4, 8, C, 0.8, 0.2)[0])(jks)))
    np.testing.assert_array_equal(
        rk.numpy(), np.stack([_jax_role_keys(k, S) for k in jks]))


@pytest.mark.parametrize("epochs", [1, 2])
@pytest.mark.parametrize("p_inc,p_dec", [(0.8, 0.2), (1.0, 0.25)])
def test_keyed_train_epoch_equals_pallas_on_jax_draws(epochs, p_inc, p_dec):
    """The keyed CPU ``ops.train_epoch_fused`` equals the Pallas epoch
    kernel (interpret mode) fed by JAX ``epoch_draws``, at the shapes of
    test_train_epoch_ref_matches_jax (N = 4, S = 17, C = 3, m = 33,
    o = 65); CPU calls launch nothing."""
    N, S, C, m, o, n_states, T = 4, 17, 3, 33, 65, 63, 15
    L = 2 * o
    rng = np.random.default_rng(epochs)
    ta, w, lits = _epoch_inputs(rng, N, S, C, m, o, n_states)
    ys = rng.integers(0, C, (N, S)).astype(np.int32)
    jta, jw = jnp.asarray(ta), jnp.asarray(w)
    tta, tw = _t(ta, w)
    jkeys = jax.random.split(jax.random.PRNGKey(5), N)
    tkeys = tr.split(tr.PRNGKey(5, "cpu"), N)
    before = dict(ops.LAUNCHES)
    for e in range(epochs):
        jk = jax.vmap(lambda k: jax.random.fold_in(k, e))(jkeys)
        offs, u_act, coin = jax.vmap(lambda k: jdraws.epoch_draws(
            k, S, m, L, C, p_inc, p_dec))(jk)
        jcls2 = jnp.stack([ys, (ys + offs) % C], -1).astype(jnp.int32)
        jta, jw = jops.train_epoch_fused(
            jta, jw, jnp.asarray(lits), jcls2, u_act, coin,
            n_states=n_states, T=T)
        toffs, rk = draws.epoch_keys(tr.fold_in(tkeys, e), S, C)
        tys = torch.as_tensor(ys)
        cls2 = torch.stack([tys, (tys + toffs) % C], -1).contiguous()
        np.testing.assert_array_equal(cls2.numpy(), np.asarray(jcls2))
        tta, tw = ops.train_epoch_fused(tta, tw, torch.as_tensor(lits), cls2,
                                        rk, n_states=n_states, T=T,
                                        p_inc=p_inc, p_dec=p_dec)
    np.testing.assert_array_equal(tta.numpy(), np.asarray(jta))
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
    assert (tta.numpy() != ta).any() and (tw.numpy() != w).any()
    assert ops.LAUNCHES == before


def _fit(model: str, kmax: int):
    """Clusters of K blocks a 132-SM card runs at once: "ideal" (any SMs
    form a cluster) or "gpcs" (a cluster lies within one GPC)."""
    fit = np.zeros(17, np.int32)
    for K in range(1, kmax + 1):
        fit[K] = SMS // K if model == "ideal" else sum(g // K for g in GPCS)
    return fit


def _plan(host, N, C, m, L, kmax=16, model="gpcs", fit=None):
    fit = _fit(model, kmax) if fit is None else fit
    out = np.zeros(5, np.int32)
    if host.ep_plan(N, C, m, L, kmax, _p(fit), _p(out)) != 0:
        return None
    return dict(zip(("cluster", "owned", "smem", "waves", "smallest"),
                    out.tolist()))


PLAN_SHAPES = [  # (N, C, m, L)
    (20, 10, 300, 1568), (1, 10, 300, 1568), (33, 10, 300, 1568),
    (200, 10, 300, 1568), (3, 3, 33, 130), (4, 3, 33, 130),
    (1, 10, 16, 32), (7, 2, 1, 4000), (2, 3, 5, 0), (2, 3, 0, 130),
    (1, 1, 2000, 64), (5, 10, 300, 3200)]


@pytest.mark.parametrize("shape", PLAN_SHAPES)
@pytest.mark.parametrize("model", ["ideal", "gpcs"])
@pytest.mark.parametrize("kmax", [8, 16])
def test_epoch_plan_fits_shared_memory(host, shape, model, kmax):
    """The plan's cluster lies between the smallest that holds the include
    bits and kmax (and m); its block's regions follow one another,
    16-byte aligned, sized for the most clauses a rank owns, within the
    shared memory a block may use; the waves are ceil(N / fit[K])."""
    N, C, m, L = shape
    p = _plan(host, N, C, m, L, kmax, model)
    assert p is not None
    K, W = p["cluster"], (L + 31) // 32
    assert 1 <= p["smallest"] <= K <= max(1, min(kmax, m))
    assert p["owned"] == -(-m // K)
    assert p["smem"] == host.ep_smem(C, m, L, K) <= host.ep_smem_block()
    if p["smallest"] > 1:
        assert host.ep_smem(C, m, L, p["smallest"] - 1) > host.ep_smem_block()
    fit = _fit(model, kmax)
    assert p["waves"] == -(-N // fit[K])
    lay = np.zeros(11, np.int32)
    host.ep_layout(C, p["owned"], W, _p(lay))
    sizes = [C * p["owned"] * W * 4, C * p["owned"] * 4, 16 * W * 4, 16 * 12
             * 4, 16 * 2 * 4, p["owned"] * 4, p["owned"], 2 * 16 * 4,
             16 * 4, 4]
    assert lay[0] == 0 and lay[10] == p["smem"]
    for i, size in enumerate(sizes):
        assert lay[i] % 16 == 0
        assert lay[i] + size <= lay[i + 1]


@pytest.mark.parametrize("m", [0, 1, 5, 33, 300, 301, 2000])
@pytest.mark.parametrize("K", [1, 2, 3, 5, 6, 7, 8, 16])
def test_epoch_plan_covers_every_clause_once(host, m, K):
    """The ranks' clause ranges tile [0, m) in order, none larger than
    owned_max = ceil(m / K), sizes differing by at most one."""
    begins = [host.ep_clause_begin(m, K, r) for r in range(K + 1)]
    assert begins[0] == 0 and begins[-1] == m
    sizes = np.diff(begins)
    assert (sizes >= 0).all() and sizes.max() <= -(-m // K)
    assert sizes.max() - sizes.min() <= 1


@pytest.mark.parametrize("model,kmax,N,want", [
    ("ideal", 16, 1, 16), ("ideal", 16, 20, 6), ("ideal", 16, 33, 4),
    ("ideal", 8, 1, 8), ("gpcs", 16, 1, 16), ("gpcs", 16, 20, 5),
    ("gpcs", 16, 33, 3), ("gpcs", 8, 1, 8), ("gpcs", 8, 20, 5),
    ("ideal", 16, 132, 3), ("gpcs", 16, 200, 3)])
def test_epoch_plan_fills_the_card(host, model, kmax, N, want):
    """At the paper's width (C = 10, m = 300, L = 1568): the largest
    cluster that runs the N clients in one wave (6 blocks a client at
    N = 20 where any SMs form a cluster, 5 where a cluster must lie in a
    GPC of 16 or 18 SMs; 8 or 16 at N = 1); where none does, the smallest
    that holds the include bits (3), in several waves."""
    p = _plan(host, N, 10, 300, 1568, kmax, model)
    fit = _fit(model, kmax)
    assert p["cluster"] == want and p["smallest"] == 3
    if fit[want] >= N:
        assert p["waves"] == 1 and N * want <= SMS
        assert want == kmax or fit[want + 1] < N
    else:
        assert p["waves"] == -(-N // fit[3]) > 1


def test_epoch_plan_refuses_what_it_cannot_hold(host):
    """No plan, rather than a plain fallback: include bits that need more
    than kmax blocks, counters of 2**31 or more, a card without room for
    the cluster, or an empty grid."""
    assert _plan(host, 1, 10, 300, 1568) is not None
    assert _plan(host, 1, 10, 300, 32 * 20000) is None          # > 16
    assert _plan(host, 1, 10, 300, 6400, kmax=16)["cluster"] == 16
    assert _plan(host, 1, 10, 300, 6400, kmax=8) is None        # > 8
    assert _plan(host, 1, 2, 16, 32 * 30000) is None   # 16 clauses, 1 each
    assert _plan(host, 1, 1, 2, 2 ** 30) is None                # m·L
    assert _plan(host, 1, 1, 1, 2 ** 31 - 1) is None            # smem
    assert _plan(host, 0, 10, 300, 1568) is None
    assert _plan(host, 1, 0, 300, 1568) is None
    assert _plan(host, 1, 10, 300, 1568, kmax=17,
                 fit=_fit("gpcs", 16)) is None
    assert _plan(host, 1, 10, 300, 1568,
                 fit=np.zeros(17, np.int32)) is None

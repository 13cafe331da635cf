"""Plain reference of a TPFL round on the weighted Tsetlin Machine.

Written from the algorithm (TPFL, arXiv:2409.10392, Alg. 1 and 2; the
multiclass weighted TM of Granmo et al.) in plain PyTorch, for the
benchmark's check of the program's rounds.  It imports nothing of the
program: every random draw is worked out again from the run's key with
:mod:`bench.threefry`, in the key discipline of the JAX original:

* ``k_init, k_rounds = split(key)``; round r runs under
  ``fold_in(k_rounds, r)``; client i starts from
  ``bernoulli(split(k_init, N)[i], 0.5)`` over its (C, m, 2o) TA states
  (state n_states on a hit, n_states + 1 otherwise) and unit weights;
* the cohort: ``arange(N)`` under full participation, else the head of
  ``permutation(fold_in(round_key, 0x5C4ED), N)``; client i trains under
  ``split(round_key, N)[i]``, its epoch e under ``split(that, E)[e]``;
* an epoch of S samples: ``split(epoch_key, S)``, each sample's key
  split in three: the negative class's offset ``randint(1, C)``, then
  the target's and the negative's role keys, each split in three:
  activation uniforms over the m clauses, increment coins and decrement
  coins over the (m, 2o) literals (flat counters).

A sample step updates the target class y and the negative class
``(y + offset) mod C`` from the clause outputs and votes before either
update (learning mode: an empty clause fires).  A clause takes feedback
when its activation uniform lies below ``(T ∓ v) · f32(1/2T)`` (v the
votes clipped to ±T; − for the target): Type I for the clauses whose
polarity matches the role (even clauses vote for, odd against their
class), Type II for the others.  Type I moves an included-and-true
literal up with probability (s−1)/s and every other literal down with
probability 1/s; Type II moves a false, excluded literal of a firing
clause up.  States stay in [1, 2·n_states].  A firing clause's weight
goes up under Type I and down (not below 0) under Type II.

The round (Alg. 1, 2): local training of the cohort, per-class
confidence (the sum over D_conf of the unweighted clause margin in
predict mode, where empty clauses stay silent) and the most confident
class (ties to the lower class), upload of that class's weight row, the
per-class mean of the uploads (float32 sum of integers, divided in
float32), the server's rows for classes that received uploads, the
broadcast applied as the mean rounded half to even, and every client of
the population evaluated on its test split (votes clipped to ±T, ties
to the lower class, hits times f32(1/B)).  Bytes: 4 + 4m a shared row up,
4m a fed row down (the float32 identity wire).

``lowp=True`` computes the float32 steps (the activation probability
and its compare, and the mean) in bfloat16: the control that the
comparison must refuse.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from bench import threefry as tf

TAG_SELECT = 0x5C4ED
_INIT_CHUNK = 1 << 25      # hashed TA states a pass at init
_EVAL_CHUNK = 1 << 28      # float elements of the include plane a pass


class TM(NamedTuple):
    C: int
    m: int
    o: int
    n_states: int
    s: float
    T: int
    epochs: int

    @property
    def L(self) -> int:
        return 2 * self.o

    @staticmethod
    def of(config: dict) -> "TM":
        t = config["tm"]
        return TM(t["n_classes"], t["n_clauses"], t["n_features"],
                  t["n_states"], float(t["s"]), t["T"], t["local_epochs"])


class State(NamedTuple):
    ta: torch.Tensor       # (N, C, m, L) uint8
    w: torch.Tensor        # (N, C, m) int32
    server: torch.Tensor   # (C, m) float32


def f32(v: float) -> float:
    return torch.tensor(v, dtype=torch.float32).item()


def _threshold(p: float) -> int:
    """``uniform < f32(p)`` ⟺ ``mantissa < ceil(f32(p) · 2**23)``."""
    return math.ceil(f32(p) * (1 << 23))


def init_state(tm: TM, key: torch.Tensor, n: int) -> State:
    """The population's TA states, unit weights and the zero server."""
    k_init = tf.split(key)[0]
    ckeys = tf.split(k_init, n)
    per = tm.C * tm.m * tm.L
    ta = torch.empty((n, per), dtype=torch.uint8, device=key.device)
    half = _threshold(0.5)
    step = max(1, _INIT_CHUNK // per)
    for i0 in range(0, n, step):
        for c0 in range(0, per, _INIT_CHUNK):
            ctr = torch.arange(c0, min(per, c0 + _INIT_CHUNK),
                               dtype=torch.int32, device=key.device)
            m = tf.mantissa(tf.bits_at(ckeys[i0:i0 + step, None], ctr[None]))
            ta[i0:i0 + step, c0:c0 + ctr.numel()] = torch.where(
                m < half, tm.n_states, tm.n_states + 1).to(torch.uint8)
    ta = ta.view(n, tm.C, tm.m, tm.L)
    w = torch.ones((n, tm.C, tm.m), dtype=torch.int32, device=key.device)
    server = torch.zeros((tm.C, tm.m), dtype=torch.float32,
                         device=key.device)
    return State(ta, w, server)


def round_key(key: torch.Tensor, r: int) -> torch.Tensor:
    return tf.fold_in(tf.split(key)[1], r)


def cohort(rkey: torch.Tensor, n: int, k: int) -> torch.Tensor:
    if k == n:
        return torch.arange(n, device=rkey.device)
    return tf.permutation(tf.fold_in(rkey, TAG_SELECT), n)[:k]


def literals(x: torch.Tensor) -> torch.Tensor:
    xb = x != 0
    return torch.cat([xb, ~xb], dim=-1)


def _first_max(v: torch.Tensor) -> torch.Tensor:
    """Index of the largest value along the last axis, ties to the
    lowest index."""
    n = v.shape[-1]
    ids = torch.arange(n, device=v.device)
    hit = v == v.amax(-1, keepdim=True)
    return torch.where(hit, ids, n).amin(-1)


def train_epoch(tm: TM, ta, w, lits, y, ekey, lowp: bool = False):
    """One epoch of K clients side by side: ta (K,C,m,L) uint8 and w
    (K,C,m) int32 updated in place; lits (K,S,L) bool; y (K,S); ekey
    (K,2)."""
    K, S = y.shape
    C, m, L, T, n_st = tm.C, tm.m, tm.L, tm.T, tm.n_states
    dev = ta.device
    keys = tf.split(ekey, S)                                 # (K,S,2)
    sub = tf.split(keys, 3)                                  # (K,S,3,2)
    off = tf.randint(sub[:, :, 0], (), 1, C)                 # (K,S)
    role = tf.split(sub[:, :, 1:], 3)                        # (K,S,2,3,2)
    u_act = tf.uniform(role[..., 0, :], (m,))                # (K,S,2,m)
    y = y.long()
    cls2 = torch.stack([y, (y + off.long()) % C], dim=-1)    # (K,S,2)
    k_inc = role[..., 1, :].to(torch.int32)                  # (K,S,2,2)
    k_dec = role[..., 2, :].to(torch.int32)
    t_inc, t_dec = _threshold((tm.s - 1.0) / tm.s), _threshold(1.0 / tm.s)
    rows = torch.arange(K, device=dev)[:, None]              # (K,1)
    j = torch.arange(m, device=dev)
    pol = torch.where(j % 2 == 0, 1, -1).to(torch.int32)
    is_t = torch.tensor([True, False], device=dev)[:, None]  # (2,1)
    # Type I rows of role r are the clauses of parity r
    typ1 = (j % 2 == 0)[None] == is_t                        # (2,m)
    jrow = torch.stack([j[0::2], j[1::2]])                   # (2,m/2)
    ctr = (jrow[:, :, None] * L
           + torch.arange(L, device=dev)).to(torch.int32)    # (2,m/2,L)
    half = torch.arange(2, device=dev)[:, None]
    sign = torch.tensor([-1, 1], dtype=torch.int32, device=dev)
    scale = f32(1.0 / (2 * T))
    for s in range(S):
        cls = cls2[:, s]                                     # (K,2)
        bank = ta[rows, cls]                                 # (K,2,m,L)
        lit = lits[:, s][:, None, None, :]                   # (K,1,1,L)
        inc = bank > n_st
        fired = ~(inc & ~lit).any(-1)                        # (K,2,m)
        wc = w[rows, cls]                                    # (K,2,m)
        v = (fired.to(torch.int32) * pol * wc).sum(-1).clamp(-T, T)
        num = (T + sign * v).to(torch.float32)               # (K,2)
        if lowp:
            p = num.bfloat16() * torch.tensor(
                scale, dtype=torch.bfloat16, device=dev)
            active = u_act[:, s].bfloat16() < p[..., None]
        else:
            p = num * scale
            active = u_act[:, s] < p[..., None]              # (K,2,m)
        t1 = active & typ1
        t2 = active & ~typ1
        # Type I on the role's parity rows, hashed for the active rows
        # only: one coin a literal, the increment coin where the clause
        # fired on a true literal
        b1 = bank[:, half, jrow]                             # (K,2,m/2,L)
        fl = fired[:, half, jrow][..., None] & lit
        kk, rr, jj = active[:, half, jrow].nonzero(as_tuple=True)
        d1 = torch.zeros(b1.shape, dtype=torch.int16, device=dev)
        if kk.numel():
            flr = fl[kk, rr, jj]                             # (R,L)
            ks = torch.where(flr[..., None], k_inc[kk, s, rr][:, None],
                             k_dec[kk, s, rr][:, None])      # (R,L,2)
            mm = _coin_mantissa(ks, ctr[rr, jj])
            hit = torch.where(flr, mm < t_inc, mm < t_dec)
            d1[kk, rr, jj] = hit.to(torch.int16) * torch.where(
                flr, 1, -1).to(torch.int16)
        # Type II on the other rows
        o = 1 - half
        b2 = bank[:, o, jrow]
        f2 = fired[:, o, jrow][..., None]
        a2 = active[:, o, jrow][..., None]
        d2 = (a2 & f2 & ~lit & (b2 <= n_st)).to(torch.int16)
        new = bank.to(torch.int16)
        new[:, half, jrow] = (b1.to(torch.int16) + d1).clamp(1, 2 * n_st)
        new[:, o, jrow] = (b2.to(torch.int16) + d2).clamp(max=2 * n_st)
        ta[rows, cls] = new.to(torch.uint8)
        dw = (t1 & fired).to(torch.int32) - (t2 & fired).to(torch.int32)
        w[rows, cls] = (wc + dw).clamp(min=0)


def _coin_mantissa(ks: torch.Tensor, ctr: torch.Tensor) -> torch.Tensor:
    h0, h1 = tf.hash32(ks[..., 0], ks[..., 1], torch.zeros_like(ctr), ctr)
    return tf.mantissa(h0 ^ h1)


def votes(tm: TM, ta, w, x, weighted: bool) -> torch.Tensor:
    """Predict-mode votes (K,B,C) int32, unclipped: empty clauses stay
    silent; ``weighted`` multiplies each clause by its weight."""
    K, C, m, L = ta.shape
    lits = literals(x)
    out = torch.empty((K, x.shape[1], C), dtype=torch.int32,
                      device=ta.device)
    pol = torch.where(torch.arange(m, device=ta.device) % 2 == 0, 1, -1
                      ).to(torch.int32)
    step = max(1, _EVAL_CHUNK // (C * m * L))
    for k0 in range(0, K, step):
        inc = ta[k0:k0 + step] > tm.n_states                 # (k,C,m,L)
        nonempty = inc.any(-1)
        miss = (~lits[k0:k0 + step]).to(torch.float32)       # (k,B,L)
        viol = torch.matmul(miss, inc.flatten(1, 2).to(torch.float32)
                            .transpose(1, 2))                # (k,B,C·m)
        fired = (viol == 0).unflatten(-1, (C, m)) & nonempty[:, None]
        wk = w[k0:k0 + step]
        wpol = pol * (wk if weighted else torch.ones_like(wk))
        out[k0:k0 + step] = (fired.to(torch.int32)
                             * wpol[:, None]).sum(-1, dtype=torch.int32)
    return out


def accuracy(tm: TM, ta, w, x, y) -> torch.Tensor:
    v = votes(tm, ta, w, x, weighted=True).clamp(-tm.T, tm.T)
    hits = (_first_max(v) == y.long()).sum(-1).to(torch.float32)
    return hits * f32(1.0 / y.shape[-1])


def run_round(tm: TM, st: State, data: dict, key: torch.Tensor, r: int,
              k: int, lowp: bool = False) -> tuple[State, dict]:
    """Round r of the cycle from ``st`` (updated in place and returned)
    and its outputs, on the float32 identity wire, every client arriving."""
    n = st.ta.shape[0]
    rkey = round_key(key, r)
    idx = cohort(rkey, n, k)
    ckeys = tf.split(rkey, n)[idx]
    ta, w = st.ta[idx], st.w[idx]
    lits = literals(data["x_train"][idx])
    ekeys = tf.split(ckeys, tm.epochs)                       # (K,E,2)
    for e in range(tm.epochs):
        train_epoch(tm, ta, w, lits, data["y_train"][idx], ekeys[:, e],
                    lowp)
    conf = votes(tm, ta, w, data["x_conf"][idx], weighted=False).sum(1)
    top = _first_max(conf)                                   # (K,)
    rows = torch.arange(k, device=ta.device)
    up = w[rows, top].to(torch.float64)
    sums = torch.zeros((tm.C, tm.m), dtype=torch.float64, device=ta.device)
    sums.index_add_(0, top, up)
    counts = torch.bincount(top, minlength=tm.C).to(torch.float32)
    if lowp:
        mean = (sums.to(torch.bfloat16) / counts.clamp(min=1)[:, None]
                .to(torch.bfloat16)).to(torch.float32)
    else:
        mean = sums.to(torch.float32) / counts.clamp(min=1)[:, None]
    server = torch.where(counts[:, None] > 0, mean, st.server)
    w[rows, top] = torch.round(server[top]).to(torch.int32)
    st.ta[idx], st.w[idx] = ta, w
    assignment = torch.full((n, 1), -1, dtype=torch.int32, device=ta.device)
    assignment[idx, 0] = top.to(torch.int32)
    acc = torch.cat([accuracy(tm, st.ta[i0:i0 + 64], st.w[i0:i0 + 64],
                              data["x_test"][i0:i0 + 64],
                              data["y_test"][i0:i0 + 64])
                     for i0 in range(0, n, 64)])
    fed = int((counts > 0).sum())
    out = {
        "idx": idx.to(torch.int64), "acc": acc, "assignment": assignment,
        "counts": counts, "server": server,
        "upload_bytes": k * (4 + 4 * tm.m),
        "download_bytes_broadcast": fed * 4 * tm.m,
        "download_bytes_per_client": k * 4 * tm.m,
        "aggregated_uploads": k,
        "cohort_ta": ta,
        "w": st.w.clone(),
        "ta_rowsum": torch.cat([
            st.ta[i0:i0 + 64].sum(-1, dtype=torch.int32).flatten(1).sum(
                -1, dtype=torch.int64) for i0 in range(0, n, 64)]),
    }
    return State(st.ta, st.w, server), out

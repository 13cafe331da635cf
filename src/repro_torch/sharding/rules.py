"""PartitionSpec assignment for parameter trees, activations and caches.

Counterpart of ``repro/sharding/rules.py``, statement for statement, as
pure functions over axis names and sizes.  A mesh is anything with
``axis_names`` and a ``shape`` dict of axis sizes
(:class:`repro_torch.launch.mesh.MeshShape`; a ``ClientsMesh`` or a
device-less jax ``AbstractMesh`` answer the same).  A spec is a plain
tuple, one entry a dimension: ``None``, an axis name, or a tuple of axis
names; ``tuple(jax_spec) == port_spec``, and ``P()`` is ``()``.  The
reference's ``shardings`` builds ``NamedSharding``s from these specs and
has no counterpart: the port shards nothing it could hand them to, and
the dry run (:mod:`repro_torch.launch.dryrun`) prices the specs
themselves.

Scheme (MaxText-style 2-D FSDP×TP, extended with a pod axis):

* mesh axes: ``("data", "model")`` single-pod, ``("pod", "data", "model")``
  multi-pod.  The batch shards over ``fsdp_axes`` = ("pod","data"); tensor
  dimensions shard over ``"model"``.
* weight matrices shard **both** ways — the input/feature dim over the
  FSDP axes, the head/ff/vocab dim over "model" — so per-device parameter
  bytes scale with 1/(pods·data·model).
* MoE expert banks: ``("ep" sharding)`` expert axis over "model"
  (expert parallelism) when E % model == 0, else the d_expert dim over
  "model" (``"tp"``).
* scalars / norm scales / small vectors: replicated.

Rules are *name-pattern based* over the flattened param tree path
(``segments/0/0/mixer/wq``: segment, pattern position, module, leaf), so
new modules compose without touching this file as long as they follow
the naming convention.
"""
from __future__ import annotations

import os
from typing import Any

from repro_torch import tree


def fsdp_axes(mesh: Any) -> tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def _path_str(path: tuple) -> str:
    """``tree.map_with_path``'s keys joined as the reference's key paths
    are: ``segments/0/0/mixer/wq``."""
    return "/".join(str(p) for p in path)


def param_spec(path: str, shape: tuple[int, ...], mesh: Any,
               moe_sharding: str = "ep") -> tuple:
    """Map one parameter (by tree path + shape) to a PartitionSpec.

    Leading dim is treated as the scan axis when the path sits under
    "segments".  Any axis whose size does not divide the mesh axis falls
    back to replication (e.g. granite-moe's vocab 49155).
    """
    fsdp = fsdp_axes(mesh)
    f0 = fsdp if len(fsdp) > 1 else (fsdp[0] if fsdp else None)
    fsdp_size = 1
    for a in fsdp:
        fsdp_size *= mesh.shape[a]
    m_size = mesh.shape.get("model", 1)
    stacked = "segments" in path
    lead: tuple = (None,) if stacked else ()
    ndim_eff = len(shape) - (1 if stacked else 0)
    eshape = shape[1:] if stacked else shape

    def spec(*dims):
        # divisibility guard per sharded dim
        safe = []
        for size, d in zip(eshape, dims):
            if d == "model" and size % m_size != 0:
                d = None
            if d is not None and d == f0 and size % fsdp_size != 0:
                d = None
            safe.append(d)
        return (*lead, *safe)

    f = f0

    # ---- embeddings / head: (vocab, d) or (d, vocab) --------------------
    if path.endswith("embed"):
        return spec("model", f)            # vocab-sharded lookup table
    if path.endswith("lm_head"):
        # d replicated on purpose: FSDP-sharding the contraction dim makes
        # SPMD all-gather the (B,T,d) activations over the batch axis at
        # the unembed; replicating d costs only V·d/model_size bytes per
        # device.
        return spec(None, "model")

    # ---- MoE expert banks (E, d, f) / (E, f, d) --------------------------
    if any(path.endswith(s) for s in ("ffn/gate", "ffn/up", "ffn/down")) \
            and ndim_eff == 3:
        if moe_sharding == "ep":
            return spec("model", f, None)  # expert-parallel
        if os.environ.get("REPRO_MOE_TP_NO_FSDP") == "1":
            # knob: FSDP-sharding d_model inside tp-MoE expert banks
            # makes every expert einsum contract over a sharded dim (an
            # all-reduce per layer); replicating d and sharding only
            # d_expert trades small param bytes for that collective.
            return spec(None, None, "model") \
                if path.endswith(("ffn/gate", "ffn/up")) \
                else spec(None, "model", None)
        return spec(None, f, "model") if path.endswith(("ffn/gate", "ffn/up")) \
            else spec(None, "model", f)
    if path.endswith("router"):
        return spec(f, None)

    # ---- attention projections -------------------------------------------
    if any(path.endswith(s) for s in
           ("wq", "wk", "wv", "wq_b", "wkv_b", "up", "gate",
            "in_proj", "x_proj", "wx", "w_gates")):
        return spec(f, "model") if ndim_eff == 2 else spec(None)
    if any(path.endswith(s) for s in
           ("wo", "down", "out_proj", "dt_proj")):
        return spec("model", f) if ndim_eff == 2 else spec(None)
    if any(path.endswith(s) for s in ("wq_a", "wkv_a")):
        return spec(f, "model")

    # ---- xLSTM recurrent (4, H, dh, dh), Mamba A_log (d_inner, N) --------
    if path.endswith("/r") and ndim_eff == 4:
        if os.environ.get("REPRO_XLSTM_R_REPLICATED") == "1":
            # knob: the sLSTM recurrence re-shards (model→batch) on
            # every time step when r is model-sharded; r is tiny (4·H·dh²)
            # so replicating it removes the per-step collective chain.
            return spec(None, None, None, None)
        return spec(None, None, "model", None)
    if path.endswith("A_log"):
        return spec("model", None)
    if path.endswith(("conv_w",)) and ndim_eff == 2:
        return spec(None, "model")
    if any(path.endswith(s) for s in ("conv_b", "dt_bias", "D")) \
            and ndim_eff == 1:
        return spec("model")

    # ---- everything else (norm scales, biases, small vecs): replicated ---
    return spec(*([None] * ndim_eff))


def param_specs(params: Any, mesh: Any, moe_sharding: str = "ep") -> Any:
    def one(path, leaf):
        return param_spec(_path_str(path), tuple(leaf.shape), mesh,
                          moe_sharding)
    return tree.map_with_path(one, params)


# ---------------------------------------------------------------------------
# Activations / batches / caches
# ---------------------------------------------------------------------------

def _fsdp_or_none(mesh: Any, batch: int):
    """FSDP axes if the batch divides them, else replicate (e.g. the
    batch-1 long_500k decode)."""
    f = fsdp_axes(mesh)
    total = 1
    for a in f:
        total *= mesh.shape[a]
    if f and total and batch % total == 0:
        return f if len(f) > 1 else f[0]
    return None


def batch_spec(mesh: Any, batch: int) -> tuple:
    return (_fsdp_or_none(mesh, batch), None)


def cache_specs(caches: Any, mesh: Any) -> Any:
    """Decode-cache PartitionSpecs, matched structurally per cache type.

    Batch over the FSDP axes (when divisible); the *sequence* dim of
    KV/latent caches shards over "model" (context parallelism — softmax
    over a sharded length lowers to an all-reduce of max/sum, which is
    how 32k×128 KV caches fit per-device); recurrent state features
    shard over "model" when divisible.
    """
    from repro_torch.models.attention import KVCache, MLACache, QuantKVCache
    from repro_torch.models.mamba import MambaCache
    from repro_torch.models.xlstm import MLSTMCache, SLSTMCache

    msize = mesh.shape.get("model", 1)

    def div(n):
        return "model" if n % msize == 0 else None

    def handle(c):
        # leaves carry a leading stacked-layer axis from init_cache
        if isinstance(c, KVCache):
            b = _fsdp_or_none(mesh, c.k.shape[1])
            kv = (None, b, div(c.k.shape[2]), None, None)
            return KVCache(k=kv, v=kv, pos=(None, b))
        if isinstance(c, QuantKVCache):
            b = _fsdp_or_none(mesh, c.k_q.shape[1])
            s_ax = div(c.k_q.shape[2])
            kv = (None, b, s_ax, None, None)
            sc = (None, b, s_ax, None)
            return QuantKVCache(k_q=kv, v_q=kv, k_scale=sc, v_scale=sc,
                                pos=(None, b))
        if isinstance(c, MLACache):
            b = _fsdp_or_none(mesh, c.c_kv.shape[1])
            s = div(c.c_kv.shape[2])
            return MLACache(c_kv=(None, b, s, None),
                            k_rope=(None, b, s, None), pos=(None, b))
        if isinstance(c, MambaCache):
            b = _fsdp_or_none(mesh, c.h.shape[1])
            return MambaCache(h=(None, b, div(c.h.shape[2]), None),
                              conv=(None, b, None, div(c.conv.shape[3])),
                              pos=(None, b))
        if isinstance(c, MLSTMCache):
            b = _fsdp_or_none(mesh, c.C.shape[1])
            dh = div(c.C.shape[3])
            return MLSTMCache(C=(None, b, None, dh, None),
                              n=(None, b, None, dh), m=(None, b, None),
                              conv=(None, b, None, div(c.conv.shape[3])),
                              pos=(None, b))
        if isinstance(c, SLSTMCache):
            b = _fsdp_or_none(mesh, c.c.shape[1])
            dh = div(c.c.shape[3])
            return SLSTMCache(c=(None, b, None, dh),
                              n=(None, b, None, dh),
                              h=(None, b, div(c.h.shape[2])),
                              m=(None, b, None), pos=(None, b))
        raise TypeError(type(c))

    def is_cache(x):
        return isinstance(x, (KVCache, QuantKVCache, MLACache, MambaCache,
                              MLSTMCache, SLSTMCache))

    return tree.map(handle, caches, is_leaf=is_cache)

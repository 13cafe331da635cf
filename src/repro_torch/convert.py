"""Move state between the JAX package and the port as numpy arrays.

The JAX side hands over ``np.asarray`` of its arrays; these functions
build the port's tensors from them on ``device``, the GPU unless the
caller names another (and :func:`to_numpy` goes back), so a test or a tool can start the port from the reference's
exact state and compare the two.  Nothing here imports JAX.
"""
from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from repro_torch import device as devices
from repro_torch.core.tm import TMParams
from repro_torch.data.partition import ClientData
from repro_torch.fl.runtime.engine import EngineState, RuntimeConfig
from repro_torch.fl.runtime.strategy import (FLISAux, FLISClientState,
                                             ServerState)
from repro_torch.optim.adamw import AdamWState


def _t(a, dtype=None, device=None) -> torch.Tensor:
    return torch.as_tensor(np.array(a, dtype=dtype),
                           device=devices.resolve(device))


def key_from_numpy(key, device=None) -> torch.Tensor:
    """A raw uint32 key (..., 2) as the port's int64 word tensor."""
    return _t(np.asarray(key, np.uint32).astype(np.int64), device=device)


def tm_params_from_numpy(ta_state, weights, device=None) -> TMParams:
    return TMParams(ta_state=_t(ta_state, np.int32, device),
                    weights=_t(weights, np.int32, device))


def mlp_params_from_numpy(params: Mapping[str, Any],
                          device=None) -> dict[str, torch.Tensor]:
    """An MLP's ``{w1, b1, w2, b2}`` (any leading axes) as float32."""
    return {k: _t(params[k], np.float32, device)
            for k in ("w1", "b1", "w2", "b2")}


def flis_client_state_from_numpy(params: Mapping[str, Any], prev_slot,
                                 device=None) -> FLISClientState:
    return FLISClientState(mlp_params_from_numpy(params, device),
                           _t(prev_slot, np.int32, device))


def server_state_from_numpy(slots, aux=None, device=None) -> ServerState:
    """The server state; ``aux`` is None (no aux, TPFL, FedTM, FedAvg,
    IFCA) or FLIS's ``(probe, members)``."""
    if aux is None:
        return ServerState(_t(slots, np.float32, device))
    probe, members = aux
    return ServerState(_t(slots, np.float32, device),
                       FLISAux(probe=_t(probe, np.uint8, device),
                               members=_t(members, np.float32, device)))


def client_data_from_numpy(fields: Mapping[str, Any],
                           device=None) -> ClientData:
    """``fields`` maps ClientData's field names to arrays (``sizes`` may
    be missing or None)."""
    dtypes = {"x_train": np.uint8, "x_test": np.uint8, "x_conf": np.uint8,
              "y_train": np.int32, "y_test": np.int32, "y_conf": np.int32,
              "mixtures": np.float32, "sizes": np.int32}
    out = {}
    for name in ClientData._fields:
        a = fields.get(name)
        out[name] = None if a is None else _t(a, dtypes[name], device)
    return ClientData(**out)


BUF_LANES = ("buf_vecs", "buf_slots", "buf_ready", "buf_weight",
             "buf_valid", "buf_seq")


def state_from_numpy(round_idx, client_state, server: ServerState,
                     device=None, *, buf=None, ref_vecs=None, ref_round=None,
                     ef_residual=None) -> EngineState:
    """The engine state around a client state and a server state
    already built by the helpers above, with the round index, the async
    buffer's six lanes (``buf``: a tuple in ``BUF_LANES`` order; None =
    the empty buffer of the default capacity, as ``Engine.init`` makes
    it) and the wire's lanes (``ref_vecs``, ``ref_round``,
    ``ef_residual``; None = the zero-size placeholder of a wire that
    does not track them)."""
    def lane(a, dtype, empty):
        return _t(np.zeros(empty, dtype) if a is None else a, dtype, device)

    if buf is None:
        cap, d = RuntimeConfig.buffer_capacity, server.slots.shape[1]
        buf = (np.zeros((cap, d)), np.full((cap,), -1), np.zeros((cap,)),
               np.zeros((cap,)), np.zeros((cap,)), np.zeros((cap,)))
    dtypes = (np.float32, np.int32, np.int32, np.float32, np.bool_, np.int32)
    return EngineState(
        _t(round_idx, np.int32, device), client_state, server,
        *(_t(a, dt, device) for a, dt in zip(buf, dtypes, strict=True)),
        ref_vecs=lane(ref_vecs, np.float32, (0, 0, 0)),
        ref_round=lane(ref_round, np.int32, (0,)),
        ef_residual=lane(ef_residual, np.float32, (0, 0, 0)))


def engine_state_from_numpy(round_idx, ta_state, weights, server_slots,
                            device=None, **lanes) -> EngineState:
    """The TM engine state: round index, the clients' TM parameters,
    the server slot matrix, and the buffer's and the wire's lanes (see
    :func:`state_from_numpy`)."""
    return state_from_numpy(
        round_idx, tm_params_from_numpy(ta_state, weights, device),
        server_state_from_numpy(server_slots, device=device), device,
        **lanes)


def tensor_from_numpy(a, device=None) -> torch.Tensor:
    """One array as a tensor of its own dtype; a bfloat16 array (an
    ``ml_dtypes`` dtype, which the port never imports) goes through its
    2-byte words."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        words = np.ascontiguousarray(a).view(np.int16)
        return _t(words, device=device).view(torch.bfloat16)
    return _t(a, device=device)


def lm_params_from_numpy(params: Any, device=None) -> Any:
    """The model scaffold's parameter tree (nested dicts, the segments'
    list of tuples) as the reference hands it over, as numpy arrays:
    the same tree of tensors, dtypes kept (bfloat16 and float32)."""
    if isinstance(params, dict):
        return {k: lm_params_from_numpy(v, device) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return type(params)(lm_params_from_numpy(v, device) for v in params)
    return tensor_from_numpy(params, device)


def adamw_state_from_numpy(step, m, v, device=None) -> AdamWState:
    """AdamW's state ``(step, m, v)``: the step as int32, the moments as
    trees like :func:`lm_params_from_numpy`'s."""
    return AdamWState(step=_t(step, np.int32, device),
                      m=lm_params_from_numpy(m, device),
                      v=lm_params_from_numpy(v, device))


def to_numpy(tree):
    """Tensors → numpy arrays, through tuples, lists and dicts."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(to_numpy(v) for v in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(to_numpy(v) for v in tree)
    return tree

"""TPFL-for-NN: the paper's confidence clustering applied to neural
clients.

Counterpart of ``repro/fl/nn_federation.py``.  Confidence is the summed
per-class logit margin on D_conf (the differentiable analogue of the TM
vote margin); each round:

* trunk (w1, b1): clustered mean, members of cluster k average among
  themselves (multi-center FL, as in Alg. 2);
* head: only the ``c_max`` column of the classifier and its bias entry
  are shared and averaged within the cluster (the NN analogue of
  uploading one class's weight vector).

Unlike the TM's disjoint per-class blocks, an NN trunk is shared across
classes, so the upload saving is marginal: the module shows the
technique composes with any per-class-output model.  The whole
population trains as one stacked cohort.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from repro_torch import random as rnd
from repro_torch.core import confidence, mlp
from repro_torch.data.partition import ClientData
from repro_torch.fl.masked_collectives import clustered_mean


@dataclasses.dataclass(frozen=True)
class NNFedConfig:
    n_clients: int = 10
    rounds: int = 5
    local_epochs: int = 2
    n_hidden: int = 64
    lr: float = 0.1
    batch: int = 16


class NNHistory(NamedTuple):
    accuracy: list
    assignments: torch.Tensor          # (rounds, n_clients)
    upload_bytes_per_client_round: int


def run(data: ClientData, cfg: NNFedConfig, key: torch.Tensor, *,
        n_features: int, n_classes: int) -> NNHistory:
    k_init, k_train = rnd.split(key).unbind(0)
    params = mlp.init(rnd.split(k_init, cfg.n_clients), n_features,
                      cfg.n_hidden, n_classes)
    rows = torch.arange(cfg.n_clients, device=key.device)

    accs, assigns = [], []
    for r in range(cfg.rounds):
        ks = rnd.split(rnd.fold_in(k_train, r), cfg.n_clients)
        params = mlp.local_train(params, data.x_train, data.y_train, ks,
                                 epochs=cfg.local_epochs, batch=cfg.batch,
                                 lr=cfg.lr)
        # per-client confidence on D_conf → cluster = most confident class
        conf = confidence.logit_margin_confidence(
            mlp.apply(params, data.x_conf))
        assign = torch.argmax(conf, dim=-1)              # (n_clients,)
        params = dict(params)
        # trunk: clustered mean; members receive their cluster's average
        for name in ("w1", "b1"):
            means = clustered_mean(params[name], assign, n_classes)
            params[name] = means[assign].to(params[name].dtype)
        # head: share only the c_max column / bias entry in the cluster
        w2 = params["w2"].clone()
        col_means = clustered_mean(w2[rows, :, assign], assign, n_classes)
        w2[rows, :, assign] = col_means[assign]
        b2 = params["b2"].clone()
        be_means = clustered_mean(b2[rows, assign], assign, n_classes)
        b2[rows, assign] = be_means[assign]
        params["w2"], params["b2"] = w2, b2

        acc = mlp.accuracy(params, data.x_test, data.y_test).mean()
        accs.append(float(acc))
        assigns.append(assign)

    trunk_bytes = 4 * (n_features * cfg.n_hidden + cfg.n_hidden)
    head_row_bytes = 4 * (cfg.n_hidden + 1)
    return NNHistory(accs, torch.stack(assigns),
                     trunk_bytes + head_row_bytes + 4)

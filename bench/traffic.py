"""The benchmark's one traffic generator: a client population from data.

A configuration file (``configs/<name>.json``) fixes the deployment's
data: image side, classes, the prototype strokes and bit-flip noise of
the synthetic MNIST-family images (the logic of the program's
``synthmnist`` / ``synthfemnist`` generators: each class a prototype of
a few random axis-aligned bars, each sample its class's prototype with
i.i.d. bit flips), and how clients differ (``partition``):

* ``{"kind": "dirichlet", "alpha": a}``: each client's class mixture
  drawn from Dir(a) over the classes (the paper's non-IID split, §6.3);
* ``{"kind": "writers", "mix_alpha": a}``: each client one writer whose
  class mixture is drawn from Dir(a) (LEAF's writer-natural split, as
  the program's LEAF mirror draws a writer's spiked mixture).

A traffic file (``workloads/<name>.json``) fixes the population, the
cohort a round and each client's train / test / confidence split.
Every client's labels come from its mixture and its images from the
prototypes; all of it is drawn from ``--seed``: the small draws
(prototypes, mixtures) on the host with numpy, the labels and images on
the device with one ``torch.Generator`` in a few large calls.
"""
from __future__ import annotations

import numpy as np
import torch

_TAGS = {"protos": 1, "mix": 2}


def _rng(seed: int, tag: str) -> np.random.Generator:
    return np.random.default_rng([int(seed) % (1 << 64), _TAGS[tag]])


def prototypes(data: dict, n_classes: int, seed: int) -> np.ndarray:
    """(C, side·side) bool: each class the union of ``n_strokes`` bars,
    each bar horizontal or vertical, of a length in [side/3, side) and a
    thickness up to ``max_thick``."""
    side, strokes = data["side"], data["n_strokes"]
    rng = _rng(seed, "protos")
    rr, cc = np.mgrid[0:side, 0:side]
    out = np.zeros((n_classes, side, side), bool)
    for c in range(n_classes):
        for _ in range(strokes):
            r0, c0 = rng.integers(0, side, 2)
            length = rng.integers(side // 3, side)
            thick = rng.integers(1, data["max_thick"] + 1)
            if rng.random() < 0.5:
                bar = ((rr >= r0) & (rr < r0 + thick) & (cc >= c0)
                       & (cc < c0 + length))
            else:
                bar = ((cc >= c0) & (cc < c0 + thick) & (rr >= r0)
                       & (rr < r0 + length))
            out[c] |= bar
    return out.reshape(n_classes, -1)


def mixtures(partition: dict, n: int, n_classes: int, seed: int
             ) -> np.ndarray:
    """(n, C) float64 class mixtures, Dir(alpha) drawn in log space
    (``log G = log Gamma(a + 1) + log(U) / a``) so that small alphas
    never underflow to an all-zero row."""
    alpha = partition["alpha" if partition["kind"] == "dirichlet"
                      else "mix_alpha"]
    rng = _rng(seed, "mix")
    g = (np.log(rng.gamma(alpha + 1.0, size=(n, n_classes)))
         + np.log(rng.random((n, n_classes))) / alpha)
    g -= g.max(-1, keepdims=True)
    p = np.exp(g)
    return p / p.sum(-1, keepdims=True)


def make(config: dict, workload: dict, seed: int, device) -> dict:
    """The population's splits on ``device``: ``x_*`` (N, S, o) uint8 0/1,
    ``y_*`` (N, S) int32, ``mixtures`` (N, C) float32."""
    data, C = config["data"], config["tm"]["n_classes"]
    n = workload["population"]
    split = workload["per_client"]
    protos = torch.from_numpy(prototypes(data, C, seed)).to(device)
    mix = mixtures(config["partition"], n, C, seed)
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (1 << 63))
    total = split["train"] + split["test"] + split["conf"]
    y = torch.multinomial(torch.from_numpy(mix).to(device, torch.float32),
                          total, replacement=True, generator=g)
    noise = torch.rand((n, total, protos.shape[1]), generator=g,
                       device=device) < data["flip"]
    x = (protos[y] ^ noise).to(torch.uint8)
    y = y.to(torch.int32)
    a, b = split["train"], split["train"] + split["test"]
    return {"x_train": x[:, :a].contiguous(), "y_train": y[:, :a].contiguous(),
            "x_test": x[:, a:b].contiguous(), "y_test": y[:, a:b].contiguous(),
            "x_conf": x[:, b:].contiguous(), "y_conf": y[:, b:].contiguous(),
            "mixtures": torch.from_numpy(mix.astype(np.float32)).to(device)}

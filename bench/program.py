"""The TPFL kind: ``repro_torch``'s round engine, driven in cycles.

A configuration without a ``program`` key runs here; ``bench/run.py``
takes from this module what every kind gives: ``make_inputs``,
``Program`` (``steps``, ``samples``, ``obs``, ``cycle``, ``outcome``,
``close``), ``capture`` and ``check``.  A step is a round.

The window drives ``Engine.run_round`` with ``TPFLStrategy`` and the
in-process executor: sync aggregation, the float32 identity wire,
uniform sampling of the cohort, every upload arriving.  A cycle is the
configuration's rounds (``fed_train``'s default of 5) from the state
set-up made, under the same round keys, so every cycle does the same
work: a program that learns faster never reaches cheaper rounds.

The engine never writes its state in place, so the state set-up made
would stay valid as it is; to keep one population copy fewer resident,
set-up keeps its TA states as int8 (every state lies in [1, 2·n_states]
and n_states < 64) and each cycle begins by widening that copy to a
fresh int32 population: one device copy a cycle, part of the window.
"""
from __future__ import annotations

import importlib

import torch

from bench import threefry, traffic

make_inputs = traffic.make


class Program:
    def __init__(self, config: dict, workload: dict, inputs: dict,
                 seed: int, device):
        from repro_torch import random as rnd
        from repro_torch.core import tm
        from repro_torch.data.partition import ClientData
        from repro_torch.fl.runtime import (Engine, RuntimeConfig,
                                            SchedulerConfig, TPFLStrategy)
        t = config["tm"]
        if t["n_states"] >= 64:
            raise ValueError("the int8 copy of set-up's state needs "
                             "n_states < 64")
        self.steps = workload["rounds_per_cycle"]
        # client training samples a cycle: cohort x local samples x epochs
        # of every round
        self.samples = (self.steps * workload["cohort"]
                        * workload["per_client"]["train"]
                        * t["local_epochs"])
        tm_cfg = tm.TMConfig(n_classes=t["n_classes"],
                             n_clauses=t["n_clauses"],
                             n_features=t["n_features"],
                             n_states=t["n_states"], s=float(t["s"]),
                             T=t["T"])
        strategy = TPFLStrategy(tm_cfg, local_epochs=t["local_epochs"])
        data = ClientData(**inputs)
        n, k = workload["population"], workload["cohort"]
        sched = SchedulerConfig(participation=k / n)
        self.engine = Engine(strategy, data,
                             RuntimeConfig(rounds=self.steps,
                                           scheduler=sched))
        if self.engine.scheduler.k != k:
            raise ValueError(f"the scheduler samples "
                             f"{self.engine.scheduler.k} clients, the "
                             f"traffic asks for {k}")
        key = threefry.key(seed, device)
        k_init, k_rounds = rnd.split(key).unbind(0)
        state0 = self.engine.init(k_init)
        ta = state0.client_state.ta_state
        self._ta8 = ta.to(torch.int8)
        self._state0 = state0._replace(client_state=state0.client_state
                                       ._replace(ta_state=ta[:0]))
        del state0, ta
        self.keys = [rnd.fold_in(k_rounds, r) for r in range(self.steps)]

    @property
    def obs(self):
        """The engine's telemetry, where the window's spans go."""
        return self.engine.obs

    @obs.setter
    def obs(self, telemetry):
        self.engine.obs = telemetry

    def start(self):
        """A fresh copy of set-up's state."""
        cs = self._state0.client_state
        return self._state0._replace(client_state=cs._replace(
            ta_state=self._ta8.to(torch.int32)))

    def cycle(self, on_step=None):
        """One cycle from set-up's state; ``on_step(r, state, report)``
        sees each round's output.  Returns the last report."""
        state = self.start()
        rep = None
        for r, key in enumerate(self.keys):
            state, rep = self.engine.run_round(state, key)
            if on_step is not None:
                on_step(r, state, rep)
        return rep

    @staticmethod
    def outcome(rep) -> tuple:
        """A round's accuracies and cluster counts, copied to the host:
        every cycle repeats the same work, so its last round's must
        repeat bit for bit."""
        return rep.per_client_accuracy.cpu(), rep.cluster_counts.cpu()

    def close(self):
        self.engine = self._state0 = self._ta8 = None


def capture(workload: dict, r: int, state, rep) -> dict | None:
    """What the check compares of round ``r``, read off the program's
    output state and report and copied to the host, so later rounds
    cannot touch it and the card holds none of it; ``None`` for a round
    past the workload's ``reference_rounds``."""
    if r >= workload["reference_rounds"]:
        return None
    cs = state.client_state
    idx = rep.participation.idx.to(torch.int64)
    return {
        "idx": idx.cpu(), "acc": rep.per_client_accuracy.cpu(),
        "assignment": rep.assignment.cpu(),
        "counts": rep.cluster_counts.cpu(),
        "server": state.server.slots.cpu(),
        "upload_bytes": rep.upload_bytes,
        "download_bytes_broadcast": rep.download_bytes_broadcast,
        "download_bytes_per_client": rep.download_bytes_per_client,
        "aggregated_uploads": int(rep.aggregated_uploads),
        "cohort_ta": cs.ta_state[idx].cpu(),
        "w": cs.weights.cpu(),
        "ta_rowsum": row_sums(cs.ta_state).cpu(),
    }


def row_sums(ta: torch.Tensor) -> torch.Tensor:
    """Each client's TA-state sum, int64, without a widened copy of the
    population: int32 sums over the literals first (at most 2L · 127)."""
    return ta.sum(-1, dtype=torch.int32).flatten(1).sum(-1,
                                                       dtype=torch.int64)


def check(config: dict, workload: dict, inputs: dict, seed: int, device,
          captured: list, cycles_differing: int) -> dict:
    """The plain reference (the configuration's ``reference`` module,
    float32 with TF32 off) follows the checked cycle's first
    ``reference_rounds`` rounds from the same inputs and key;
    ``bench/check.py``'s numbers, summed over them, every limit 0."""
    from bench.check import add, compare
    ref = importlib.import_module(f"bench.{config['reference']}")
    torch.backends.cuda.matmul.allow_tf32 = False
    tm = ref.TM.of(config)
    key = threefry.key(seed, device)
    st = ref.init_state(tm, key, workload["population"])
    numbers = None
    for r in range(workload["reference_rounds"]):
        st, want = ref.run_round(tm, st, inputs, key, r, workload["cohort"])
        numbers = add(numbers, compare(captured[r], want,
                                       cycles_differing if r == 0 else 0))
    return numbers

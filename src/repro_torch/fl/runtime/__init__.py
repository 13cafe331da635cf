"""Federated runtime: scheduler, strategies, wire codec, round engine.

Counterpart of ``repro/fl/runtime``: ``scheduler`` (who takes part),
``strategy`` (what a round means), ``codec`` (the bytes on the wire),
``executors`` (where the compute runs), ``engine`` (the round) and
``checkpointing`` (round checkpoints).  The port runs TPFL, FedTM and
the DL baselines (FedAvg / FedProx, IFCA, FLIS-DC / HC), sync or async,
under any scheduler setting, on every wire codec, in process, over a
resident population or the mmap client store (``repro_torch.fl.store``).
"""
from repro_torch.fl.runtime.codec import CodecConfig          # noqa: F401
from repro_torch.fl.runtime.engine import (                   # noqa: F401
    Engine, EngineState, RoundReport, RuntimeConfig)
from repro_torch.fl.runtime.scheduler import (                # noqa: F401
    Participation, Scheduler, SchedulerConfig)
from repro_torch.fl.runtime.strategy import (                 # noqa: F401
    FedAvgStrategy, FedTMStrategy, FLISAux, FLISClientState, FLISStrategy,
    IFCAStrategy, MLPStrategyBase, ServerState, TPFLStrategy, Upload,
    build_baseline_strategy, default_server_update, resolve_server_update)

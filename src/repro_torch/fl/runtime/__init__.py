"""Federated runtime: scheduler, strategies, wire codec, round engine.

Counterpart of ``repro/fl/runtime``: ``scheduler`` (who takes part),
``strategy`` (what a round means), ``codec`` (the bytes on the wire),
``executors`` (where the compute runs), ``engine`` (the round) and
``checkpointing`` (round checkpoints).  The port runs TPFL, FedTM and
the DL baselines (FedAvg / FedProx, IFCA, FLIS-DC / HC), sync or async,
under any scheduler setting, on every wire codec, in process or
shard-mapped over a ``torch.distributed`` clients mesh
(``ShardMapExecutor``, ``repro_torch.launch.mesh``), over a resident
population or the mmap client store (``repro_torch.fl.store``).  The
reference's ``build_sharded_round`` / ``build_sharded_async_update``
build ``shard_map`` programs for its dry run to lower; here the same
rounds are the executor's ``fused_sync_round`` and ``async_update``,
and the federated dry run (``repro_torch.launch.fed_dryrun``) prices
their collectives analytically from the abstract round inputs.
"""
from repro_torch.fl.runtime.codec import CodecConfig          # noqa: F401
from repro_torch.fl.runtime.engine import (                   # noqa: F401
    BACKENDS, Engine, EngineState, RoundReport, RuntimeConfig)
from repro_torch.fl.runtime.executors import (                # noqa: F401
    COLLECTIVES, InProcessExecutor, ShardMapExecutor)
from repro_torch.fl.runtime.scheduler import (                # noqa: F401
    Participation, Scheduler, SchedulerConfig)
from repro_torch.fl.runtime.strategy import (                 # noqa: F401
    FedAvgStrategy, FedTMStrategy, FLISAux, FLISClientState, FLISStrategy,
    IFCAStrategy, MLPStrategyBase, ServerState, Strategy, TPFLStrategy,
    Upload, build_baseline_strategy, default_server_update,
    ensure_server_state, resolve_server_update)

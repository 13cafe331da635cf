"""Round-granular checkpoint/resume for the federated engine.

Counterpart of ``repro/fl/runtime/checkpointing.py`` over
:mod:`repro_torch.checkpoint.ckpt`: an :class:`EngineState` (round
counter, client population, server slots, the async buffer's lanes,
the sparse wire's reference lanes and the error-feedback residuals) is
one tree, so a checkpoint is one msgpack tensor store named by the round
it starts.  The engine keys round r with ``fold_in(k_rounds, r)`` on the
absolute round index, so a resumed run, async or lossy, is bit-identical
to the uninterrupted one.  A telemetry run's manifest rides along as
``manifest.json``, an mmap run's store manifest as
``store_manifest.json``.

    engine = Engine(strategy, data, cfg)
    like = engine.init(rnd.PRNGKey(0, device))      # structure template
    state = checkpointing.restore(checkpointing.latest(d), like)
    engine.run(key, state=state)
"""
from __future__ import annotations

import json
import pathlib
import re

from repro_torch.checkpoint import ckpt
from repro_torch.fl.obs.manifest import write_manifest

_PAT = re.compile(r"round_(\d+)\.msgpack$")
MANIFEST_NAME = "manifest.json"
STORE_MANIFEST_NAME = "store_manifest.json"


def path_for(directory: str | pathlib.Path, round_idx: int) -> pathlib.Path:
    return pathlib.Path(directory) / f"round_{round_idx:06d}.msgpack"


def save(directory: str | pathlib.Path, state,
         manifest: dict | None = None,
         store_manifest: dict | None = None) -> pathlib.Path:
    """Persist ``state``; the filename records the next round to run.
    ``manifest`` (the telemetry run manifest) is written beside it as
    ``manifest.json``: provenance only, ``restore`` never reads it.

    ``store_manifest`` (the mmap engine's ``ClientStore.manifest``) is
    written the same way as ``store_manifest.json``, the reference's
    bytes: an mmap checkpoint is only the replicated state, the rows
    live in the store directory, and this records the store layout the
    checkpoint expects.  Resume is valid at the latest checkpoint only:
    store rows advance in place past older ones."""
    path = path_for(directory, int(state.round_idx))
    ckpt.save(path, state)
    if manifest is not None:
        write_manifest(path.parent, manifest)
    if store_manifest is not None:
        (path.parent / STORE_MANIFEST_NAME).write_text(
            json.dumps(store_manifest, indent=2, sort_keys=True) + "\n")
    return path


def latest(directory: str | pathlib.Path) -> pathlib.Path | None:
    """Newest checkpoint in ``directory`` (highest round), or None."""
    d = pathlib.Path(directory)
    if not d.is_dir():
        return None
    best, best_r = None, -1
    for p in d.iterdir():
        m = _PAT.search(p.name)
        if m and int(m.group(1)) > best_r:
            best, best_r = p, int(m.group(1))
    return best


def restore(path: str | pathlib.Path, like):
    """Rebuild an :class:`EngineState` from ``path`` into the structure of
    ``like`` (e.g. a fresh ``engine.init(...)`` state); layout drift is
    refused with the drifted leaf named."""
    try:
        return ckpt.restore(path, like)
    except (KeyError, ValueError) as e:
        raise ValueError(
            f"checkpoint {path} does not match the current engine state "
            f"layout: {e}.  The server state is strategy-owned "
            f"(ServerState.slots + aux) — restoring a checkpoint from a "
            f"different strategy, --max-slots, or aux layout is refused "
            f"rather than silently coerced.  Re-run with the original "
            f"strategy/config, or start fresh without --resume."
        ) from e

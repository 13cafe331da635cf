"""Run manifests: the provenance record every telemetry run carries.

Counterpart of ``repro/fl/obs/manifest.py``.  One ``manifest.json`` per
run directory, written before the first round: the resolved
configuration (``RuntimeConfig`` with its scheduler and codec, dataclasses
flattened), the seed, the clients mesh (``{axis: ranks}``, None in
process), the device inventory, the git sha the run was
built from, and the torch and CUDA versions (where the reference records
jax's).  The same dict rides along with engine checkpoints
(:func:`repro_torch.fl.runtime.checkpointing.save`).
"""
from __future__ import annotations

import dataclasses
import json
import pathlib
import platform
import subprocess
import sys
from typing import Any

import torch

from repro_torch.fl.obs.events import to_jsonable

MANIFEST_NAME = "manifest.json"
EVENTS_NAME = "events.jsonl"


def git_sha(cwd: str | pathlib.Path | None = None) -> str | None:
    """Best-effort ``git rev-parse HEAD``; None outside a checkout."""
    try:
        res = subprocess.run(
            ["git", "rev-parse", "HEAD"],
            cwd=str(cwd) if cwd else None,
            capture_output=True, text=True, timeout=10)
    except (OSError, subprocess.TimeoutExpired):
        return None
    sha = res.stdout.strip()
    return sha if res.returncode == 0 and sha else None


def _flatten_config(obj: Any) -> Any:
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return {f.name: _flatten_config(getattr(obj, f.name))
                for f in dataclasses.fields(obj)}
    return obj


def build_manifest(config: Any = None, seed: int | None = None,
                   device=None, extra: dict | None = None,
                   mesh=None) -> dict:
    """The provenance dict.  ``config`` is any dataclass (nested ones are
    flattened); ``device`` the run's device (``platform`` is ``gpu`` for
    a CUDA device, else ``cpu``); ``mesh`` the run's clients mesh (a
    :class:`~repro_torch.launch.mesh.ClientsMesh`) or None in process;
    ``extra`` free-form caller fields (CLI argv, dataset name,
    strategy...)."""
    dev = torch.device(device) if device is not None else None
    n_gpus = torch.cuda.device_count() if torch.cuda.is_available() else 0
    manifest = {
        "config": _flatten_config(config),
        "seed": seed,
        "mesh": ({str(k): int(v) for k, v in mesh.shape.items()}
                 if mesh is not None else None),
        "devices": {
            "count": n_gpus,
            "platform": (None if dev is None
                         else "gpu" if dev.type == "cuda" else "cpu"),
            "names": [torch.cuda.get_device_name(i) for i in range(n_gpus)],
        },
        "git_sha": git_sha(pathlib.Path(__file__).resolve().parents[4]),
        "torch_version": torch.__version__,
        "cuda_version": torch.version.cuda,
        "python_version": sys.version.split()[0],
        "host_platform": platform.platform(),
    }
    if extra:
        manifest.update(extra)
    return to_jsonable(manifest)


def write_manifest(run_dir: str | pathlib.Path,
                   manifest: dict) -> pathlib.Path:
    run_dir = pathlib.Path(run_dir)
    run_dir.mkdir(parents=True, exist_ok=True)
    path = run_dir / MANIFEST_NAME
    path.write_text(json.dumps(to_jsonable(manifest), indent=2,
                               sort_keys=True) + "\n")
    return path


def read_manifest(run_dir: str | pathlib.Path) -> dict | None:
    path = pathlib.Path(run_dir) / MANIFEST_NAME
    if not path.is_file():
        return None
    return json.loads(path.read_text())

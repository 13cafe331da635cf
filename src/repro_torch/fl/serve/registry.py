"""Versioned model registry — the artifact store the serving plane
pulls from.

Counterpart of ``repro/fl/serve/registry.py``.  A registry directory
holds immutable versions, one per training-round checkpoint, under the
filename scheme :mod:`repro_torch.fl.runtime.checkpointing` writes::

    round_000002.msgpack (+ .sha256)    # version 2: the engine state
    round_000004.msgpack (+ .sha256)    # version 4 supersedes it

* **publish** stages the checkpoint bytes to a ``.part`` temp in the
  registry, hashes them, renames atomically into place, and writes the
  ``.sha256`` sidecar last — a crashed publish leaves a ``.part`` ruin,
  never a half-valid version.  Re-publishing an existing version is a
  no-op when the bytes match and a loud :class:`RegistryError` when
  they don't (versions are immutable).
* **pull** requires the sidecar, re-hashes the payload against it
  (:class:`ChecksumError` on a mismatch), and only then decodes through
  :func:`repro_torch.fl.runtime.checkpointing.restore`, which rejects
  layout drift naming the offending leaf and both dtype/shape pairs.

The sidecar helpers are the reference's (``repro/data/ingest/idx.py``),
copied.  The reference's provenance manifest does not ride along: the
port writes none.
"""
from __future__ import annotations

import hashlib
import pathlib
import re
import shutil

from repro_torch.fl.runtime import checkpointing

_PAT = re.compile(r"round_(\d+)\.msgpack$")


class RegistryError(RuntimeError):
    """Publish/pull failure — nothing was placed or served."""


class ChecksumError(ValueError):
    """A file does not match its recorded sha256 sidecar."""


def sha256_file(path: str | pathlib.Path) -> str:
    return hashlib.sha256(pathlib.Path(path).read_bytes()).hexdigest()


def checksum_path(path: str | pathlib.Path) -> pathlib.Path:
    path = pathlib.Path(path)
    return path.with_name(path.name + ".sha256")


def write_checksum(path: str | pathlib.Path) -> pathlib.Path:
    """Record ``sha256(stored bytes)`` in the file's sidecar."""
    side = checksum_path(path)
    side.write_text(sha256_file(path) + "\n")
    return side


def verify_bytes(path: str | pathlib.Path, buf: bytes) -> None:
    """Check ``buf`` (the stored bytes of ``path``, already in memory)
    against the sidecar digest, if one exists."""
    side = checksum_path(path)
    if not side.exists():
        return
    want = side.read_text().strip()
    got = hashlib.sha256(buf).hexdigest()
    if got != want:
        raise ChecksumError(
            f"checksum mismatch for {path}: sidecar {want[:12]}…, "
            f"file {got[:12]}… — if the file is corrupt, delete it and "
            f"re-fetch; if you deliberately replaced it (e.g. real data "
            f"over a mirror file), delete the stale {side.name!r} "
            f"sidecar")


def _version_name(version: int) -> str:
    return f"round_{int(version):06d}.msgpack"


class ModelRegistry:
    """Immutable versioned checkpoint store under ``root``."""

    def __init__(self, root: str | pathlib.Path):
        self.root = pathlib.Path(root)
        self.root.mkdir(parents=True, exist_ok=True)

    def versions(self) -> list[int]:
        """All published versions (training round indices), ascending."""
        out = []
        for p in self.root.iterdir():
            m = _PAT.search(p.name)
            if m:
                out.append(int(m.group(1)))
        return sorted(out)

    def latest(self) -> int | None:
        vs = self.versions()
        return vs[-1] if vs else None

    def path_for(self, version: int) -> pathlib.Path:
        return self.root / _version_name(version)

    def publish(self, src: str | pathlib.Path) -> int:
        """Place checkpoint file ``src`` into the registry as the
        version its filename names; returns that version.

        Verify-then-place: copy to a ``.part`` temp inside the registry
        (same filesystem, so the final ``rename`` is atomic), sidecar
        written only after the payload is in place.  Idempotent for
        identical bytes; immutable otherwise."""
        src = pathlib.Path(src)
        m = _PAT.search(src.name)
        if m is None:
            raise RegistryError(
                f"{src} is not a round checkpoint (expected "
                f"round_NNNNNN.msgpack) — the registry versions by "
                f"training round")
        if not src.is_file():
            raise RegistryError(f"{src} does not exist — nothing published")
        version = int(m.group(1))
        dest = self.path_for(version)
        digest = hashlib.sha256(src.read_bytes()).hexdigest()
        if dest.exists():
            placed = hashlib.sha256(dest.read_bytes()).hexdigest()
            if placed != digest:
                raise RegistryError(
                    f"version {version} already published in {self.root} "
                    f"with different bytes (placed sha256 "
                    f"{placed[:12]}…, incoming {digest[:12]}…) — "
                    f"versions are immutable; a changed round "
                    f"{version} checkpoint means the training run "
                    f"diverged, publish under a fresh registry")
            return version
        tmp = dest.with_name(dest.name + ".part")
        shutil.copyfile(src, tmp)
        if hashlib.sha256(tmp.read_bytes()).hexdigest() != digest:
            tmp.unlink()
            raise RegistryError(
                f"{src}: bytes changed while staging into {self.root} — "
                f"nothing published")
        tmp.rename(dest)
        write_checksum(dest)
        return version

    def pull(self, version: int, like):
        """Verified state for ``version``, decoded into the structure of
        ``like`` (a fresh ``engine.init(...)`` state).

        Fails loudly on every tamper mode: missing version, missing
        sidecar, flipped sidecar or payload byte (:class:`ChecksumError`),
        and layout drift (``ValueError`` naming the drifted leaf)."""
        path = self.path_for(version)
        if not path.is_file():
            raise RegistryError(
                f"version {version} is not in the registry {self.root} "
                f"(have {self.versions()})")
        side = checksum_path(path)
        if not side.is_file():
            raise RegistryError(
                f"{path} has no .sha256 sidecar — the registry never "
                f"places a version without one, so this file did not go "
                f"through publish(); refusing to serve it")
        verify_bytes(path, path.read_bytes())
        return checkpointing.restore(path, like)

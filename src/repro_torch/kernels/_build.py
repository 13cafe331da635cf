"""Build and load the CUDA kernels: ``nvcc`` into plain-C shared
libraries, bound with ``ctypes``.

Each ``csrc/<name>.cu`` compiles on first use into
``build/kernels/lib<name>-<hash>.so`` at the repository root (the hash
is the source's and the headers', so an edited kernel is rebuilt), for
``sm_90a`` and without fast math.  Nothing here runs at import: a CPU-only host imports
the package and never reaches ``nvcc``.

``LAUNCHES`` counts the launches of each kernel; a wrapper adds one right
after its kernel was launched and accepted, and nowhere else.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().with_name("csrc")
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = ("clause_eval", "ta_update", "train_epoch")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I = ctypes.c_void_p, ctypes.c_int
_LL = ctypes.c_longlong
_SIGNATURES = {
    "clause_outputs": ("clause_eval", [_P] * 3 + [_I] * 5 + [_P]),
    # planes; shape; wpol strides; predict; stream
    "fused_votes": ("clause_eval", [_P] * 4 + [_I] * 4 + [_LL] * 2
                    + [_I, _P]),
    "fused_votes_batched": ("clause_eval", [_P] * 4 + [_I] * 5 + [_LL] * 3
                            + [_I, _P]),
    # in place: ta, inputs, keys, scratch; shape; row strides, scratch
    # words; n_states, T, thresholds; stream
    "ta_update": ("ta_update", [_P] * 7 + [_I] * 4 + [_LL] * 4 + [_I] * 4
                  + [_P]),
    # outputs, inputs, keys; shape, n_states, T, thresholds; stream
    "train_epoch_fused": ("train_epoch", [_P] * 7 + [_I] * 9 + [_P]),
}
# entry points that launch nothing (not counted)
_QUERIES = {
    "votes_plan": ("clause_eval", [_I] * 6 + [_P]),
    "train_epoch_plan": ("train_epoch", [_I] * 4 + [_P]),
    "ta_update_plan": ("ta_update", [_I] * 4 + [_LL, _I, _P]),
}

LAUNCHES = {fn: 0 for fn in _SIGNATURES}
_LIBS: dict[str, ctypes.CDLL] = {}
_FUNCS: dict[str, ctypes._CFuncPtr] = {}


def nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    for cand in (Path(home) / "bin" / "nvcc", shutil.which("nvcc")):
        if cand and Path(cand).is_file():
            return str(cand)
    raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                       "are built on the machine with the GPU")


def library_path(name: str) -> Path:
    digest = hashlib.sha256(
        (CSRC / f"{name}.cu").read_bytes()
        + b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.h")))
        + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:12]}.so"


def build(names=SOURCES) -> dict[str, dict]:
    """Compile every missing library, one ``nvcc`` per source, all
    started together.  Returns ``{name: {"seconds", "log"}}`` (the log
    holds ``ptxas -v``'s register and shared-memory report); raises with
    the compiler's output if a source does not build."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    running = {}
    t0 = time.perf_counter()
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        running[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True), tmp, out)
    done = {}
    for name, (proc, tmp, out) in running.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            for other, _, _ in running.values():
                if other.poll() is None:
                    other.kill()
                    other.wait()
            raise RuntimeError(f"nvcc failed on csrc/{name}.cu:\n{log}")
        tmp.replace(out)
        done[name] = {"seconds": time.perf_counter() - t0, "log": log}
    return done


def function(fn: str):
    """The C entry point ``fn``, building its library on first use; bound
    once, with its argument types, and kept."""
    f = _FUNCS.get(fn)
    if f is not None:
        return f
    source, argtypes = _SIGNATURES.get(fn) or _QUERIES[fn]
    lib = _LIBS.get(source)
    if lib is None:
        path = library_path(source)
        if not path.exists():
            build([source])
        lib = _LIBS[source] = ctypes.CDLL(str(path))
    f = getattr(lib, fn)
    f.argtypes, f.restype = argtypes, ctypes.c_int
    _FUNCS[fn] = f
    return f


def check(fn: str, err: int) -> None:
    """Raise on a refused launch; otherwise count it."""
    if err != 0:
        raise RuntimeError(f"{fn}: CUDA error {err} at launch")
    LAUNCHES[fn] += 1

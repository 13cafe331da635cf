"""Fetch-and-verify for the real MNIST-family archives.

A copy of ``repro/data/ingest/fetch.py`` (numpy-free, standard library
only), so the port places real files without importing the JAX package.

The registry reads whatever IDX files sit in the cache
(``<data_dir>/<name>/``): the offline mirror writes synthetic stand-ins,
and real files dropped into the same layout are used as they are.  This
module is the "drop in the real files" step for a host with network:
download the official archives, verify each against its pinned sha256,
and only then place it into the cache with the ``.sha256`` sidecar
:mod:`repro_torch.data.ingest.idx` checks on every read.  A corrupted
download never touches the cache: verification runs on a temporary
file, placement is an atomic rename.

:func:`fetch` takes URL overrides per file, ``file://`` URLs included,
so the whole path runs without a socket (the tests use only those):

    from repro_torch.data.ingest import fetch
    fetch.fetch("mnist", "~/tpfl-data")          # downloads + verifies
    # then: python -m repro_torch.launch.fed_train --dataset mnist \
    #           --data-dir ~/tpfl-data

The pinned digests are of the gzip archives as the official mirrors
serve them.  If a mirror re-compresses its archives, :func:`fetch`
fails loudly with both digests.
"""
from __future__ import annotations

import hashlib
import pathlib
import shutil
import tempfile
import urllib.request

from repro_torch.data.ingest import idx

#: Official archive sources.  Multiple URLs per file = mirror fallback,
#: tried in order.
MNIST_BASES = (
    "https://ossci-datasets.s3.amazonaws.com/mnist/",
    "https://storage.googleapis.com/cvdf-datasets/mnist/",
)
FASHION_BASES = (
    "http://fashion-mnist.s3-website.eu-central-1.amazonaws.com/",
)

#: name → {filename: sha256-of-the-.gz-archive}
ARCHIVES: dict[str, dict[str, str]] = {
    "mnist": {
        "train-images-idx3-ubyte.gz":
            "440fcabf73cc546fa21475e81ea370265605f56be210a4024d2ca8"
            "f203523609",
        "train-labels-idx1-ubyte.gz":
            "3552534a0a558bbed6aed32b30c495cca23d567ec52cac8be1a0730"
            "e8010255c",
        "t10k-images-idx3-ubyte.gz":
            "8d422c7b0a1c1c79245a5bcf07fe86e33eeafee792b84584aec276f"
            "5a2dbc4e6",
        "t10k-labels-idx1-ubyte.gz":
            "f7ae60f92e00ec6debd23a6088c31dbd2371eca3ffa0defaefb2599"
            "24204aec6",
    },
    "fashionmnist": {
        "train-images-idx3-ubyte.gz":
            "3aede38d61863908ad78613f6a32ed271626dd12800ba2636569512"
            "369268a84",
        "train-labels-idx1-ubyte.gz":
            "a04f17134ac03560a47e3764e11b92fc97de4d1bfaf8ba1a3aa29af"
            "54cc90845",
        "t10k-images-idx3-ubyte.gz":
            "346e55b948d973a97e58d2351dde16a484bd415d4595297633bb08f"
            "03db6a073",
        "t10k-labels-idx1-ubyte.gz":
            "67da17c76eaffca5446c3361aaab5c3cd6d1c2608764d35dfb1850b"
            "086bf8dd5",
    },
}

_BASES = {"mnist": MNIST_BASES, "fashionmnist": FASHION_BASES}


class FetchError(RuntimeError):
    """Download or verification failure — nothing was placed."""


def sha256_path(path: str | pathlib.Path) -> str:
    return hashlib.sha256(pathlib.Path(path).read_bytes()).hexdigest()


def verify_file(path: str | pathlib.Path, expect: str) -> None:
    """Raise :class:`FetchError` unless ``sha256(path) == expect``."""
    got = sha256_path(path)
    if got != expect:
        raise FetchError(
            f"{path}: sha256 mismatch — expected {expect}, got {got}.  "
            f"The download is corrupted or the upstream archive changed; "
            f"nothing was placed into the cache.")


def place(src: str | pathlib.Path, data_dir: str | pathlib.Path,
          name: str, filename: str,
          expect: str | None = None) -> pathlib.Path:
    """Verify ``src`` (when ``expect`` is given) and move it into the
    cache layout the registry reads: ``<data_dir>/<name>/<filename>``
    plus the ``.sha256`` sidecar ``idx.read`` checks.  Atomic: verify
    first, ``rename`` into place, sidecar last.  Refuses to overwrite
    an existing cache file (delete it yourself if you mean it)."""
    src = pathlib.Path(src)
    if expect is not None:
        verify_file(src, expect)
    dest = pathlib.Path(data_dir).expanduser() / name / filename
    if dest.exists():
        raise FetchError(
            f"{dest} already exists — refusing to overwrite a cache "
            f"file (it may be a mirror stand-in or an earlier real "
            f"download; remove it and its .sha256 sidecar first)")
    dest.parent.mkdir(parents=True, exist_ok=True)
    tmp = dest.with_name(dest.name + ".part")
    shutil.move(str(src), tmp)
    tmp.rename(dest)
    idx.write_checksum(dest)
    return dest


def _download(url: str, dest: pathlib.Path, timeout: float) -> None:
    with urllib.request.urlopen(url, timeout=timeout) as r, \
            open(dest, "wb") as f:
        shutil.copyfileobj(r, f)


def fetch(name: str, data_dir: str | pathlib.Path, *,
          urls: dict[str, str] | None = None,
          timeout: float = 60.0) -> list[pathlib.Path]:
    """Download every archive of dataset ``name`` (``mnist`` /
    ``fashionmnist``), verify each against its pinned sha256, and place
    the verified files into ``<data_dir>/<name>/``.  ``urls`` overrides
    the source per filename (``file://`` works — how the offline tests
    exercise this path).  Resumable: a cache file whose sha256 matches
    the pin is skipped; one that does not (an offline-mirror stand-in
    written under the same name, or a corrupted earlier download) fails
    loudly — never silently accepted as the real archive."""
    if name not in ARCHIVES:
        raise ValueError(
            f"no pinned archives for {name!r}; choose from "
            f"{tuple(ARCHIVES)} (femnist/LEAF has no single official "
            f"archive — generate it with the LEAF toolchain)")
    placed = []
    root = pathlib.Path(data_dir).expanduser() / name
    with tempfile.TemporaryDirectory() as td:
        for filename, digest in ARCHIVES[name].items():
            existing = root / filename
            if existing.exists():
                # resumable only if the existing file IS the pinned
                # archive — a synthetic mirror stand-in under the same
                # name must not masquerade as verified real data
                try:
                    verify_file(existing, digest)
                except FetchError as e:
                    raise FetchError(
                        f"{existing} exists but is not the pinned "
                        f"archive (an offline-mirror stand-in or a "
                        f"corrupted download?) — remove it and its "
                        f".sha256 sidecar, then re-run fetch.  {e}"
                    ) from e
                continue
            candidates = ([urls[filename]] if urls and filename in urls
                          else [b + filename for b in _BASES[name]])
            tmp = pathlib.Path(td) / filename
            last_err: Exception | None = None
            for url in candidates:
                try:
                    _download(url, tmp, timeout)
                    last_err = None
                    break
                except OSError as e:          # URLError subclasses OSError
                    last_err = e
            if last_err is not None:
                raise FetchError(
                    f"could not download {filename} from any of "
                    f"{candidates}: {last_err}") from last_err
            placed.append(place(tmp, data_dir, name, filename,
                                expect=digest))
    return placed

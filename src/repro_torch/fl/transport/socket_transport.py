"""SocketTransport: real multi-process federated runs over local TCP.

Counterpart of ``repro/fl/transport/socket_transport.py``.  The server
listens on an ephemeral ``127.0.0.1`` port and launches M worker
subprocesses (``repro_torch.fl.transport.worker``), each of which
rebuilds its identical slice of the scenario from a JSON spec on the
spec's device (on a GPU host every worker opens its own context on the
server's card), connects back, and introduces itself with a HELLO
frame.  From then on every round's WORK/UPLOAD/DOWNLINK/EVAL exchange
crosses a real kernel socket as length-prefixed frames — dropout is a
missing upload entry, staleness is a frame that arrives rounds after it
was produced, and the wire gauges count bytes that actually moved
between processes.

Failure behaviour is loud: a worker that dies during launch surfaces
its exit code; a ``recv`` past the policy timeout raises
``TimeoutError`` for the runner's retry loop; a peer closing mid-frame
raises the typed framing errors.
"""
from __future__ import annotations

import json
import os
import pathlib
import socket
import subprocess
import sys
import tempfile
import time

from repro_torch.fl.transport import framing
from repro_torch.fl.transport.messages import Hello, MsgKind


def _recv_exact(conn: socket.socket):
    def inner(n: int) -> bytes:
        chunks, remaining = [], n
        while remaining:
            try:
                chunk = conn.recv(remaining)
            except socket.timeout:
                raise TimeoutError(
                    f"socket recv timed out with {remaining} of {n} B "
                    "outstanding") from None
            if not chunk:
                break
            chunks.append(chunk)
            remaining -= len(chunk)
        return b"".join(chunks)
    return inner


class SocketTransport:
    """Server-side endpoint: one TCP connection per worker rank."""

    def __init__(self, conns: dict, procs: list, spec_path: str):
        self.conns = conns
        self.ranks = sorted(conns)
        self.procs = procs
        self.spec_path = spec_path

    # -- launch --------------------------------------------------------------

    @classmethod
    def launch(cls, spec: dict, workers: int,
               connect_timeout: float = 600.0) -> "SocketTransport":
        """Write the spec, start M workers, collect their HELLOs.

        ``connect_timeout`` is generous by default: each worker pays
        the full torch-import + scenario-rebuild cost (and on a GPU its
        CUDA context) before it dials in.
        """
        srv = socket.create_server(("127.0.0.1", 0))
        port = srv.getsockname()[1]
        fd, spec_path = tempfile.mkstemp(prefix="fl_transport_",
                                         suffix=".json")
        with os.fdopen(fd, "w") as fh:
            json.dump(spec, fh)
        env = dict(os.environ)
        src_root = str(pathlib.Path(__file__).resolve().parents[3])
        env["PYTHONPATH"] = os.pathsep.join(
            p for p in (src_root, env.get("PYTHONPATH")) if p)
        # -c instead of -m: the package __init__ imports .worker, so
        # runpy would warn about re-executing an already-imported module
        entry = "from repro_torch.fl.transport.worker import main; main()"
        procs = [
            subprocess.Popen(
                [sys.executable, "-c", entry,
                 "--spec", spec_path, "--rank", str(rank),
                 "--port", str(port)],
                env=env)
            for rank in range(workers)]
        conns: dict[int, socket.socket] = {}
        deadline = time.monotonic() + connect_timeout
        srv.settimeout(1.0)
        try:
            while len(conns) < workers:
                for p in procs:
                    code = p.poll()
                    if code is not None and code != 0:
                        raise RuntimeError(
                            f"transport worker exited with code {code} "
                            "before connecting — see its stderr above")
                if time.monotonic() > deadline:
                    raise TimeoutError(
                        f"only {len(conns)} of {workers} workers "
                        f"connected within {connect_timeout:.0f}s")
                try:
                    conn, _ = srv.accept()
                except socket.timeout:
                    continue
                conn.settimeout(connect_timeout)
                kind, payload = framing.read_frame(_recv_exact(conn))
                if kind != MsgKind.HELLO:
                    raise framing.WireError(
                        f"expected HELLO from connecting worker, got "
                        f"message kind {kind}")
                hello = Hello.unpack(payload)
                if hello.rank in conns:
                    raise framing.WireError(
                        f"duplicate HELLO for worker rank {hello.rank}")
                conns[hello.rank] = conn
        except BaseException:
            for p in procs:
                p.kill()
            for c in conns.values():
                c.close()
            srv.close()
            raise
        srv.close()
        return cls(conns, procs, spec_path)

    # -- wire ----------------------------------------------------------------

    def send(self, rank: int, kind: int, payload: bytes) -> int:
        frame = framing.pack_frame(kind, payload)
        self.conns[rank].sendall(frame)
        return len(frame)

    def recv(self, rank: int, timeout: float | None = None
             ) -> tuple[int, bytes, int]:
        conn = self.conns[rank]
        conn.settimeout(timeout)
        kind, payload = framing.read_frame(_recv_exact(conn))
        return kind, payload, framing.HEADER.size + len(payload)

    def reconnect(self, rank: int) -> None:
        """A dead TCP peer is a dead subprocess — nothing to redial;
        the retry loop will re-raise after its attempts run out."""

    def close(self) -> None:
        for conn in self.conns.values():
            try:
                conn.close()
            except OSError:
                pass
        for p in self.procs:
            try:
                p.wait(timeout=30)
            except subprocess.TimeoutExpired:
                p.kill()
        try:
            os.unlink(self.spec_path)
        except OSError:
            pass

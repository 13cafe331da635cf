"""Client-worker runtime: one process (or in-process loopback peer)
owning a contiguous block of the client population.

Counterpart of ``repro/fl/transport/worker.py``.  The worker is a
message-driven state machine — ``handle(kind, payload) → [(kind,
payload), ...]`` — with no transport knowledge of its own: the socket
main loop (:func:`run_socket_worker`) and the in-memory loopback both
push the same framed bytes through it.

Per round the worker:

1. ``WORK`` — decodes the broadcast server rows off the dense wire
   codec, trains its block's sampled clients on its device
   (:class:`~repro_torch.fl.runtime.executors.InProcessExecutor`: one
   fused-epoch launch per local epoch over the block's clients, whose
   lanes are independent, so a block's result is its rows of the
   whole cohort's), encodes each surviving upload into the actual
   codec frames (sparse references and error-feedback residuals are
   the worker's numpy state: the client side of the wire) and answers
   ``UPLOAD``.  Under async aggregation a straggler's frames are held
   back and flushed with a later round's UPLOAD, tagged with their
   source round.
2. ``DOWNLINK`` — decodes the post-aggregate rows, applies them per the
   server's arrive / applied routing, scatters the merged rows back
   into its block, advances its broadcast references, evaluates its
   whole block and answers ``EVAL``.

The block's client state and data are tensors on the worker's device;
the per-client keys cross the wire as the reference's two uint32 words
and become the port's int64 word tensors on arrival.  Run as a
subprocess for ``transport="socket"``:

    python -m repro_torch.fl.transport.worker --spec spec.json --rank R \\
        --host 127.0.0.1 --port P

The spec (written by the socket transport) rebuilds the identical
scenario through ``repro_torch.launch.fed_train.build_scenario`` on the
spec's device and the identical initial population through
``Engine.init`` on the shared init key, so the block is a slice of
exactly the state the server holds.  At SHUTDOWN a socket worker writes
one line to stderr, ``transport worker {json}``: its rank, device,
kernel launch counts and peak device memory (the counts are per
process; the server never sees a worker's).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import socket
import sys

import numpy as np
import torch

from repro_torch import device as devices
from repro_torch import random as rnd
from repro_torch import tree
from repro_torch.fl.runtime.codec import CodecConfig, decode, ef_encode, encode
from repro_torch.fl.runtime.engine import Engine, RuntimeConfig
from repro_torch.fl.runtime.executors import InProcessExecutor
from repro_torch.fl.runtime.scheduler import SchedulerConfig
from repro_torch.fl.transport import framing
from repro_torch.fl.transport.faults import FaultPlan
from repro_torch.fl.transport.messages import (Downlink, Eval, Hello, MsgKind,
                                               Upload, UploadEntry, Work)


def block_range(n: int, workers: int, rank: int) -> tuple[int, int]:
    """Contiguous client block [lo, hi) owned by ``rank`` of ``workers``."""
    return rank * n // workers, (rank + 1) * n // workers


def runtime_config_to_dict(cfg: RuntimeConfig) -> dict:
    return dataclasses.asdict(cfg)


def runtime_config_from_dict(d: dict) -> RuntimeConfig:
    d = dict(d)
    d["scheduler"] = SchedulerConfig(**d["scheduler"])
    d["codec"] = CodecConfig(**d["codec"])
    return RuntimeConfig(**d)


def _host(a, dtype) -> np.ndarray | None:
    """A writable numpy copy of a tensor, for per-frame updates."""
    return None if a is None else np.array(a.detach().cpu().numpy(), dtype)


class ClientWorker:
    """The message-driven client-side half of the round protocol."""

    def __init__(self, rank: int, lo: int, hi: int, strategy,
                 cfg: RuntimeConfig, block_cs, block_data,
                 ref_vecs=None, ref_round=None, ef=None,
                 faults: FaultPlan | None = None):
        self.rank, self.lo, self.hi = rank, lo, hi
        self.strategy = strategy
        self.cfg = cfg
        self.executor = InProcessExecutor()
        self.block_cs = block_cs
        self.block_data = block_data
        self.device = block_data.x_train.device
        # client-side wire state, numpy for in-place per-frame updates
        self.ref_vecs = _host(ref_vecs, np.float32)
        self.ref_round = _host(ref_round, np.int32)
        self.ef = _host(ef, np.float32)
        self.faults = faults or FaultPlan()
        self._dense = CodecConfig(cfg.codec.name, sparse=False)
        self._sync = cfg.aggregation == "sync"
        # async: encoded uploads held until their flush round arrives
        self._held: list[tuple[int, UploadEntry]] = []  # (flush_round, e)
        self._ctx = None        # in-flight round: set by WORK, used by
        #                         DOWNLINK (train → apply is split by
        #                         the server's aggregation in between)

    # -- dispatch ------------------------------------------------------------

    def handle(self, kind: int, payload: bytes) -> list[tuple[int, bytes]]:
        if kind == MsgKind.WORK:
            return [(MsgKind.UPLOAD, self._work(Work.unpack(payload)))]
        if kind == MsgKind.DOWNLINK:
            return [(MsgKind.EVAL,
                     self._downlink(Downlink.unpack(payload)))]
        if kind == MsgKind.SHUTDOWN:
            return [(MsgKind.BYE, b"")]
        raise framing.WireError(
            f"worker {self.rank}: unexpected message kind {kind}")

    # -- round halves --------------------------------------------------------

    def _decode_rows(self, rows, dim) -> torch.Tensor:
        out = np.zeros((len(rows), dim), np.float32)
        for s, frame in enumerate(rows):
            out[s] = decode(frame, dim, self._dense)
        return torch.from_numpy(out).to(self.device)

    def _work(self, msg: Work) -> bytes:
        r = msg.round_idx
        tx_server = self._decode_rows(msg.rows, msg.dim)
        local = np.asarray([c.gidx - self.lo for c in msg.clients], np.int64)
        jloc = torch.from_numpy(local).to(self.device)
        sub_cs = new_sub = None
        entries = []
        # a block none of whose clients was sampled this round trains
        # nothing: the card refuses a kernel launch over 0 clients
        if msg.clients:
            keys = torch.tensor([[c.key[0], c.key[1]] for c in msg.clients],
                                dtype=torch.int64, device=self.device)
            sub_cs = tree.map(lambda a: a[jloc], self.block_cs)
            sub_data = tree.map(lambda a: a[jloc], self.block_data)
            new_sub, vecs, slots = self.executor.train(
                self.strategy, sub_cs, tx_server, sub_data, keys)
            np_vecs = np.asarray(vecs.detach().cpu().numpy(), np.float32)
            np_slots = slots.cpu().numpy()
            entries = self._encode(r, msg.clients, local, np_vecs, np_slots)
        if not self._sync:
            flushed = [e for fr, e in self._held if fr <= r]
            self._held = [(fr, e) for fr, e in self._held if fr > r]
            entries.extend(flushed)
        self._ctx = (r, jloc, sub_cs, new_sub, msg.clients)
        return Upload(round_idx=r, entries=tuple(entries)).pack()

    def _encode(self, r, clients, local, np_vecs, np_slots) -> list:
        """The round's upload entries: every surviving client's codec
        frames, one per shared slot; async stragglers are held back."""
        codec_cfg = self.cfg.codec
        entries = []
        for c, wc in enumerate(clients):
            if not wc.active or self.faults.dropped(r, wc.gidx):
                continue                 # upload lost — nothing on the wire
            b = int(local[c])
            frames = []
            for j in range(np_vecs.shape[1]):
                s = int(np_slots[c, j])
                if s < 0:
                    continue             # nothing shared in this slot
                ref = (self.ref_vecs[b, s]
                       if codec_cfg.sparse else None)
                if self.ef is not None:
                    frame, self.ef[b, s] = ef_encode(
                        np_vecs[c, j], codec_cfg, self.ef[b, s], ref=ref)
                else:
                    frame = encode(np_vecs[c, j], codec_cfg, ref=ref)
                frames.append((j, s, frame))
            delay = wc.staleness + self.faults.delay_for(r, wc.gidx)
            entry = UploadEntry(gidx=wc.gidx, src_round=r,
                                staleness=delay, frames=tuple(frames))
            if self._sync or delay == 0:
                # sync: late frames were still *sent* this round — the
                # server meters them and lets the barrier discard them
                entries.append(entry)
            else:
                self._held.append((r + delay, entry))
        return entries

    def _downlink(self, msg: Downlink) -> bytes:
        if self._ctx is None or self._ctx[0] != msg.round_idx:
            raise framing.WireError(
                f"worker {self.rank}: DOWNLINK for round {msg.round_idx} "
                f"without a matching WORK in flight")
        r, jloc, sub_cs, new_sub, work_clients = self._ctx
        self._ctx = None
        if work_clients:
            by_gidx = {c.gidx: c for c in msg.clients}
            ordered = [by_gidx[w.gidx] for w in work_clients]
            arrive = np.asarray([c.arrive for c in ordered], bool)
            applied = np.asarray([c.applied for c in ordered], np.int32)
            rx_server = self._decode_rows(msg.rows, msg.dim)
            merged = self.executor.apply_merge(
                self.strategy, new_sub,
                torch.from_numpy(applied).to(self.device), rx_server,
                sub_cs, torch.from_numpy(arrive).to(self.device))
            self.block_cs = tree.map(lambda a, s: a.index_put((jloc,), s),
                                     self.block_cs, merged)
            if self.cfg.codec.sparse:
                local = jloc.cpu().numpy()
                sub = self.ref_vecs[local].copy()
                sub_rounds = self.ref_round[local].copy()
                Engine._advance_ref_rows(sub, sub_rounds, arrive, applied,
                                         rx_server.cpu().numpy(), r,
                                         self.strategy.downloads)
                self.ref_vecs[local] = sub
                self.ref_round[local] = sub_rounds
        acc = self.executor.evaluate(
            self.strategy, self.block_cs,
            self.block_data.x_test, self.block_data.y_test)
        return Eval(round_idx=r,
                    acc=np.asarray(acc.cpu().numpy(), np.float32)).pack()


# -- socket main loop --------------------------------------------------------

def _recv_exact(conn: socket.socket):
    def inner(n: int) -> bytes:
        chunks = []
        remaining = n
        while remaining:
            chunk = conn.recv(remaining)
            if not chunk:
                break                    # EOF — framing decides how loud
            chunks.append(chunk)
            remaining -= len(chunk)
        return b"".join(chunks)
    return inner


def run_socket_worker(worker: ClientWorker, host: str, port: int):
    """Connect to the transport server and serve rounds until SHUTDOWN."""
    with socket.create_connection((host, port)) as conn:
        conn.sendall(framing.pack_frame(
            MsgKind.HELLO,
            Hello(worker.rank, worker.lo, worker.hi).pack()))
        recv = _recv_exact(conn)
        while True:
            kind, payload = framing.read_frame(recv)
            for out_kind, out_payload in worker.handle(kind, payload):
                conn.sendall(framing.pack_frame(out_kind, out_payload))
            if kind == MsgKind.SHUTDOWN:
                return


def _spec_device(name) -> torch.device:
    """The spec's device; a CUDA device on a host without one raises
    through ``devices.default_device`` rather than falling back."""
    dev = devices.resolve(name)
    if dev.type == "cuda":
        devices.default_device()
    return dev


def worker_from_spec(spec: dict, rank: int) -> ClientWorker:
    """Rebuild the worker's slice of the federated scenario from the
    socket transport's spec: the same scenario builder on the spec's
    device, the same init key, so the block state is bit-identical to
    the server's rows.  The block is copied out of the population, which
    is then freed."""
    from repro_torch.launch.fed_train import build_scenario
    cfg = runtime_config_from_dict(spec["runtime"])
    scenario = dict(spec["scenario"])
    dev = _spec_device(scenario.pop("device", None))
    data, _, _, strategy = build_scenario(**scenario, device=dev)
    engine = Engine(strategy, data, cfg)
    key = torch.tensor(spec["key"], dtype=torch.int64, device=dev)
    k_init, _ = rnd.split(key).unbind(0)
    state = engine.init(k_init)
    lo, hi = block_range(engine.n, cfg.workers, rank)

    def block(a):
        return a[lo:hi].clone()

    return ClientWorker(
        rank, lo, hi, engine.strategy, cfg,
        tree.map(block, state.client_state), tree.map(block, data),
        ref_vecs=block(state.ref_vecs) if cfg.codec.sparse else None,
        ref_round=block(state.ref_round) if cfg.codec.sparse else None,
        ef=block(state.ef_residual) if cfg.codec.error_feedback else None,
        faults=FaultPlan(**spec.get("faults", {})))


def worker_report(worker: ClientWorker) -> dict:
    """What a socket worker says of itself at SHUTDOWN: rank, device,
    the kernel launches this process made and its peak device memory."""
    from repro_torch.kernels._build import LAUNCHES
    dev = worker.device
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)
    return {"rank": worker.rank, "device": str(dev),
            "launches": dict(LAUNCHES), "peak_bytes": int(peak)}


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Federated transport client worker (one block of "
                    "the client population, spoken to over the "
                    "length-prefixed wire)")
    ap.add_argument("--spec", required=True,
                    help="JSON scenario/runtime spec written by the "
                         "socket transport")
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, required=True)
    args = ap.parse_args(argv)
    with open(args.spec) as fh:
        spec = json.load(fh)
    worker = worker_from_spec(spec, args.rank)
    run_socket_worker(worker, args.host, args.port)
    # one write, so the workers' lines never interleave on a shared stderr
    os.write(sys.stderr.fileno(), ("transport worker " + json.dumps(
        worker_report(worker)) + "\n").encode())


if __name__ == "__main__":
    main()

"""Real-transport federated runtime (docs/transport.md).

Counterpart of ``repro/fl/transport``: the federated round over an
actual wire, a server process (:class:`TransportEngine`) exchanging
length-prefixed frames with M client-worker peers, each owning a
contiguous block of the population on its device.
:class:`LoopbackTransport` runs the workers in process behind in-memory
queues, bit for bit the in-process engine (and the JAX package's
loopback); :class:`SocketTransport` runs them as real subprocesses over
local TCP, where staleness and dropout are what happened on the wire.
The frames and messages are the reference's bytes.
"""
from repro_torch.fl.transport.faults import FaultPlan, RetryPolicy
from repro_torch.fl.transport.framing import (MAX_FRAME, BadMagicError,
                                              DisconnectError,
                                              FrameTooLargeError,
                                              TruncatedFrameError, WireError,
                                              decode_frame, pack_frame,
                                              read_frame)
from repro_torch.fl.transport.loopback import LoopbackTransport
from repro_torch.fl.transport.messages import MsgKind
from repro_torch.fl.transport.runner import TransportEngine
from repro_torch.fl.transport.socket_transport import SocketTransport
from repro_torch.fl.transport.worker import ClientWorker, block_range

__all__ = [
    "FaultPlan", "RetryPolicy",
    "WireError", "BadMagicError", "FrameTooLargeError",
    "TruncatedFrameError", "DisconnectError",
    "MAX_FRAME", "pack_frame", "read_frame", "decode_frame",
    "MsgKind", "LoopbackTransport", "SocketTransport",
    "ClientWorker", "block_range", "TransportEngine",
]

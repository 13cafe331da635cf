"""Host-side client store: an O(K) working set over an O(N) population.

Counterpart of ``repro/fl/store``: :class:`ClientStore`, per-client
rows in sparse files (params, TA state, sparse-codec references) with sha256
verify-then-place, and :class:`StreamingClientData`, on-demand
per-writer LEAF ingestion for the sampled cohort.  Together they are
what ``RuntimeConfig(client_store="mmap")`` puts under the engine.
"""
from repro_torch.fl.store.client_store import ClientStore
from repro_torch.fl.store.streaming import StreamingClientData

__all__ = ["ClientStore", "StreamingClientData"]

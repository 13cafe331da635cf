"""Federated serving plane: personalized inference as a service.

Counterpart of ``repro/fl/serve``: a versioned
:class:`~repro_torch.fl.serve.registry.ModelRegistry` of checkpoint
artifacts (sha256 verify-then-place, atomic publish, loud rejection of
corrupted or layout-drifted files) under a
:class:`~repro_torch.fl.serve.plane.ServingPlane` that resolves client
id → personalized row of the resident population and answers batched
requests over heterogeneous clients — one ``fused_votes_batched``
launch per mixed-cluster batch on the GPU.  ``repro_torch.launch.
fed_serve`` is the command-line entry point.
"""
from repro_torch.fl.serve.registry import (ChecksumError, ModelRegistry,
                                           RegistryError)
from repro_torch.fl.serve.plane import ActiveModel, ServingPlane
from repro_torch.fl.serve.telemetry import NULL_SERVE, ServeTelemetry

__all__ = ["ActiveModel", "ChecksumError", "ModelRegistry", "NULL_SERVE",
           "RegistryError", "ServeTelemetry", "ServingPlane"]

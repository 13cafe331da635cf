"""TPFL on PyTorch and CUDA: the port of the JAX package ``repro``.

The package keeps ``repro``'s module layout and names, so each module's
counterpart is easy to find, and imports neither ``jax`` nor ``repro``.
Entry points run on the GPU (``device.default_device()``) unless the
caller passes ``device="cpu"``; on CPU tensors every kernel wrapper runs
its plain PyTorch version (``kernels/ref.py``).
"""

"""The reference's examples on the port (``examples/*.py`` there), each
``python -m repro_torch.examples.<name> [--device cpu]``, on the GPU
unless asked for the CPU."""

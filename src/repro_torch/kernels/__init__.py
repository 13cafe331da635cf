"""Clause-evaluation and training kernels, with their plain versions."""

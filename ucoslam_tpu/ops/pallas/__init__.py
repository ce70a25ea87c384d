"""Pallas kernels (Triton route, GPU) for the per-frame tracking path."""

"""Measurement tools that run on a CUDA GPU."""

"""Checkpoint loading (reference ``.pth`` files and JAX parameter trees) and the AOT export of the forward."""

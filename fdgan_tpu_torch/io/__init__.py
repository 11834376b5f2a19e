"""Checkpoint loading: reference ``.pth`` files and JAX parameter trees."""

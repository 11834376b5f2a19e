"""Layers: conv, BatchNorm with the reference's state-dict names, pooling."""

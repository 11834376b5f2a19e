"""Hand-written CUDA kernels (``dense``) and their build (``build``)."""

"""fdgan_tpu_torch — the FD-GAN dehazing framework in PyTorch and CUDA.

The port of ``fdgan_tpu`` (JAX on a TPU) to an NVIDIA Hopper GPU. The JAX
package is its reference; this package imports neither it nor JAX.

Layout mirrors ``fdgan_tpu``: ``nn/`` layers, ``models/`` the FDGAN
generator, ``ops/`` the fused dense-layer kernels (CUDA sources in
``csrc/``), ``io/`` checkpoint loading, ``serve.py`` / ``serve_http.py``
the serving engine and its HTTP frontend, ``cli/`` the entry points.
Activations are NCHW tensors in ``torch.channels_last`` memory format;
public functions take and return NHWC images, as ``fdgan.apply`` does.
"""

__version__ = "0.1.0"

from fdgan_tpu_torch.serve import InferenceEngine  # noqa: F401

"""fdgan_tpu_torch — the FD-GAN dehazing framework in PyTorch and CUDA.

The port of ``fdgan_tpu`` (JAX on a TPU) to an NVIDIA Hopper GPU. The JAX
package is its reference; this package imports neither it nor JAX.

Layout mirrors ``fdgan_tpu``: ``nn/`` layers, ``models/`` the FDGAN
generator, the fusion discriminator and VGG16, ``ops/`` the kernels' wrappers
and plain versions (CUDA sources in ``csrc/``) and SSIM, ``losses/`` and
``train/`` the adversarial train step, ``io/`` checkpoint loading,
``serve.py`` / ``serve_http.py`` the serving engine and its HTTP frontend,
``cli/`` the entry points, ``native/`` the C++ operators and package runner
of an exported forward (``io/export.py``).
Activations are NCHW tensors in ``torch.channels_last`` memory format;
public functions take and return NHWC images, as ``fdgan.apply`` does.
"""

__version__ = "0.1.0"



def __getattr__(name):
    # imported on first use, so that importing a submodule (``ops.library``, to
    # load an exported program) pulls in no model code
    if name == "InferenceEngine":
        from fdgan_tpu_torch.serve import InferenceEngine

        return InferenceEngine
    raise AttributeError(f"module 'fdgan_tpu_torch' has no attribute {name!r}")

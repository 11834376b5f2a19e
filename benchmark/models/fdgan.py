"""FD-GAN's generator (Dong et al., AAAI 2020, arXiv:2001.06968) as the
benchmark serves it: ``InferenceEngine`` takes the seed's state dict as it
is, and the plain reference is ``harness/reference.py::fdgan_generator``."""

from harness.reference import fdgan_generator

reference = fdgan_generator


def template():
    """The program's generator on the meta device: its state dict names
    the weights."""
    from fdgan_tpu_torch.models.fdgan import FDGAN

    return FDGAN(device="meta")


def program(weights, device, mix):
    """What the cell's entry point is given: the state dict itself, which
    ``InferenceEngine`` loads."""
    return weights

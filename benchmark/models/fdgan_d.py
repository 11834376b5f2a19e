"""FD-GAN's fusion discriminator (PatchGAN over the 9-channel fusion of RGB,
LF and HF), which the ``train`` kind builds beside the generator. No
configuration serves it, so it gives only its layout; its plain reference
is ``harness/reference.py::discriminator``, which the training step calls."""


def template():
    """The program's discriminator on the meta device: its state dict names
    the weights."""
    from fdgan_tpu_torch.models.discriminators import NLayerDiscriminator

    return NLayerDiscriminator(input_nc=9, device="meta")

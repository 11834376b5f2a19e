"""DCPDN's DehazePhysical (Zhang & Patel, CVPR 2018, arXiv:1803.08396) as
the benchmark runs it: the program's module filled with the seed's weights,
its forward over uint8 batches, and the plain reference
``harness/reference.py::dehaze_physical``."""

from harness.cells import DTYPES
from harness.reference import dehaze_physical

reference = dehaze_physical


def template():
    """The program's DehazePhysical on the meta device: its state dict
    names the weights."""
    from fdgan_tpu_torch.models.dcpdn import DehazePhysical

    return DehazePhysical(device="meta")


def program(weights, device, mix):
    """The DehazePhysical that ``weights`` fill (assigned, not copied; they
    are already on ``device``), in eval mode."""
    model = template()
    model.load_state_dict(weights, assign=True)
    return model.eval()


def forward(prog, x, mix):
    """The dehazed image, NHWC tanh in [-1, 1], of uint8 NHWC ``x``: scaled
    to [0, 1] in the served dtype, through ``DehazePhysical.forward`` on the
    port's kernels."""
    return prog(x.float().div_(255.0).to(DTYPES[mix["precision"]]), bn_mode=mix["bn_mode"], impl="kernels")[0]

"""Checkpoint converter: the reference's torch ``.pth`` ↔ the JAX package's
params ``.msgpack``, for every model family, without JAX.

    python -m fdgan_tpu_torch.cli.convert --src netG_epoch_real.pth --dst netG.msgpack
    python -m fdgan_tpu_torch.cli.convert --src netG.msgpack --dst netG.pth [--prefix module.]
    python -m fdgan_tpu_torch.cli.convert --model unetg2 --src G2.pth --dst G2.msgpack
    python -m fdgan_tpu_torch.cli.convert --src netG.pth --dst netG_512.pt2 \
        --imageSize 512 --batch 8 [--precision bf16] [--bnMode running] [--ioDtype uint8]

Counterpart of ``fdgan_tpu/cli/convert.py``, with its conversion flags
(``--src``, ``--dst``, ``--model``, ``--prefix``). ``--model``
names the family (``io.torch_import.model_registry``): its module gives the
names, shapes and JAX leaf order, and its sets the ConvTranspose2d layouts
(IOHW) and the reference's doubled blockUNet keys. Import keeps the
reference's dead parameters; export writes the reference's key names, with
``--prefix`` (DataParallel's ``module.`` by default) in front. ``--model
vgg16`` also reads torchvision's ``features.N`` naming. A pure data
transformation: it runs on the CPU and launches nothing on a card.

A ``.pt2`` destination (``--model fdgan``) exports the generator's forward
instead, the counterpart of the JAX CLI's ``.shlo``: ``io.export.
export_forward`` traces ``fdgan_fast.apply`` into a ``torch.export``
program, weights inside, that ``cli/serve --artifact`` and
``io.export.ArtifactRunner`` run with no model code. The JAX CLI's export
flags configure it: ``--imageSize``, ``--batch`` (an int, or ``poly`` for
one program of every batch size), ``--precision``, ``--bnMode``,
``--ioDtype`` (``uint8``: bytes in and out, the conversions inside the
program), and ``--platforms``: the one device the program is traced for,
``cuda`` (the default) or ``cpu``; a torch program serves one device, so a
list, or ``tpu``, is refused. A ``.shlo``/``.stablehlo`` destination (JAX's
StableHLO) stops with ``SystemExit`` naming ``.pt2``.
"""

from __future__ import annotations

import argparse

import torch

FAMILIES = ["fdgan", "vgg16", "dense", "dense2", "unetg", "unetg2", "dehaze", "nlayer", "patchd", "begand"]
SHLO = ("a .shlo/.stablehlo destination is the JAX package's StableHLO export: the port exports the forward as "
        "a torch.export program, --dst <name>.pt2 (or `python -m fdgan_tpu.cli.convert` for StableHLO)")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--src", required=True)
    p.add_argument("--dst", required=True)
    p.add_argument("--model", default="fdgan", choices=FAMILIES,
                   help="model family the checkpoint belongs to (io/torch_import.model_registry)")
    p.add_argument("--prefix", default="module.", help="key prefix for .pth export")
    p.add_argument("--imageSize", type=int, default=512, help=".pt2 export: the program's square image size")
    p.add_argument("--batch", default="1", help=".pt2 export batch: an int, or 'poly' for a batch-polymorphic program")
    p.add_argument("--precision", default="bf16", choices=["bf16", "fp32"], help=".pt2 export precision")
    p.add_argument("--bnMode", default="batch", choices=["batch", "running"], help=".pt2 export BN mode")
    p.add_argument("--ioDtype", default="float32", choices=["float32", "uint8"],
                   help=".pt2 I/O contract: uint8 moves x/255 and the output's quantisation into the program")
    p.add_argument("--platforms", default="cuda",
                   help=".pt2 export: the one device the program is traced for, cuda or cpu")
    return p


def _export(opt) -> None:
    """A .pt2 destination: the generator's forward as a torch.export program."""
    from fdgan_tpu_torch.cli._common import load_model
    from fdgan_tpu_torch.io.export import export_forward, save_exported

    if opt.model != "fdgan":
        raise SystemExit(".pt2 export supports --model fdgan only")
    devices = [d.strip() for d in opt.platforms.split(",") if d.strip()]
    if len(devices) != 1 or devices[0].split(":")[0] not in ("cuda", "cpu"):
        raise SystemExit(f"--platforms must name one device, cuda or cpu, got {opt.platforms!r}: a torch program "
                         "is traced for one device (a TPU's StableHLO is `python -m fdgan_tpu.cli.convert`'s)")
    if opt.batch != "poly" and not opt.batch.isdigit():
        raise SystemExit(f"--batch must be an int or 'poly', got {opt.batch!r}")
    model = load_model(opt.src, "fdgan", device=devices[0])
    exported = export_forward(model, image_size=opt.imageSize, batch=opt.batch if opt.batch == "poly" else int(opt.batch),
                              precision=opt.precision, bn_mode=opt.bnMode, device=devices[0], io=opt.ioDtype)
    n = save_exported(opt.dst, exported)
    print(f"exported {opt.src} -> {opt.dst} ({n / 1e6:.1f} MB torch.export program, {opt.batch}x{opt.imageSize}^2 "
          f"{opt.precision} bn={opt.bnMode} io={opt.ioDtype}, device={devices[0]})")


def main(argv=None) -> None:
    from fdgan_tpu_torch.cli._common import load_model
    from fdgan_tpu_torch.io.checkpoint import save_params
    from fdgan_tpu_torch.io.torch_import import export_state_dict, model_registry

    opt = build_parser().parse_args(argv)
    if opt.dst.endswith((".shlo", ".stablehlo")):
        raise SystemExit(SHLO)
    if opt.dst.endswith(".pt2"):
        return _export(opt)
    src_is_torch = opt.src.endswith((".pth", ".pt"))
    dst_is_torch = opt.dst.endswith((".pth", ".pt"))
    if src_is_torch == dst_is_torch:
        raise SystemExit("exactly one of --src/--dst must be a .pth/.pt file")
    fam = model_registry()[opt.model]
    model = load_model(opt.src, opt.model, device="cpu")
    if dst_is_torch:
        state = export_state_dict(model.state_dict(), prefix=opt.prefix, duplicated=fam.duplicated)
        torch.save(state, opt.dst)
        print(f"exported {opt.src} -> {opt.dst} ({len(state)} tensors)")
    else:
        save_params(opt.dst, model, fam.transposed)
        print(f"imported {opt.src} -> {opt.dst}")


if __name__ == "__main__":
    main()

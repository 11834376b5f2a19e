"""Checkpoint converter: the reference's torch ``.pth`` ↔ the JAX package's
params ``.msgpack``, for every model family, without JAX.

    python -m fdgan_tpu_torch.cli.convert --src netG_epoch_real.pth --dst netG.msgpack
    python -m fdgan_tpu_torch.cli.convert --src netG.msgpack --dst netG.pth [--prefix module.]
    python -m fdgan_tpu_torch.cli.convert --model unetg2 --src G2.pth --dst G2.msgpack

Counterpart of ``fdgan_tpu/cli/convert.py``, with its conversion flags
(``--src``, ``--dst``, ``--model``, ``--prefix``). ``--model``
names the family (``io.torch_import.model_registry``): its module gives the
names, shapes and JAX leaf order, and its sets the ConvTranspose2d layouts
(IOHW) and the reference's doubled blockUNet keys. Import keeps the
reference's dead parameters; export writes the reference's key names, with
``--prefix`` (DataParallel's ``module.`` by default) in front. ``--model
vgg16`` also reads torchvision's ``features.N`` naming. A pure data
transformation: it runs on the CPU and launches nothing on a card.

Not ported: a ``.shlo``/``.stablehlo`` destination (the JAX CLI's AOT
export of the forward as StableHLO) stops with ``SystemExit``
(ROADMAP.md, Queue 1 item 12), and the flags that configure that export
(``--imageSize``, ``--batch``, ``--precision``, ``--bnMode``, ``--ioDtype``,
``--platforms``) are not taken.
"""

from __future__ import annotations

import argparse

import torch

FAMILIES = ["fdgan", "vgg16", "dense", "dense2", "unetg", "unetg2", "dehaze", "nlayer", "patchd", "begand"]
SHLO_TODO = ("a .shlo/.stablehlo destination (AOT export of the forward) is not ported "
             "(ROADMAP.md, Queue 1 item 12); export with `python -m fdgan_tpu.cli.convert`")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--src", required=True)
    p.add_argument("--dst", required=True)
    p.add_argument("--model", default="fdgan", choices=FAMILIES,
                   help="model family the checkpoint belongs to (io/torch_import.model_registry)")
    p.add_argument("--prefix", default="module.", help="key prefix for .pth export")
    return p


def main(argv=None) -> None:
    from fdgan_tpu_torch.cli._common import load_model
    from fdgan_tpu_torch.io.checkpoint import save_params
    from fdgan_tpu_torch.io.torch_import import export_state_dict, model_registry

    opt = build_parser().parse_args(argv)
    if opt.dst.endswith((".shlo", ".stablehlo")):
        raise SystemExit(SHLO_TODO)
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

"""Cross-check the C++ runner against the same package in Python.

Counterpart of ``tools/check_native.py``. An exported bundle
(``io.export.export_native_bundle``: the AOTInductor package, its ``.sig``
and the ``ExportedProgram``) has three consumers: ``native/aoti_runner.cpp``
(C++, no Python, the ``fdgan::`` operators from ``--ops
libfdgan_torch_ops.so``), the package loaded in Python
(``torch._inductor.aoti_load_package``, the operators of ``ops/library.py``)
and ``ArtifactRunner`` on the ``ExportedProgram``. This tool exports a
bundle of the generator (seed-0 weights, or ``--netG``), runs one uint8
image through all three and through the eager engine
(``serve.InferenceEngine``), and compares: the runner's bytes must equal
the package's in Python, and every output must lie within one level of the
engine's. On the card:

    python -m fdgan_tpu_torch.tools.check_native [--size 512] [--precision bf16] \\
        [--bnMode running] [--netG ckpt.pth] [--bundle build/native/fdgan_512] [--loops 3]
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import time
from pathlib import Path
from typing import Dict, Optional

import numpy as np

ROOT = Path(__file__).resolve().parents[2]


def sample_image(size: int, seed: int = 0) -> np.ndarray:
    """A uint8 (size, size, 3) image from ``seed``: smooth gradients with noise."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:size, 0:size] / size
    base = np.stack([yy, xx, 0.5 * (yy + xx)], axis=-1) * 180 + 40
    return np.clip(base + rng.normal(0, 12, base.shape), 0, 255).astype(np.uint8)


def run_native(base: str, image: np.ndarray, loops: int = 1, ops: bool = True,
               timeout: float = 600) -> Dict[str, object]:
    """``aoti_runner <base> [--ops] --input --output --loops``: its output
    image, the seconds of each loop and the kernels' launches it printed.
    Raises if it fails."""
    from fdgan_tpu_torch.ops import build

    runner = build.aoti_runner()
    in_raw, out_raw = f"{base}.in.raw", f"{base}.out.raw"
    image[None].tofile(in_raw)
    cmd = [str(runner), base, "--input", in_raw, "--output", out_raw, "--loops", str(loops)]
    if ops:
        cmd[2:2] = ["--ops", str(build.torch_ops_library())]
    res = subprocess.run(cmd, capture_output=True, text=True, timeout=timeout)
    if res.returncode:
        raise RuntimeError(f"{' '.join(cmd)} failed ({res.returncode}):\n{res.stdout}{res.stderr}")
    seconds = [float(s) for s in re.findall(r"^iter \d+: ([0-9.]+)s", res.stdout, re.M)]
    launches = json.loads(res.stdout.strip().splitlines()[-1])["launches"]
    out = np.fromfile(out_raw, np.uint8).reshape(image.shape)
    return {"output": out, "seconds": seconds, "launches": launches, "log": res.stdout}


def check(model, base: str, size: int, precision: str = "bf16", bn_mode: str = "running", loops: int = 3,
          bundle: Optional[Dict[str, object]] = None) -> Dict[str, object]:
    """Export ``model`` as a 1×size² uint8 bundle at ``base`` (unless
    ``bundle`` is one already made) and hold its consumers against each
    other on ``sample_image(size)``. Returns the numbers; raises on a
    mismatch."""
    import torch

    from fdgan_tpu_torch.io.export import ArtifactRunner, export_native_bundle
    from fdgan_tpu_torch.serve import InferenceEngine

    if bundle is None:
        bundle = export_native_bundle(model, base, image_size=size, batch=1, precision=precision, bn_mode=bn_mode,
                                      io="uint8", device="cuda")
    img = sample_image(size)
    native = run_native(base, img, loops)
    package = torch._inductor.aoti_load_package(bundle["pt2"])
    with torch.inference_mode():
        python = package(torch.from_numpy(img[None]).cuda())[0].cpu().numpy()
    program = ArtifactRunner(bundle["ep"])([img])[0]
    engine = InferenceEngine(model, device="cuda", precision=precision, bn_mode=bn_mode, batch_sizes=(1,),
                             input="uint8", output="uint8")
    try:
        eager = engine.predict(img)
    finally:
        engine.close()

    def levels(a, b) -> int:
        return int(np.abs(a.astype(np.int16) - b.astype(np.int16)).max())

    out = {
        "size": size, "precision": precision, "bn_mode": bn_mode,
        "seconds": bundle.get("seconds"),
        "mb": {k: os.path.getsize(bundle[k]) / 1e6 for k in ("pt2", "ep")},
        "native_equals_python": bool(np.array_equal(native["output"], python)),
        "levels": {"native_vs_python": levels(native["output"], python),
                   "program_vs_python": levels(program, python), "eager_vs_python": levels(eager, python),
                   "eager_vs_native": levels(eager, native["output"])},
        "native_seconds": native["seconds"], "native_launches": native["launches"],
    }
    if not out["native_equals_python"]:
        raise AssertionError(f"aoti_runner's bytes differ from the package's in Python: {out}")
    if max(out["levels"].values()) > 1:
        raise AssertionError(f"an output is more than one level from the others: {out}")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--precision", default="bf16", choices=["bf16", "fp32"])
    ap.add_argument("--bnMode", default="running", choices=["batch", "running"])
    ap.add_argument("--netG", default="", help="generator checkpoint (seed-0 weights if absent)")
    ap.add_argument("--bundle", default="", help="bundle base path (default build/native/fdgan_<size>)")
    ap.add_argument("--loops", type=int, default=3)
    opt = ap.parse_args(argv)

    import torch

    from fdgan_tpu_torch.cli._common import fp32_exact, load_generator
    from fdgan_tpu_torch.models.fdgan import FDGAN

    if not torch.cuda.is_available():
        print("check_native: no CUDA device", file=sys.stderr)
        return 2
    model = load_generator(opt.netG) if opt.netG else FDGAN(generator=torch.Generator().manual_seed(0)).cuda()
    base = opt.bundle or str(ROOT / "build" / "native" / f"fdgan_{opt.size}")
    os.makedirs(os.path.dirname(base), exist_ok=True)
    t0 = time.perf_counter()
    with fp32_exact(opt.precision, "cuda"):
        out = check(model, base, opt.size, opt.precision, opt.bnMode, opt.loops)
    out["total_seconds"] = time.perf_counter() - t0
    print(json.dumps(out))
    print("OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())

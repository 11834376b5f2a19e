"""The port imports neither JAX nor the JAX package.

In a fresh interpreter where ``jax``, ``jaxlib`` and ``fdgan_tpu`` cannot be
imported, every module of ``fdgan_tpu_torch`` (found with
``pkgutil.walk_packages``) must import.
"""

import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = """
import importlib, pkgutil, sys
for name in ("jax", "jaxlib", "fdgan_tpu"):
    sys.modules[name] = None  # any import of them raises ImportError
import fdgan_tpu_torch

def fail(name):
    raise SystemExit(f"cannot import {name}: {sys.exc_info()[1]!r}")

names = [m.name for m in pkgutil.walk_packages(fdgan_tpu_torch.__path__, "fdgan_tpu_torch.", onerror=fail)]
for name in names:
    importlib.import_module(name)
print(len(names))
"""


def test_the_port_imports_without_jax():
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
    res = subprocess.run([sys.executable, "-c", SCRIPT], cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    # the subpackages and their modules, the demo path's included
    assert int(res.stdout.split()[-1]) >= 50, res.stdout

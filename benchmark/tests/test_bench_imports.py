"""No module that ``benchmark/run.py`` loads has the top-level name ``jax``,
``jaxlib``, ``flax`` or ``fdgan_tpu`` (compared whole: the port's name
begins with the JAX package's), and the plain reference loads nothing of
the port."""

import subprocess
import sys

import bench_util

RUN_ONE = f"""
import sys, torch
sys.argv = ["run.py"]
sys.path[:0] = [{str(bench_util.BENCH)!r}, {str(bench_util.BENCH / 'tests')!r}]
import run, bench_util
from harness import runner
torch.set_num_threads(2)
for cell in ("fdgan.bulk.620x460", "fdgan.train.8x256"):
    runner.run_cell(bench_util.tiny_specs(), cell, 3, 0.5, False, "cpu")
print("LOADED", runner.forbidden_modules())
print("PORT", "fdgan_tpu_torch" in sys.modules)
"""


def _run(code: str) -> str:
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=900,
                         cwd=str(bench_util.ROOT))
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout


def test_a_run_loads_no_jax():
    out = _run(RUN_ONE)
    assert "LOADED []" in out
    assert "PORT True" in out  # the check is not vacuous: the run did load the port


def test_forbidden_names_compare_whole():
    from harness.runner import forbidden_modules

    before = set(sys.modules)
    sys.modules["fdgan_tpu_torch_lookalike"] = sys.modules[__name__]
    sys.modules["jaxtyping_lookalike"] = sys.modules[__name__]
    try:
        assert not {"fdgan_tpu_torch_lookalike", "jaxtyping_lookalike"} & set(forbidden_modules())
        sys.modules["fdgan_tpu.models"] = sys.modules[__name__]
        assert "fdgan_tpu.models" in forbidden_modules()
    finally:
        for k in set(sys.modules) - before:
            del sys.modules[k]


def test_the_reference_loads_nothing_of_the_port():
    out = _run(f"""
import sys
sys.path.insert(0, {str(bench_util.BENCH)!r})
from harness import reference
print(sorted(m for m in sys.modules if m.split('.')[0] in ('fdgan_tpu_torch', 'fdgan_tpu', 'jax')))
""")
    assert out.strip() == "[]"

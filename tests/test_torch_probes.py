"""The port's kernel probes (fdgan_tpu_torch.ops.probes, .tools.probes)
against the Pallas probes they replace, tools/probe_pallas*.py.

The CUDA kernels run only on a card (tests/test_torch_cuda.py); here the
wrappers take their plain versions, and those are held against:
- tools/probe_pallas5.py in interpret mode (its own CPU mode: it sizes
  itself at 2×64×64 when ``--interpret`` is on the command line), for both
  conv1 readers and both conv2 bodies;
- the references inside tools/probe_pallas{,2,3,4}.py, which run at TPU
  size when imported and so are recomputed here with jax.numpy: ``xla_mm``
  (probe_pallas.py:31-32) and ``a * 2`` (probe_pallas4.py:61).
Inputs come from numpy seeds and go to both sides as numpy arrays.
"""

import importlib.util
import inspect
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fdgan_tpu.ops.pallas_dense import build_halo
from fdgan_tpu_torch.cli._common import load_generator
from fdgan_tpu_torch.cli.demo import dehaze
from fdgan_tpu_torch.ops import probes
from fdgan_tpu_torch.tools import probes as probe_tool
from fdgan_tpu_torch.train.loop import create_train_state

ROOT = Path(__file__).resolve().parents[1]

# Both sides round fp32 sums of the same exact bf16 products to bf16 once;
# sums in another order can fall on the other side of a rounding boundary,
# one bf16 step, 2^-7 relative at the bottom of a binade. The absolute part
# is for sums near 0 (see tools/probes.py, whose tolerances these are).
STEP = probe_tool.PRODUCT_TOL
CONV1_STEP = probe_tool.CONV1_TOL


def _bf16(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a, np.float32)).bfloat16()


def _jbf16(a: np.ndarray):
    return jnp.asarray(np.asarray(a, np.float32)).astype(jnp.bfloat16)


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x.astype(jnp.float32))


@pytest.fixture(scope="module")
def p5():
    """tools/probe_pallas5.py, loaded by path with --interpret on the
    command line: it reads the flag when imported. Its change to JAX's
    compilation-cache directory is undone."""
    cache_dir = jax.config.jax_compilation_cache_dir
    argv = sys.argv
    sys.argv = ["probe_pallas5.py", "--interpret"]
    try:
        spec = importlib.util.spec_from_file_location("probe_pallas5_interpret", ROOT / "tools" / "probe_pallas5.py")
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
    finally:
        sys.argv = argv
        jax.config.update("jax_compilation_cache_dir", cache_dir)
    assert module.INTERPRET and (module.B, module.H, module.W) == (2, 64, 64)
    return module


@pytest.fixture(scope="module")
def conv1_case(p5):
    rng = np.random.default_rng(5)
    c = p5.C
    segs = [rng.uniform(size=(p5.B, p5.H, p5.W, w)) for w in p5.SEGS]
    a, b = rng.uniform(0.5, 1.5, c), rng.normal(0, 0.3, c)
    w1 = rng.standard_normal((c, 128)) / np.sqrt(c)
    jsegs = [_jbf16(s) for s in segs]
    ja, jb, jw = jnp.asarray(a, jnp.float32), jnp.asarray(b, jnp.float32), _jbf16(w1)
    refs = {"seg": _f32(p5.seg_conv1(jsegs, ja, jb, jw)),
            "mono": _f32(p5.mono_conv1(jnp.concatenate(jsegs, axis=-1), ja, jb, jw))}
    args = ([_bf16(s) for s in segs], torch.from_numpy(a.astype(np.float32)), torch.from_numpy(b.astype(np.float32)),
            _bf16(w1))
    return args, refs


@pytest.fixture(scope="module")
def conv2_case(p5):
    rng = np.random.default_rng(6)
    g = rng.uniform(size=(p5.B, p5.H, p5.W, 128))
    w2 = rng.standard_normal((3, 3, 128, 32)) / np.sqrt(9 * 128)
    jg, jw = _jbf16(g), _jbf16(w2)
    halo = build_halo(jg, p5.TH)
    refs = {"9dot": _f32(p5.conv2(jg, halo, jw, p5._conv2_9dot_kernel, False)),
            "packed": _f32(p5.conv2(jg, halo, jw, p5._conv2_packed_kernel, True))}
    return (_bf16(g), _bf16(w2)), refs


@pytest.mark.parametrize("reader", ["seg", "mono"])
@pytest.mark.parametrize("cut", ["segments", "concat"])
@pytest.mark.parametrize("mode", probes.CONV1_MODES)
def test_conv1_matches_pallas_probe(conv1_case, reader, cut, mode):
    (segs, a, b, w1), refs = conv1_case
    if cut == "concat":
        segs = [torch.cat(segs, dim=-1)]
    got = probes.conv1_segments(segs, a, b, w1, mode)
    assert got.dtype == torch.bfloat16 and got.shape == refs[reader].shape
    np.testing.assert_allclose(_f32(got), refs[reader], **CONV1_STEP)


@pytest.mark.parametrize("body", ["9dot", "packed"])
@pytest.mark.parametrize("mode", probes.CONV2_MODES)
def test_conv2_matches_pallas_probe(conv2_case, mode, body):
    (g, w2), refs = conv2_case
    got = probes.conv2(g, w2, mode)
    assert got.dtype == torch.bfloat16 and got.shape == refs[body].shape
    np.testing.assert_allclose(_f32(got), refs[body], **STEP)


def test_pallas_conv2_bodies_agree(conv2_case):
    """The two Pallas bodies add the nine terms in different orders."""
    _, refs = conv2_case
    np.testing.assert_allclose(refs["packed"], refs["9dot"], **STEP)


@pytest.mark.parametrize("m", [256, 232, 40])
def test_probe_mm_matches_xla_mm(m):
    """probe_pallas.py:31-32 xla_mm, held as its :51 holds the Pallas
    kernel (rtol 2e-2), and at one bf16 step besides."""
    rng = np.random.default_rng(m)
    a, b = rng.uniform(size=(m, 128)), rng.uniform(size=(128, 128))
    want = _f32(jnp.dot(_jbf16(a), _jbf16(b), preferred_element_type=jnp.float32).astype(jnp.bfloat16))
    got = _f32(probes.probe_mm(_bf16(a), _bf16(b), tile_rows=64))
    np.testing.assert_allclose(got, want, rtol=2e-2)
    np.testing.assert_allclose(got, want, **STEP)


@pytest.mark.parametrize("copy", [probes.scale_copy, probes.scale_copy_staged, probes.scale_copy_bulk],
                         ids=["plain", "staged", "bulk"])
@pytest.mark.parametrize("shape", [(64, 128), (37, 128), (13,)])
def test_scale_copy_matches_jax(copy, shape):
    """copy_kernel (probe_pallas3.py:27) and dbuf_kernel (probe_pallas4.py:29,
    which both staged copies answer) compute a * 2.0 in bf16, held by
    probe_pallas4.py:61; doubling is exact."""
    a = np.random.default_rng(7).uniform(size=shape)
    got = copy(_bf16(a))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(_f32(got), _f32(_jbf16(a) * 2.0))


def _conv1_args(widths=(16, 8), lead=(2, 4)):
    c = sum(widths)
    segs = [torch.zeros(lead + (w,), dtype=torch.bfloat16) for w in widths]
    return segs, torch.ones(c), torch.zeros(c), torch.zeros(c, 128, dtype=torch.bfloat16)


def _misaligned(shape):
    """A contiguous bf16 tensor whose first byte is 8 past a 16-byte boundary."""
    n = int(np.prod(shape))
    t = torch.zeros(n + 12, dtype=torch.bfloat16)
    off = 4 if t.data_ptr() % 16 == 0 else (16 - t.data_ptr() % 16) // 2 + 4
    t = t[off:off + n].view(shape)
    assert t.is_contiguous() and t.data_ptr() % 16 == 8
    return t


def test_conv1_rejects_width_not_multiple_of_8():
    segs, a, b, w1 = _conv1_args(widths=(16, 12))
    with pytest.raises(ValueError, match="multiple of 8"):
        probes.conv1_segments(segs, a, b, w1)


def test_conv1_rejects_misaligned_segment():
    segs, a, b, w1 = _conv1_args()
    segs[1] = _misaligned(segs[1].shape)
    with pytest.raises(ValueError, match="segment 1 must be 16-byte aligned"):
        probes.conv1_segments(segs, a, b, w1)


def test_conv1_rejects_a_slice_of_the_concat():
    x = torch.zeros(2, 4, 24, dtype=torch.bfloat16)
    _, a, b, w1 = _conv1_args()
    with pytest.raises(ValueError, match="contiguous"):
        probes.conv1_segments([x[..., :16], x[..., 16:]], a, b, w1)


def test_conv1_rejects_more_than_8_segments():
    segs, a, b, w1 = _conv1_args(widths=(8,) * 9)
    with pytest.raises(ValueError, match="1 to 8 segments"):
        probes.conv1_segments(segs, a, b, w1)
    with pytest.raises(ValueError, match="1 to 8 segments"):
        probes.conv1_segments([], a, b, w1)


def test_conv1_rejects_wrong_dtype_and_shapes():
    segs, a, b, w1 = _conv1_args()
    with pytest.raises(TypeError, match="bfloat16"):
        probes.conv1_segments([s.float() for s in segs], a, b, w1)
    with pytest.raises(ValueError, match="w1 must be"):
        probes.conv1_segments(segs, a, b, w1[:16])
    with pytest.raises(ValueError, match="leading shape"):
        probes.conv1_segments([segs[0], segs[1][:1]], a, b, w1)
    with pytest.raises(ValueError, match="mode"):
        probes.conv1_segments(segs, a, b, w1, "taps9")


def test_other_wrappers_reject_bad_inputs():
    a = torch.zeros(64, 128, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="tile_rows"):
        probes.probe_mm(a, torch.zeros(128, 128, dtype=torch.bfloat16), tile_rows=1024)
    with pytest.raises(ValueError, match="must end in"):
        probes.probe_mm(a[:, :64].contiguous(), torch.zeros(128, 128, dtype=torch.bfloat16))
    with pytest.raises(TypeError, match="bfloat16"):
        probes.scale_copy(a.float())
    with pytest.raises(ValueError, match="aligned"):
        probes.scale_copy_staged(_misaligned((8, 128)))
    with pytest.raises(ValueError, match="mode"):
        probes.conv2(torch.zeros(1, 8, 8, 128, dtype=torch.bfloat16), torch.zeros(3, 3, 128, 32), mode="taps3")
    with pytest.raises(ValueError, match="w2 must be"):
        probes.conv2(torch.zeros(1, 8, 8, 128, dtype=torch.bfloat16), torch.zeros(3, 3, 128, 16))


@pytest.mark.parametrize("n, k, row_off, a_rows", [(32, 128, 0, 137), (32, 128, 38, 137), (96, 128, 18, 137),
                                                   (128, 64, 19, 136), (128, 16, 72, 137)])
def test_wgmma_selfcheck_plain_version(n, k, row_off, a_rows):
    """On the CPU the self-check is its plain version: 64 rows of a from
    row_off times bᵀ in fp32, held here against a float64 product; the tool's
    check of every (N, K, offset) the kernels use passes on it."""
    rng = np.random.default_rng(n + k + row_off)
    a, b = _bf16(rng.standard_normal((136, k))), _bf16(rng.standard_normal((n, k)))
    got = probes.wgmma_selfcheck(a, b, row_off, a_rows)
    assert got.dtype == torch.float32 and got.shape == (64, n)
    want = a[row_off:row_off + 64].double().numpy() @ b.double().numpy().T
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)
    np.testing.assert_array_equal(probes.wgmma_selfcheck(a, b, row_off, a_rows, reps=3).numpy(), 3 * got.numpy())
    assert probe_tool.wgmma_selfcheck(device="cpu") <= 1e-3


def test_wgmma_selfcheck_rejects_bad_inputs():
    a, b = torch.zeros(136, 64, dtype=torch.bfloat16), torch.zeros(128, 64, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="N must be"):
        probes.wgmma_selfcheck(a, b[:64])
    with pytest.raises(ValueError, match="multiple of 16"):
        probes.wgmma_selfcheck(a[:, :24].contiguous(), b[:, :24].contiguous())
    with pytest.raises(ValueError, match="do not fit"):
        probes.wgmma_selfcheck(a, b, row_off=73)
    with pytest.raises(ValueError, match="do not fit"):
        probes.wgmma_selfcheck(a, b, a_rows=135)
    with pytest.raises(ValueError, match="positive"):
        probes.wgmma_selfcheck(a, b, reps=0)
    with pytest.raises(TypeError, match="bfloat16"):
        probes.wgmma_selfcheck(a.float(), b)


@pytest.mark.parametrize("fn", [create_train_state, load_generator, dehaze], ids=lambda f: f.__name__)
def test_entry_points_default_to_the_card(fn):
    """Training, checkpoint loading and the demo's core run on the card unless
    asked for the CPU; without a card torch raises rather than moving to the
    CPU."""
    assert inspect.signature(fn).parameters["device"].default == "cuda"


def test_plain_versions_do_not_count_as_launches():
    probes.reset_launch_counts()
    probes.scale_copy(torch.ones(8, dtype=torch.bfloat16))
    probes.probe_mm(torch.ones(8, 128, dtype=torch.bfloat16), torch.ones(128, 128, dtype=torch.bfloat16))
    assert set(probes.launches) == set(probe_tool.PROBES) and not any(probes.launches.values())


@pytest.mark.parametrize("work, want_ms, want_by", [
    # the bounds the kernel table states, from the shapes alone
    ((2 * 2**21 * 128 * 128, 2 * (2 * 2**21 * 128)), 0.3205, "bytes"),               # probe_mm
    ((2 * 2**21 * 160 * 128, 2 * 2**21 * (160 + 128)), 0.3606, "bytes"),             # probe_conv1
    ((2 * 2**21 * 9 * 128 * 32, 2 * 2**21 * (128 + 32)), 0.2003, "bytes"),           # probe_conv2
    ((2 * 2**21 * (64 * 128 + 9 * 128 * 32), 2 * 2**21 * (64 + 32)), 0.1911, "operations"),  # K1, C = 64
    ((2 * 2**21 * 64 * 128, 2 * 2**21 * 64), 0.0801, "bytes"),                       # K2, C = 64
])
def test_bound_is_the_larger_of_bytes_and_operations(work, want_ms, want_by):
    ms, by = probe_tool.bound_ms(*work)
    assert by == want_by and ms == pytest.approx(want_ms, rel=2e-3)


def test_select_maps_pallas_probes_to_kernels():
    assert probe_tool.select("") is None
    assert probe_tool.select("p1,p5") == ["probe_mm", "probe_conv1", "probe_conv1_wgmma", "probe_conv2_taps9",
                                          "probe_conv2_packed", "probe_conv2_wgmma"]
    assert probe_tool.select("conv1_wgmma") == ["probe_conv1_wgmma"]
    assert probe_tool.select("conv2_wgmma") == probe_tool.select("probe_conv2_wgmma") == ["probe_conv2_wgmma"]
    assert probe_tool.select("P3") == ["probe_mm", "probe_scale_copy"]
    assert probe_tool.select("conv2_packed, p4") == ["probe_conv2_packed", "probe_scale_copy_staged",
                                                     "probe_scale_copy_bulk"]
    with pytest.raises(ValueError, match="unknown probe"):
        probe_tool.select("p6")


def test_turns_alternate_kernel_and_library():
    """turns_ms times kernel, library, library, kernel, ... and takes each
    side's median and [min, max] from that side's readings alone."""
    order, readings = [], iter([1.0, 10.0, 11.0, 4.0, 2.0, 13.0, 12.0, 3.0])

    def fake_timer(fn):
        order.append(fn())
        return next(readings)

    t = probe_tool.turns_ms(lambda: "kernel", lambda: "library", timer=fake_timer)
    assert order == ["kernel", "library", "library", "kernel"] * (probe_tool.TURN_ROUNDS // 2)
    assert t == {"ms": 2.5, "ms_spread": [1.0, 4.0], "library_ms": 11.5, "library_ms_spread": [10.0, 13.0]}
    assert probe_tool.turn_verdict(t) == "faster than"
    with pytest.raises(ValueError, match="3 rounds"):
        probe_tool.turns_ms(lambda: 0, lambda: 0, rounds=2, timer=fake_timer)


@pytest.mark.parametrize("kernel, library, want", [
    ((1.5, [1.0, 2.0]), (3.5, [3.0, 4.0]), "faster than"),
    ((3.5, [3.0, 4.0]), (1.5, [1.0, 2.0]), "slower than"),
    ((2.0, [1.0, 3.0]), (3.0, [2.0, 4.0]), "tied with"),        # the spreads overlap
    ((2.0, [2.0, 2.0]), (1.5, [1.0, 2.0]), "tied with"),        # they touch
    ((0.3536, [0.3535, 0.3537]), (0.3541, [0.3540, 0.3542]), "tied with"),  # apart, 0.14 %: within the drift
    ((0.3850, [0.3845, 0.3850]), (0.3842, [0.3841, 0.3844]), "tied with"),  # apart, 0.2 % slower: the same
])
def test_turn_verdict_judges_by_the_spreads(kernel, library, want):
    """A verdict other than 'tied with' needs spreads that do not overlap and
    medians more than RUN_DRIFT apart."""
    (ms, spread), (library_ms, library_spread) = kernel, library
    row = {"ms": ms, "ms_spread": spread, "library_ms": library_ms, "library_ms_spread": library_spread}
    assert probe_tool.turn_verdict(row) == want


def test_answers_say_how_each_copy_compares_with_the_library():
    """P3a and P4 each name their verdict against torch.mul from the turns."""
    def row(name, ms, spread):
        return {"name": name, "ms": ms, "ms_spread": spread, "library": "torch.mul(a, 2)", "library_ms": 0.355,
                "library_ms_spread": [0.354, 0.356], "bytes": 2**30, "gbs": 2**30 / ms / 1e6,
                "share": 0.3205 / ms}
    rows = [row("probe_scale_copy", 0.350, [0.349, 0.351]), row("probe_scale_copy_staged", 0.355, [0.353, 0.357]),
            row("probe_scale_copy_bulk", 0.360, [0.359, 0.361])]
    said = {a["question"].split(" ")[0]: a["answer"] for a in probe_tool.answers(rows)}
    assert "faster than the library" in said["P3a"]
    assert "probe_scale_copy_staged 0.3550 ms [0.3530-0.3570]" in said["P4"] and "tied with torch.mul" in said["P4"]
    assert "slower than torch.mul" in said["P4"]


def test_probe_tool_runs_on_the_cpu_without_times():
    """The slice as a whole at a tiny size: a row for every probe, each within
    its tolerance of the plain version, and no time under a device metric's
    name. The entry point itself refuses to run without a card."""
    rows = probe_tool.run(device="cpu", size="tiny")
    assert [r["name"] for r in rows] == list(probe_tool.PROBES)
    for r in rows:
        assert r["device"] == "cpu" and r["max_abs_err"] <= r["tol"]["atol"] + r["tol"]["rtol"] * 8
        assert all(r[k] is None for k in ("ms", "ms_spread", "share", "tflops", "gbs", "library_ms",
                                          "library_ms_spread", "plain_ms"))
        assert r["bound_ms"] > 0 and r["bound_by"] == "bytes" and r["replaces"].startswith("tools/probe_pallas")
    assert probe_tool.answers(rows) == []
    if not torch.cuda.is_available():
        assert probe_tool.main([]) == 2

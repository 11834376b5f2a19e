"""The port's native runtime on the CPU: the bundle's programs, the C++
operators' schemas, and ``aoti_runner`` built from source.

- **The bundle's programs.** Two exports (``io.export.export_forward``),
  each once for the module: the generator in bf16 batch BN, whose graph
  holds all three kernel ops (``channel_stats`` only runs on bf16), held
  to JAX's fp32 output by the PSNR criterion; and the uint8 contract of
  ``export_native_bundle`` (fp32, running BN), within one level of JAX's
  float output quantised on ≥ 99 % of values. The JAX reference is one
  jitted function.
- **The two schema definitions.** ``native/fdgan_ops.cpp``'s ``m.def``
  strings are ``ops/library.py``'s, read from the source.
- **The runner.** ``aoti_runner`` built with ``g++`` against the installed
  torch (``ops.build.aoti_runner``), serving one AOTInductor package of a
  one-line uint8 module (255 − x, so that every byte shows the program
  ran): the round trip, a wrong input size, the HTTP daemon, reload and its
  409s, and the faults of ``ADVICE.md``'s round 5 (JSON-escaped error
  text, a failed load that keeps the old package serving, ``POST /reload``
  without a ``Content-Length``). A package of another output arity
  (fault 2) needs a second compile: ``chip_smoke.py`` phase 13 proves it
  on the card.
"""

import collections
import copy
import http.client
import json
import os
import re
import shutil
import socket
import subprocess
import time

import jax
import numpy as np
import pytest
import torch

from fdgan_tpu.models import fdgan as jfdgan
from fdgan_tpu.models import fdgan_fast as jfast
from fdgan_tpu_torch.io import export
from fdgan_tpu_torch.io.torch_import import state_dict_from_jax
from fdgan_tpu_torch.models import fdgan_fast
from fdgan_tpu_torch.models.fdgan import FDGAN
from fdgan_tpu_torch.ops import build, library
from zoo_params import random_params

SIZE = 8  # the one-line package's image: (1, 8, 8, 3) uint8


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# --- the bundle's programs ------------------------------------------------------

@pytest.fixture(scope="module")
def case():
    params = random_params(lambda: jfdgan.init(jax.random.PRNGKey(0)), 0)
    # 8-bit values, so that the uint8 program's bytes are exactly JAX's input
    x = (np.random.default_rng(1).integers(0, 256, (2, 32, 32, 3)) / 255.0).astype(np.float32)
    both = jax.jit(lambda p, x: (jfast.apply(p, x, bn_mode="batch"), jfast.apply(p, x, bn_mode="running")))
    refs = dict(zip(("batch", "running"), (np.asarray(y) for y in both(params, x))))
    model = FDGAN()
    model.load_state_dict(state_dict_from_jax(params), strict=True)
    return model.eval(), x, refs


@pytest.fixture(scope="module")
def bf16_batch(case):
    return export.export_forward(case[0], image_size=32, batch=2, precision="bf16", bn_mode="batch", device="cpu")


@pytest.fixture(scope="module")
def uint8_running(case):
    return export.export_forward(case[0], image_size=32, batch=2, precision="fp32", bn_mode="running", device="cpu",
                                 io="uint8")


def _psnr(a, b) -> float:
    """PSNR of two [-1, 1] images, peak 2."""
    return float(10 * np.log10(4.0 / np.mean((a.astype(np.float64) - b) ** 2)))


def test_bf16_program_holds_every_kernel_op(bf16_batch):
    """K1 42 and K2 42 times, and channel_stats 45: the 3 block inputs and
    the 42 new 32-channel slices of a batch-BN forward."""
    ops = collections.Counter(str(n.target) for n in bf16_batch.graph.nodes
                              if n.op == "call_function" and str(n.target).startswith("fdgan."))
    assert ops == {"fdgan.dense_layer.default": 42, "fdgan.h_stats.default": 42, "fdgan.channel_stats.default": 45}


def test_bf16_program_by_the_psnr_criterion(case, bf16_batch):
    """The bf16 program against JAX's fp32 output: PSNR no more than 1 dB
    below the port's eager bf16 forward's (the chip's bf16 criterion), and
    within test_torch_fdgan_fast.py's bf16 bound."""
    model, x, refs = case
    with torch.inference_mode():
        got = bf16_batch.module()(torch.from_numpy(x)).numpy()
        eager = fdgan_fast.apply(copy.deepcopy(model).to(torch.bfloat16), torch.from_numpy(x).bfloat16(),
                                 bn_mode="batch").float()
    assert got.dtype == np.float32 and got.shape == (2, 32, 32, 3)
    assert _psnr(got, refs["batch"]) >= _psnr(eager.numpy(), refs["batch"]) - 1.0
    np.testing.assert_allclose(got, refs["batch"], atol=6e-2)


def test_uint8_program_is_jax_quantised(case, uint8_running):
    """io="uint8": bytes in, bytes out, the conversions inside; within one
    level of JAX's float output quantised, and equal on ≥ 99 % of values."""
    _, x, refs = case
    src = np.round(x * 255).astype(np.uint8)
    assert export.signature_lines(uint8_running) == ["u8 2 32 32 3", "u8 2 32 32 3"]
    runner = export.ArtifactRunner(uint8_running)
    assert runner.input == "uint8"
    got = np.stack(runner(list(src)))
    assert got.dtype == np.uint8 and np.array_equal(got, np.stack(runner(list(src.astype(np.float32) / 255.0))))
    want = np.clip(np.round((refs["running"] + 1.0) * 127.5), 0, 255)
    diff = np.abs(got.astype(np.int16) - want)
    assert np.array_equal(src.astype(np.float32) / 255.0, x)  # the program's input is JAX's
    assert diff.max() <= 1 and (diff == 0).mean() >= 0.99


# --- the two schema definitions -------------------------------------------------

def test_cpp_schemas_are_the_python_ones():
    src = open(build.NATIVE / "fdgan_ops.cpp").read()
    defs = re.findall(r'm\.def\("([^"]+)"\)', src)
    assert defs == list(library.SCHEMAS.values())
    assert re.findall(r'm\.impl\("(\w+)"', src) == list(library.SCHEMAS)
    for name in library.SCHEMAS:  # and the live op's own schema, as torch parsed it
        assert str(getattr(torch.ops.fdgan, name).default._schema) == f"fdgan::{library.SCHEMAS[name]}"


# --- the runner ----------------------------------------------------------------------

class _Inv(torch.nn.Module):
    def forward(self, x):
        return 255 - x


@pytest.fixture(scope="module")
def runner(tmp_path_factory):
    return str(build.aoti_runner(tmp_path_factory.mktemp("runner")))


@pytest.fixture(scope="module")
def bundle(tmp_path_factory):
    """The one-line package, its .sig, and two siblings: a copy (new
    weights of the same signature) and a package of garbage bytes."""
    d = tmp_path_factory.mktemp("bundle")
    base = str(d / "inv")
    x = torch.zeros((1, SIZE, SIZE, 3), dtype=torch.uint8)
    exported = torch.export.export(_Inv(), (x,), strict=False)
    torch._inductor.aoti_compile_and_package(exported, package_path=base + ".pt2",
                                             inductor_configs={"cpp.cxx": (None, build.cxx())})
    sig = "\n".join(export.signature_lines(exported)) + "\n"
    for name in ("inv", "copy", "garbage"):
        open(d / f"{name}.sig", "w").write(sig)
    shutil.copy(base + ".pt2", d / "copy.pt2")
    open(d / "garbage.pt2", "wb").write(b'not a "package"\n' * 64)
    return base


def _image(seed):
    return np.random.default_rng(seed).integers(0, 256, (1, SIZE, SIZE, 3), dtype=np.uint8)


def test_runner_round_trip(runner, bundle, tmp_path):
    img = _image(0)
    img.tofile(tmp_path / "in.raw")
    res = subprocess.run([runner, bundle, "--input", str(tmp_path / "in.raw"), "--output", str(tmp_path / "out.raw"),
                          "--loops", "2"], capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
    assert len(re.findall(r"^iter \d: ", res.stdout, re.M)) == 2
    assert json.loads(res.stdout.strip().splitlines()[-1]) == {"launches": None}  # no --ops library
    np.testing.assert_array_equal(np.fromfile(tmp_path / "out.raw", np.uint8), 255 - img.ravel())


def test_runner_rejects_a_wrong_input_size(runner, bundle, tmp_path):
    (tmp_path / "bad.raw").write_bytes(b"\0" * 17)
    res = subprocess.run([runner, bundle, "--input", str(tmp_path / "bad.raw")], capture_output=True, text=True,
                         timeout=120)
    assert res.returncode != 0 and "signature needs 192 B" in res.stderr
    res = subprocess.run([runner, bundle + "_missing"], capture_output=True, text=True, timeout=120)
    assert res.returncode != 0 and ".sig" in res.stderr


@pytest.fixture
def daemon(runner, bundle):
    """``aoti_runner --serve`` on a free port; yields a request function."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    proc = subprocess.Popen([runner, bundle, "--serve", str(port)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)

    def req(method, path, body=None, headers=None):
        c = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
        c.request(method, path, body=body, headers=headers or {})
        r = c.getresponse()
        data = r.read()
        c.close()
        return r.status, dict(r.getheaders()), data

    try:
        t0 = time.time()
        while True:
            assert proc.poll() is None, proc.stdout.read()
            try:
                if req("GET", "/healthz")[0] == 200:
                    break
            except OSError:
                assert time.time() - t0 < 60, "the daemon never came up"
                time.sleep(0.1)
        req.port = port
        yield req
    finally:
        proc.kill()
        proc.wait()


def _raw(port, head: bytes) -> bytes:
    """Send a hand-written request (headers http.client would add itself)."""
    with socket.create_connection(("127.0.0.1", port), timeout=30) as s:
        s.sendall(head)
        data = b""
        while chunk := s.recv(65536):
            data += chunk
    return data


def _wait_version(req, version):
    t0 = time.time()
    while time.time() - t0 < 60:
        h = json.loads(req("GET", "/healthz")[2])
        if h["weights_version"] == version and not h["reloading"]:
            return h
        time.sleep(0.05)
    raise AssertionError(f"weights_version never reached {version}: {h}")


def test_serve_daemon_http(daemon):
    """/dehaze's raw bytes with the Python server's headers, from several
    clients at once; a wrong size 400 (too large 413); an unknown path 404."""
    import concurrent.futures as cf

    bodies = [_image(i).tobytes() for i in range(8)]
    with cf.ThreadPoolExecutor(4) as ex:
        results = list(ex.map(lambda b: daemon("POST", "/dehaze", b), bodies))
    for body, (status, headers, data) in zip(bodies, results):
        assert status == 200 and data == bytes(255 - b for b in body)
        assert (headers["X-Image-Shape"], headers["X-Image-Dtype"]) == (f"{SIZE}x{SIZE}x3", "uint8")
    status, _, data = daemon("POST", "/dehaze", b"\1\2")
    assert status == 400 and b"192" in data
    assert daemon("POST", "/dehaze", b"\0" * 200)[0] == 413
    assert daemon("POST", "/nope", b"x")[0] == 404
    st = json.loads(daemon("GET", "/stats")[2])
    assert (st["served"], st["device"], st["launches"]) == (8, "cpu", None)


def test_serve_reload_and_its_409s(daemon, bundle):
    """A reload loads on a thread and swaps before the next request
    (weights_version 1); a second reload while one is in flight is a 409;
    a .sig mismatch is a 409; serving never stops."""
    d = os.path.dirname(bundle)
    img = _image(9).tobytes()
    status, _, data = daemon("POST", "/reload", f"{d}/copy".encode())
    assert status == 202 and json.loads(data)["status"] == "loading"
    status, _, data = daemon("POST", "/reload", bundle.encode())
    assert status == 409 and b"already in progress" in data
    _wait_version(daemon, 1)
    st = json.loads(daemon("GET", "/stats")[2])
    assert (st["weights_version"], st["bundle"], st["last_reload_error"]) == (1, f"{d}/copy", "")
    assert daemon("POST", "/dehaze", img)[2] == bytes(255 - b for b in img)
    open(f"{d}/small.sig", "w").write("u8 1 4 4 3\nu8 1 4 4 3\n")
    status, _, data = daemon("POST", "/reload", f"{d}/small".encode())
    assert status == 409 and b"signature mismatch" in data


def test_serve_advice_faults(daemon, bundle):
    """ADVICE r5: (1) error text and paths are JSON-escaped in /stats and in
    error bodies; (3) a package that fails to load is caught and reported,
    and the old one keeps serving; (4) POST /reload without a
    Content-Length, or chunked, is a 400, and Content-Length: 0 re-promotes
    the current bundle."""
    d = os.path.dirname(bundle)
    img = _image(3).tobytes()
    quoted = f'{d}/no "such"\tbundle'
    status, _, data = daemon("POST", "/reload", quoted.encode())
    assert status == 400 and json.loads(data)["error"] == f"cannot read {quoted}.sig"
    status, _, data = daemon("POST", "/reload", f"{d}/garbage".encode())
    assert status == 202
    t0 = time.time()
    while (st := json.loads(daemon("GET", "/stats")[2]))["reloading"]:
        assert time.time() - t0 < 60
        time.sleep(0.05)
    assert st["weights_version"] == 0 and st["last_reload_error"] and st["bundle"] == bundle
    assert daemon("POST", "/dehaze", img)[2] == bytes(255 - b for b in img)
    head = f"POST /reload HTTP/1.1\r\nHost: 127.0.0.1\r\n".encode()
    assert b" 400 " in _raw(daemon.port, head + b"\r\n").split(b"\r\n")[0]
    chunked = head + b"Transfer-Encoding: chunked\r\n\r\n0\r\n\r\n"
    assert b" 400 " in _raw(daemon.port, chunked).split(b"\r\n")[0]
    status, _, data = daemon("POST", "/reload", b"")
    assert status == 202 and json.loads(data)["bundle"] == bundle
    _wait_version(daemon, 1)
    assert daemon("POST", "/dehaze", img)[2] == bytes(255 - b for b in img)

"""The port's InferenceEngine and BatchingFrontend on the CPU.

Cases follow tests/test_serve.py where they apply. The engine runs the
full-width generator at 16-24 px; staging-only cases use an identity
forward.
"""

import threading
import time

import numpy as np
import pytest
import torch

from fdgan_tpu_torch.models.fdgan import FDGAN
from fdgan_tpu_torch.serve import InferenceEngine
from fdgan_tpu_torch.serve_http import BatchingFrontend


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread (tests/test_torch_remat.py's fixture): beside the
    suite's other workers, torch's default threads make these CPU forwards
    far slower than one thread does."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def model():
    return FDGAN(generator=torch.Generator().manual_seed(0))


@pytest.fixture(scope="module")
def engine(model):
    return InferenceEngine(model, device="cpu", precision="fp32", bucket=8, batch_sizes=(1, 2))


def _direct(engine, img):
    """Expected result: pad to the bucket, run the engine's forward alone, crop."""
    H, W = engine._bucket_hw(img.shape[0], img.shape[1])
    x = InferenceEngine._pad_hw(engine._ingest(img), H, W)[None]
    with torch.inference_mode():
        y = engine._forward(engine._model, torch.from_numpy(x)).numpy()
    return y[0, : img.shape[0], : img.shape[1]]


def _identity_engine(model, **kw):
    eng = InferenceEngine(model, device="cpu", precision="fp32", bucket=8, **kw)
    seen = []

    def forward(model, x):
        seen.append(x.clone())
        return x.float()

    eng._forward = forward
    return eng, seen


def test_predict_batch_ragged_in_order(engine, np_rng):
    imgs = [np_rng.uniform(size=s).astype(np.float32) for s in [(16, 20, 3), (24, 24, 3), (17, 16, 3)]]
    outs = engine.predict_batch(imgs)
    assert [o.shape for o in outs] == [i.shape for i in imgs]
    for img, out in zip(imgs, outs):
        assert out.dtype == np.float32 and np.isfinite(out).all()
        np.testing.assert_allclose(out, _direct(engine, img), rtol=0, atol=1e-6)


def test_stream_matches_predict_batch(engine, np_rng):
    imgs = [np_rng.uniform(size=(16 + 8 * (i % 2), 16, 3)).astype(np.float32) for i in range(5)]
    ref = engine.predict_batch(imgs)
    for depth in (1, 3):
        got = list(engine.stream(iter(imgs), depth=depth))
        assert len(got) == len(ref)
        for a, b in zip(got, ref):
            np.testing.assert_array_equal(a, b)


def test_ladder_padding_cycles_real_images(model, np_rng):
    eng, seen = _identity_engine(model, batch_sizes=(4,))
    imgs = [np_rng.uniform(size=(8, 8, 3)).astype(np.float32) for _ in range(3)]
    outs = eng.predict_batch(imgs)
    (batch,) = seen
    assert batch.shape == (4, 8, 8, 3)
    np.testing.assert_array_equal(batch[3].numpy(), imgs[0])  # slot 3 repeats image 0
    for img, out in zip(imgs, outs):
        np.testing.assert_array_equal(out, img)
    assert eng.stats["images"] == 3 and eng.stats["batches"] == 1


def test_uint8_io_matches_float_path(model, engine, np_rng):
    eng_u8 = InferenceEngine(
        model, device="cpu", precision="fp32", bucket=8, batch_sizes=(1, 2), input="uint8", output="uint8"
    )
    img = np_rng.integers(0, 256, size=(16, 24, 3), dtype=np.uint8)
    y_float = engine.predict(img)  # uint8 into a float engine: /255 on the host
    y_u8 = eng_u8.predict(img)
    assert y_u8.dtype == np.uint8 and y_u8.shape == img.shape
    np.testing.assert_allclose(y_u8.astype(np.float32) / 127.5 - 1.0, y_float, rtol=0, atol=1.0 / 255 + 1e-6)
    # a float image into a uint8-input engine is quantised on the host first
    y_q = eng_u8.predict(img.astype(np.float32) / 255.0)
    np.testing.assert_array_equal(y_q, y_u8)


def test_reload_swaps_and_rejects_mismatches(model, np_rng):
    eng = InferenceEngine(model, device="cpu", precision="bf16", bucket=8, batch_sizes=(1,))
    img = np_rng.uniform(size=(16, 16, 3)).astype(np.float32)
    before = eng.predict(img)
    other = FDGAN(generator=torch.Generator().manual_seed(1))
    assert eng.reload(other) == 1 and eng.stats["reloads"] == 1
    assert not np.array_equal(eng.predict(img), before)

    state = other.state_dict()
    with pytest.raises(ValueError, match="structure"):
        eng.reload({k: v for k, v in state.items() if k != "conv0.weight"})
    bad = dict(state)
    bad["conv_refin1.weight"] = torch.zeros(64, 3, 5, 5)
    with pytest.raises(ValueError, match="shape"):
        eng.reload(bad)
    fp32_engine = InferenceEngine(model, device="cpu", precision="fp32", bucket=8, batch_sizes=(1,))
    with pytest.raises(ValueError, match="dtype"):
        fp32_engine.reload({k: v.bfloat16() for k, v in state.items()})
    assert eng.weights_version == 1 and fp32_engine.weights_version == 0


def test_stream_max_wait_flushes_a_lone_image(model, np_rng):
    eng, _ = _identity_engine(model, batch_sizes=(4,))
    imgs = [np_rng.uniform(size=(8, 8, 3)).astype(np.float32) for _ in range(2)]
    release = threading.Event()

    def stalling():
        yield imgs[0]
        release.wait(timeout=10.0)  # the producer goes idle
        yield imgs[1]

    gen = eng.stream(stalling(), max_wait=0.05)
    t0 = time.monotonic()
    first = next(gen)  # must come from the idle-tick flush, not an arrival
    waited = time.monotonic() - t0
    release.set()
    np.testing.assert_array_equal(first, imgs[0])
    assert waited < 5.0, f"idle flush did not fire (waited {waited:.2f}s)"
    rest = list(gen)
    assert len(rest) == 1
    np.testing.assert_array_equal(rest[0], imgs[1])


def test_frontend_submit_from_threads(engine, np_rng):
    imgs = [np_rng.uniform(size=(16 + 8 * (i % 2), 16 + 8 * (i % 3 == 0), 3)).astype(np.float32) for i in range(6)]
    expected = [_direct(engine, img) for img in imgs]
    fe = BatchingFrontend(engine, max_wait=0.02)
    futs = [None] * len(imgs)
    try:
        def worker(k):
            for i in range(k, len(imgs), 3):
                futs[i] = fe.submit(imgs[i])

        threads = [threading.Thread(target=worker, args=(k,)) for k in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
            assert not t.is_alive()
        for fut, img, ref in zip(futs, imgs, expected):
            out = fut.result(timeout=60)
            assert out.shape == img.shape
            np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5)
        assert fe.latency_stats()["latency_n"] == len(imgs)
    finally:
        fe.close()
    with pytest.raises(RuntimeError, match="closed"):
        fe.submit(imgs[0])


def test_engine_argument_validation(model):
    for kw, msg in [
        ({"bucket": 12}, "multiple of 8"),
        ({"batch_sizes": (2, 1)}, "ascending"),
        ({"precision": "fp16"}, "precision"),
        ({"output": "int8"}, "output"),
        ({"bn_mode": "eval"}, "bn_mode"),
    ]:
        with pytest.raises(ValueError, match=msg):
            InferenceEngine(model, device="cpu", **kw)
    eng = InferenceEngine(model, device="cpu", bn_mode="batch")
    assert eng.bucket == 8 and eng.batch_sizes == (1, 2, 4, 8)
    with pytest.raises(ValueError, match="HWC RGB"):
        eng.predict(np.zeros((8, 8), np.float32))


def _png(path, rng, h, w):
    from PIL import Image

    Image.fromarray(rng.integers(0, 256, size=(h, w, 3), dtype=np.uint8)).save(path)


def test_cli_serve_folder_with_pth(model, tmp_path, np_rng):
    """The folder pass: .pth with DataParallel prefixes in, PNGs of the input
    sizes out."""
    from PIL import Image

    from fdgan_tpu_torch.cli import serve as cli

    src, dst = tmp_path / "hazy", tmp_path / "out"
    src.mkdir()
    _png(src / "a.png", np_rng, 16, 24)
    _png(src / "b.jpg", np_rng, 20, 16)
    ckpt = tmp_path / "netG.pth"
    torch.save({f"module.{k}": v for k, v in model.state_dict().items()}, ckpt)
    cli.main(["--inDir", str(src), "--outDir", str(dst), "--netG", str(ckpt), "--device", "cpu",
              "--bucket", "8", "--maxBatch", "2", "--precision", "fp32"])
    assert Image.open(dst / "a.png").size == (24, 16)
    assert Image.open(dst / "b.png").size == (16, 20)


def test_http_dehaze_stats_and_health(engine, np_rng, tmp_path):
    import io
    import json
    import urllib.request

    from PIL import Image

    from fdgan_tpu_torch.serve_http import make_server

    server = make_server(engine, port=0, max_wait=0.02)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        _png(tmp_path / "x.png", np_rng, 16, 24)
        req = urllib.request.Request(f"{base}/dehaze", data=(tmp_path / "x.png").read_bytes(), method="POST")
        with urllib.request.urlopen(req, timeout=60) as r:
            assert r.headers["X-Image-Shape"] == "16x24x3"
            assert Image.open(io.BytesIO(r.read())).size == (24, 16)
        with urllib.request.urlopen(f"{base}/healthz", timeout=10) as r:
            health = json.loads(r.read())
        assert health["ok"] and health["devices"] == ["cpu"]
        with urllib.request.urlopen(f"{base}/stats", timeout=10) as r:
            stats = json.loads(r.read())
        assert stats["images"] >= 1 and stats["latency_n"] == 1 and "k1_launches" in stats
    finally:
        server.shutdown()
        server.frontend.close()
        thread.join(timeout=10)
    assert not thread.is_alive()


# --- warmup and auto-warm ------------------------------------------------------

def test_warmup_runs_every_rung_outside_the_statistics(model, np_rng):
    """As tests/test_serve.py's warmup cases: ``warmup`` of one shape runs
    each ladder rung once (``stats["compiles"]`` 2, one per rung) and moves
    no other statistic; later requests of that bucket at either rung count
    no compile, and their outputs are the unwarmed engine's, bit for bit."""
    eng = InferenceEngine(model, device="cpu", precision="fp32", bucket=8, batch_sizes=(1, 2))
    cold = InferenceEngine(model, device="cpu", precision="fp32", bucket=8, batch_sizes=(1, 2))
    eng.warmup([(16, 14)])  # the bucket (16, 16)
    assert eng.stats["compiles"] == 2
    assert (eng.stats["batches"], eng.stats["images"], eng.stats["padded_frac"]) == (0, 0, 0.0)
    imgs = [np_rng.uniform(size=(16, 16, 3)).astype(np.float32) for _ in range(3)]
    got = [eng.predict(imgs[0])] + eng.predict_batch(imgs[1:])
    assert eng.stats["compiles"] == 2 and eng.stats["batches"] == 2
    want = [cold.predict(imgs[0])] + cold.predict_batch(imgs[1:])
    assert cold.stats["compiles"] == 2  # each rung's first batch counts as a compile
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_warmup_of_one_rung(model):
    eng, seen = _identity_engine(model, batch_sizes=(1, 2, 4))
    eng.warmup([(8, 8), (16, 8)], batch=2)
    assert [tuple(x.shape) for x in seen] == [(2, 8, 8, 3), (2, 16, 8, 3)]
    assert eng.stats["compiles"] == 2 and eng.stats["batches"] == 0
    eng.warmup([(8, 8)], batch=2)  # already run: no compile
    assert eng.stats["compiles"] == 2


def _settled(eng, key, timeout=60.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        with eng._lock:
            if key in eng._warmed and not eng._warming:
                return True
        time.sleep(0.05)
    return False


def test_auto_warm_backfills_the_ladder(model, np_rng):
    """tests/test_serve.py::test_auto_warm_backfills_ladder: a new bucket's
    first request starts a background run of its other rungs; once it is
    done, a request at the other rung counts no compile (the background
    runs are not counted), and the dedup is permanent."""
    eng, seen = _identity_engine(model, batch_sizes=(1, 2), auto_warm=True)
    img = np_rng.uniform(size=(16, 16, 3)).astype(np.float32)
    assert eng.predict(img).shape == img.shape
    assert eng.stats["compiles"] == 1
    assert _settled(eng, (16, 16)), "the warm never finished"
    assert [tuple(x.shape) for x in seen] == [(1, 16, 16, 3), (2, 16, 16, 3)]  # the request, then rung 2
    assert len(eng.predict_batch([img, img])) == 2
    assert eng.stats["compiles"] == 1 and eng.stats["batches"] == 2
    spawned = []
    eng._spawn_auto_warm = lambda *a: spawned.append(a)
    eng.predict(np_rng.uniform(size=(16, 16, 3)).astype(np.float32))
    assert spawned == []  # not a new shape: nothing to warm


def test_auto_warm_failure_never_stops_serving(model, np_rng):
    """A warm that raises is swallowed: the bucket counts as warmed (never
    retried) and requests go on being served."""
    eng, _ = _identity_engine(model, batch_sizes=(1, 2), auto_warm=True)

    def broken(*args):
        raise RuntimeError("a warm that fails")

    eng._warm_one = broken
    img = np_rng.uniform(size=(8, 8, 3)).astype(np.float32)
    assert eng.predict(img).shape == img.shape
    assert _settled(eng, (8, 8))
    assert len(eng.predict_batch([img, img])) == 2 and eng.stats["batches"] == 2


def test_auto_warm_under_concurrent_requests(model, np_rng):
    """Eight threads (more than the cores the suite gives a worker) send
    requests of three new buckets at both rungs while the auto-warm threads
    run, with a short switch interval: every bucket is warmed once, and
    ``stats["compiles"]`` counts each (batch, H, W) shape the request path
    met first exactly once, which a lost update under the lock would
    break. The engine's bookkeeping is under test, so the forward is the
    identity."""
    import sys

    eng, _ = _identity_engine(model, batch_sizes=(1, 2), auto_warm=True)
    warmed = []  # each background run of a rung: (batch, H, W)
    warm_one = eng._warm_one
    eng._warm_one = lambda *a: (warmed.append(a), warm_one(*a))
    sizes = [(8, 8), (8, 16), (16, 8)]
    imgs = {s: np_rng.uniform(size=s + (3,)).astype(np.float32) for s in sizes}
    errors = []

    def client(k):
        try:
            for j in range(3):
                s = sizes[(k + j) % 3]
                if (k + j) % 2:
                    eng.predict(imgs[s])
                else:
                    eng.predict_batch([imgs[s], imgs[s]])
        except Exception as e:  # read below: a failed request fails the test
            errors.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=client, args=(k,)) for k in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
        assert all(_settled(eng, s) for s in sizes)
    finally:
        sys.setswitchinterval(interval)
    assert errors == []
    assert len(warmed) == len(set(warmed)) == len(sizes)  # a bucket's other rung, once, ever
    assert eng._warmed == set(sizes) and eng.stats["batches"] == 8 * 3
    assert eng.stats["compiles"] <= 2 * len(sizes) and eng._seen == {(b, h, w, False) for b in (1, 2) for h, w in sizes}


def test_cli_serve_warmup_flags_parse_as_jax():
    """--warmup/--noWarmup/--autoWarm/--noAutoWarm: the JAX CLI's flags and
    defaults, its parse of the shapes and its message for a bad one, and
    --http's default warmup of the bucket shape."""
    from fdgan_tpu.cli import serve as jserve
    from fdgan_tpu_torch.cli import serve as cli

    flags = ("warmup", "noWarmup", "autoWarm", "noAutoWarm")
    port, ref = vars(cli.build_parser().parse_args([])), vars(jserve.build_parser().parse_args([]))
    assert {k: port[k] for k in flags} == {k: ref[k] for k in flags}

    def shapes(*argv):
        return cli.warmup_shapes(cli.build_parser().parse_args(list(argv)))

    assert shapes("--warmup", "384x512, 720X1280") == [(384, 512), (720, 1280)]
    assert shapes("--http", "8731") == [(64, 64)] and shapes("--http", "8731", "--bucket", "32") == [(32, 32)]
    assert shapes("--http", "8731", "--noWarmup") == [] and shapes() == []
    for bad in ("384-512", "384x512x3", "axb"):
        with pytest.raises(SystemExit, match="--warmup must look like '384x512,720x1280', got "):
            shapes("--warmup", bad)


def test_cli_serve_warms_before_the_folder_pass(model, tmp_path, np_rng, capsys):
    """``--warmup 16x24 --autoWarm`` on a folder: every rung of the ladder at
    the shape's bucket before the pass (2 compiles, then the first request's
    bucket is new: auto-warm on), and the PNGs of the pass without it."""
    from PIL import Image

    from fdgan_tpu_torch.cli import serve as cli

    src = tmp_path / "hazy"
    src.mkdir()
    _png(src / "a.png", np_rng, 16, 24)
    ckpt = tmp_path / "netG.pth"
    torch.save(model.state_dict(), ckpt)
    common = ["--inDir", str(src), "--netG", str(ckpt), "--device", "cpu", "--bucket", "8", "--maxBatch", "2",
              "--precision", "fp32"]
    cli.main(common + ["--outDir", str(tmp_path / "warm"), "--warmup", "16x24", "--autoWarm"])
    assert "warmed 1 shape(s) x 2 ladder rungs in " in capsys.readouterr().out
    cli.main(common + ["--outDir", str(tmp_path / "cold")])
    np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "warm" / "a.png")),
                                  np.asarray(Image.open(tmp_path / "cold" / "a.png")))

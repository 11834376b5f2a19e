"""The port's span recorder (``fdgan_tpu_torch/trace.py``) on the CPU: on
exactly while a profile runs, in every thread; parents; the profiler's
clock; and the spans of the engine, the frontend and the train step."""

import threading
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from fdgan_tpu_torch import trace
from fdgan_tpu_torch.models.fdgan import FDGAN
from fdgan_tpu_torch.serve import InferenceEngine
from fdgan_tpu_torch.serve_http import BatchingFrontend


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _profiled():
    return profile(activities=[ProfilerActivity.CPU])


def _window(t0, name=None):
    return trace.spans(t0, time.time_ns() + 1, name)


@pytest.fixture(scope="module")
def model():
    return FDGAN(generator=torch.Generator().manual_seed(0))


def _engine(model, **kw):
    eng = InferenceEngine(model, device="cpu", precision="fp32", bucket=8, **kw)
    eng._forward = lambda m, x: x.float()
    return eng


def test_nothing_is_recorded_without_a_profiler():
    t0 = time.time_ns()
    with trace.span("test.off", k=1) as sp:
        assert not sp
    trace.record("test.off", t0, t0 + 1)
    assert trace.stamp() == 0
    assert _window(t0) == []


def test_spans_are_recorded_in_a_thread_started_before_the_profiler():
    go, done = threading.Event(), threading.Event()

    def worker():
        go.wait(timeout=30)
        with trace.span("test.thread"):
            pass
        done.set()

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    t0 = time.time_ns()
    with _profiled():
        assert trace.stamp() >= t0
        with trace.span("test.main") as sp:
            assert sp
        go.set()
        assert done.wait(timeout=30)
    t.join(timeout=30)
    assert not t.is_alive()
    assert [s.name for s in _window(t0)] == ["test.main", "test.thread"]


def test_nesting_sets_parent_ids():
    t0 = time.time_ns()
    with _profiled():
        with trace.span("test.outer") as outer:
            with trace.span("test.inner", k=2) as inner:
                trace.record("test.stamped", trace.stamp(), time.time_ns())
        with trace.span("test.after") as after:
            pass
    assert inner.parent == outer.id and outer.parent is None and after.parent is None
    assert inner.attrs == {"k": 2} and outer.start <= inner.start <= inner.end <= outer.end
    stamped = _window(t0, "test.stamped")
    assert len(stamped) == 1 and stamped[0].parent is None
    assert [s.name for s in _window(t0)] == ["test.outer", "test.inner", "test.stamped", "test.after"]


def test_a_span_lies_on_the_profilers_clock():
    x = torch.randn(256, 256)
    with _profiled() as prof:
        with trace.span("test.mm") as sp:
            torch.mm(x, x)
    events = [e for e in prof.profiler.kineto_results.events() if e.name() == "aten::mm"]
    assert events
    for e in events:
        assert sp.start <= e.start_ns() and e.start_ns() + e.duration_ns() <= sp.end


def _by_batch(spans):
    out = {}
    for s in spans:
        out.setdefault(s.attrs["batch"], []).append(s)
    return out


def test_stream_gives_four_spans_a_batch(model, np_rng):
    eng = _engine(model, batch_sizes=(2,))
    imgs = [np_rng.uniform(size=(8, 8, 3)).astype(np.float32) for _ in range(5)]
    t0 = time.time_ns()
    with _profiled():
        out = list(eng.stream(imgs, depth=1))
    assert len(out) == 5
    stage, dispatch, held, fetch = (_by_batch(_window(t0, f"engine.{n}")) for n in ("stage", "dispatch", "held",
                                                                                   "fetch"))
    assert set(stage) == set(dispatch) == set(held) == set(fetch) and len(stage) == 3
    assert all(len(v) == 1 for d in (stage, dispatch, held, fetch) for v in d.values())
    batches = sorted(stage)
    assert [stage[b][0].attrs["items"] for b in batches] == [[0, 1], [2, 3], [4]]
    assert [stage[b][0].attrs["why"] for b in batches] == ["full", "full", "end"]
    # on the CPU a result is back once dispatched: each batch is fetched at the poll after it
    assert [fetch[b][0].attrs["why"] for b in batches] == ["ready", "ready", "ready"]
    assert eng.stats["compiles"] == 1  # one shape: the last image fills a rung of 2
    for b in batches:
        assert stage[b][0].end <= dispatch[b][0].start
        assert held[b][0].start == dispatch[b][0].end and held[b][0].end == fetch[b][0].start


def _overflow(np_rng):
    # three buckets, three images each: the ninth is over 2 × top staged
    return [np_rng.uniform(size=(8 * (1 + i % 3), 8, 3)).astype(np.float32) for i in range(9)], {}


def _stalled(np_rng):
    img = np_rng.uniform(size=(8, 8, 3)).astype(np.float32)
    release = threading.Event()

    def stalling():
        yield img
        release.wait(timeout=10.0)
        yield img

    return stalling(), {"max_wait": 0.02, "release": release}


@pytest.mark.parametrize("why", ["full", "end", "overflow", "aged", "tiled"])
def test_stage_why_names_each_flush_path(model, np_rng, why):
    kw = {"tile": 24, "halo": 8} if why == "tiled" else {}
    eng = _engine(model, batch_sizes=(4,) if why in ("overflow", "aged") else (1, 2), **kw)
    stream_kw = {}
    if why == "full":
        imgs = [np_rng.uniform(size=(8, 8, 3)).astype(np.float32) for _ in range(2)]
    elif why == "end":
        imgs = [np_rng.uniform(size=(8, 8, 3)).astype(np.float32)]
    elif why == "overflow":
        imgs, stream_kw = _overflow(np_rng)
    elif why == "aged":
        imgs, stream_kw = _stalled(np_rng)
    else:
        imgs = [np_rng.uniform(size=(32, 32, 3)).astype(np.float32)]
    release = stream_kw.pop("release", None)
    t0 = time.time_ns()
    with _profiled():
        gen = eng.stream(imgs, depth=2, **stream_kw)
        first = next(gen)
        if release is not None:
            release.set()
        out = [first, *gen]
    assert len(out) == (2 if why in ("full", "aged") else len(imgs))
    whys = [s.attrs["why"] for s in _window(t0, "engine.stage")]
    assert whys[0] == why
    if why == "aged":
        # the aged batch, then the second image's, each fetched at the poll after its dispatch
        assert [s.attrs["why"] for s in _window(t0, "engine.fetch")] == ["ready", "ready"]


def test_frontend_queue_span_per_request(model, np_rng):
    eng = _engine(model, batch_sizes=(1, 2))
    fe = BatchingFrontend(eng, max_wait=0.02)  # its threads start before the profile
    imgs = [np_rng.uniform(size=(8, 8, 3)).astype(np.float32) for _ in range(5)]
    try:
        fe.submit(imgs[0]).result(timeout=60)  # index 0, before the profile: no span
        t0 = time.time_ns()
        with _profiled():
            for f in [fe.submit(img) for img in imgs]:
                f.result(timeout=60)
    finally:
        fe.close()
    queued = _window(t0, "frontend.queue")
    assert sorted(s.attrs["item"] for s in queued) == [1, 2, 3, 4, 5]
    staged = {i: s for s in _window(t0, "engine.stage") for i in s.attrs["items"]}
    # the wait ends as staging takes the request, before its batch is staged
    assert all(s.start <= s.end <= staged[s.attrs["item"]].start for s in queued)


def test_train_step_phase_spans():
    from fdgan_tpu_torch.losses.composite import LossWeights
    from fdgan_tpu_torch.train.loop import create_train_state, make_gd_steps

    state, tx_g, tx_d = create_train_state(0, device="cpu")
    g_step, d_step = make_gd_steps(tx_g, tx_d, LossWeights(perceptual=0.0), impl="plain")
    gen = torch.Generator().manual_seed(0)
    haze, gt = torch.rand(1, 32, 32, 3, generator=gen), torch.rand(1, 32, 32, 3, generator=gen)
    t0 = time.time_ns()
    with _profiled():
        state, _, x_hat = g_step(state, haze, gt)
        d_step(state, x_hat, gt)
    got = _window(t0)
    top = {s.name: s for s in got if s.parent is None}
    assert set(top) == {"train.g_step", "train.d_step"}
    children = {s.name: s.parent for s in got if s.parent is not None}
    g, d = top["train.g_step"].id, top["train.d_step"].id
    assert children == {"train.g_forward": g, "train.g_loss": g, "train.g_backward": g, "train.g_adam": g,
                        "train.bn_fold": g, "train.d_forward": d, "train.d_backward": d, "train.d_adam": d}

"""The device-resident training loop of the port on the CPU, against the JAX
package's: ``train/pool.py``'s device pool, ``train/loop.py``'s
``make_device_loop``, ``make_device_pool_loop`` and ``make_device_eval``, and
``io/checkpoint.AsyncCheckpointer``.

- ``pool_update`` fed the draws that JAX's ``device_pool_query`` takes from
  its key (``jax.random.split``, ``uniform``, ``randint``): the buffer, the
  fill count and the output bit for bit over 12 queries at pool size 2 (as
  ``tests/test_train_pool.py``); ``device_pool_query``'s own draws from a
  ``torch.Generator`` keep JAX's semantics.
- ``make_device_loop`` and ``make_device_pool_loop`` at 1×32² (JAX's
  ``tests/test_train.py:185``) against K sequential port steps on the same
  batches, bit for bit (losses and every tensor of the state), and
  ``make_device_loop`` against JAX's on the same trees (random, over
  ``jax.eval_shape``, ``tests/zoo_params.py``) and index vector: per-step
  ``g_total`` at rtol 1e-5, JAX's own gate for its loop.
- ``make_device_eval`` against JAX's (``tests/test_train.py:232``) and
  against the port's host ``cli/train.py::evaluate``, rtol 1e-4.
- ``AsyncCheckpointer``, JAX's three cases (``tests/test_io.py:124-200``):
  the file is the state at ``save()`` although the state is updated in place
  before the writer reads it (a writer that read the live modules would
  write the update); saves serialise and a writer's error is raised by the
  next ``wait()``; a timed-out ``wait()`` keeps the writer's handle.

One JAX compile per fixture, each once per module; the port's steps run on
one intra-op thread.
"""

import os
import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fdgan_tpu.losses.composite import LossWeights as JLossWeights
from fdgan_tpu.models import fdgan as jfdgan
from fdgan_tpu.models.discriminators import nlayer_init
from fdgan_tpu.train import loop as jloop
from fdgan_tpu.train.pool import device_pool_init as jpool_init
from fdgan_tpu.train.pool import device_pool_query as jpool_query
from fdgan_tpu_torch.cli.train import evaluate as host_evaluate
from fdgan_tpu_torch.io import checkpoint
from fdgan_tpu_torch.io.checkpoint import AsyncCheckpointer
from fdgan_tpu_torch.io.torch_import import state_dict_from_jax
from fdgan_tpu_torch.losses.composite import LossWeights
from fdgan_tpu_torch.train.loop import (TrainState, create_train_state, make_device_eval, make_device_loop,
                                        make_device_pool_loop, make_gd_steps, make_train_step)
from fdgan_tpu_torch.train.pool import device_pool_init, device_pool_query, pool_update

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from zoo_params import random_params  # noqa: E402

SIZE, NB, IDX = 32, 2, [1, 0, 1]  # JAX's tests/test_train.py:185: 1×32², 2 staged batches, indices 1, 0, 1


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread (tests/test_torch_remat.py's fixture)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _staged(n=NB, b=1, size=SIZE, seed=0):
    """(n, b, H, W, 3) haze and gt: gt uniform, haze = clip(0.6·gt + 0.3)."""
    gt = np.random.default_rng(seed).uniform(size=(n, b, size, size, 3)).astype(np.float32)
    return np.clip(0.6 * gt + 0.3, 0, 1).astype(np.float32), gt


@pytest.fixture(scope="module")
def trees():
    gp = random_params(lambda: jfdgan.init(jax.random.PRNGKey(0)), 0)
    dp = random_params(lambda: nlayer_init(jax.random.PRNGKey(1), input_nc=9), 1)
    return {"gp": gp, "dp": dp, "g": state_dict_from_jax(gp), "d": state_dict_from_jax(dp)}


def _state(trees=None):
    state, tx_g, tx_d = create_train_state(0, device="cpu")
    if trees is not None:
        state.g.load_state_dict(trees["g"], strict=True)
        state.d.load_state_dict(trees["d"], strict=True)
    return state, tx_g, tx_d


def _same_state(a: TrainState, b: TrainState) -> bool:
    """Every tensor of G, D and both Adams equal bit for bit, and the counts."""
    if (a.step, a.d_updates) != (b.step, b.d_updates):
        return False
    for net in ("g", "d"):
        sa, sb = getattr(a, net).state_dict(), getattr(b, net).state_dict()
        if not all(torch.equal(v, sb[k]) for k, v in sa.items()):
            return False
        oa, ob = getattr(a, f"{net}_opt").state_dict()["state"], getattr(b, f"{net}_opt").state_dict()["state"]
        if oa.keys() != ob.keys() or not all(torch.equal(v, ob[i][k]) for i, e in oa.items() for k, v in e.items()):
            return False
    return True


# --- the device pool ------------------------------------------------------------

def test_pool_update_matches_jax_device_pool_query():
    """12 queries at pool size 2 of (1, 4, 4, 3) batches, each with the draws
    JAX's ``device_pool_query`` takes from ``PRNGKey(k)``: the buffer, the
    fill count and the output bit for bit after every query, the fill phase
    and both outcomes of the swap included."""
    rng = np.random.default_rng(3)
    imgs = [rng.uniform(size=(1, 4, 4, 3)).astype(np.float32) for _ in range(12)]
    jbuf, jn = jpool_init(2, (1, 4, 4, 3), jnp.float32)
    buf, n = device_pool_init(2, (1, 4, 4, 3), torch.float32, "cpu")
    swaps = set()
    for k, img in enumerate(imgs):
        key = jax.random.PRNGKey(k)
        jbuf, jn, jout = jpool_query(jbuf, jn, jnp.asarray(img), key)
        u_rng, i_rng = jax.random.split(key)
        swap = bool(jax.random.uniform(u_rng) > 0.5)
        slot = int(jax.random.randint(i_rng, (), 0, 2))
        buf, n, out = pool_update(buf, n, torch.from_numpy(img), torch.tensor(swap), torch.tensor(slot))
        torch.testing.assert_close(buf, torch.from_numpy(np.array(jbuf)), rtol=0, atol=0)
        torch.testing.assert_close(out, torch.from_numpy(np.array(jout)), rtol=0, atol=0)
        assert int(n) == int(jn)
        if k >= 2:
            swaps.add(swap)
    assert swaps == {True, False}  # the full phase met both outcomes


def test_device_pool_query_keeps_the_semantics():
    """With its own draws (a seeded ``torch.Generator``): the fill phase
    stores and passes through, the count saturates at the pool size, a swap
    returns a stored batch and stores the new one in its slot, a pass leaves
    the buffer alone."""
    gen = torch.Generator().manual_seed(0)
    buf, n = device_pool_init(2, (1, 2, 2, 3), torch.float32, "cpu")
    outcomes = set()
    for k in range(12):
        img = torch.full((1, 2, 2, 3), float(k))
        before = buf.clone()
        buf, n, out = device_pool_query(buf, n, img, gen)
        v = float(out[0, 0, 0, 0])
        if k < 2:
            assert v == k and int(n) == k + 1 and float(buf[k, 0, 0, 0, 0]) == k
            continue
        assert int(n) == 2
        if v == k:  # passed through: the buffer as it was
            outcomes.add("pass")
            assert torch.equal(buf, before)
        else:  # swapped: an old batch out, the new one in its slot
            outcomes.add("swap")
            slot = int(np.flatnonzero(before[:, 0, 0, 0, 0].numpy() == v)[0])
            assert float(buf[slot, 0, 0, 0, 0]) == k
    assert outcomes == {"pass", "swap"}


# --- the device loops against the port's own steps -----------------------------------

def test_device_loop_is_the_sequential_steps():
    """``make_device_loop`` with K = 3 over 2 staged batches and the indices
    1, 0, 1 is three ``make_train_step`` calls on those batches: the
    per-step metrics and the state after, bit for bit."""
    haze_all, gt_all = (torch.from_numpy(a) for a in _staged())
    idx = torch.tensor(IDX)
    (a, tx_g, tx_d), (b, _, _) = _state(), _state()
    step = make_train_step(tx_g, tx_d, LossWeights(perceptual=0.0))
    a, ms = make_device_loop(step, 3)(a, haze_all, gt_all, idx)
    seq = []
    for i in IDX:
        b, m = step(b, haze_all[i], gt_all[i])
        seq.append(m)
    assert set(ms) == set(seq[0]) and all(v.shape == (3,) for v in ms.values())
    for k, v in ms.items():
        torch.testing.assert_close(v, torch.stack([m[k] for m in seq]), rtol=0, atol=0)
    assert a.step == 3 and _same_state(a, b)


def test_device_pool_loop_is_the_sequential_steps():
    """``make_device_pool_loop`` with K = 3 and a pool of 2 is, with the same
    generator's draws, the G step, ``device_pool_query`` and the D step three
    times: the metrics, the pool, its count and the state, bit for bit."""
    haze_all, gt_all = (torch.from_numpy(a) for a in _staged())
    idx = torch.tensor(IDX)
    (a, tx_g, tx_d), (b, _, _) = _state(), _state()
    g_step, d_step = make_gd_steps(tx_g, tx_d, LossWeights(perceptual=0.0))
    pa, na = device_pool_init(2, haze_all.shape[1:], torch.float32, "cpu")
    pb, nb = device_pool_init(2, haze_all.shape[1:], torch.float32, "cpu")
    a, pa, na, ms = make_device_pool_loop(g_step, d_step, 3)(a, pa, na, haze_all, gt_all, idx,
                                                             torch.Generator().manual_seed(3))
    gen, seq = torch.Generator().manual_seed(3), []
    for i in IDX:
        b, gm, x_hat = g_step(b, haze_all[i], gt_all[i])
        pb, nb, fake = device_pool_query(pb, nb, x_hat.detach(), gen)
        b, dm = d_step(b, fake, gt_all[i])
        seq.append({**gm, **dm})
    for k, v in ms.items():
        torch.testing.assert_close(v, torch.stack([m[k] for m in seq]), rtol=0, atol=0)
    assert torch.equal(pa, pb) and int(na) == int(nb) == 2 and _same_state(a, b)


# --- against JAX ---------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_loop(trees):
    """JAX's ``make_device_loop`` over ``make_train_step`` (no perceptual
    term) from the trees, K = 3 over the staged batches and IDX."""
    jstate, jtx_g, jtx_d = jloop.create_train_state(jax.random.PRNGKey(0))
    jstate = jloop.TrainState(step=jstate.step, g_params=trees["gp"], d_params=trees["dp"],
                              g_opt=jtx_g.init(trees["gp"]), d_opt=jtx_d.init(trees["dp"]))
    run = jloop.make_device_loop(jloop.make_train_step(jtx_g, jtx_d, JLossWeights(perceptual=0.0)), 3)
    haze_all, gt_all = _staged()
    _, ms = run(jstate, jnp.asarray(haze_all), jnp.asarray(gt_all), jnp.asarray(IDX, jnp.int32),
                jnp.asarray(0, jnp.int32), jax.random.PRNGKey(3))
    return {k: np.asarray(v) for k, v in ms.items()}


def test_device_loop_matches_jax(jax_loop, trees):
    """The port's chunk against JAX's on the same trees, batches and index
    vector. The first step (one state, one batch, two implementations) at
    rtol 1e-5, JAX's gate for its loop. The later steps start from states
    that two implementations' Adam updates have moved apart: G's gradients
    differ by ~1e-3 relative at this size (tests/test_torch_train_spatial.py),
    and Adam moves a parameter by ±lr wherever |g| ≫ ε, so gradient noise
    around 0 flips some of those moves; measured 7.6e-6 after one update and
    1.7e-5 after two, held at 1e-4. The control shows the bound tells the
    carried state apart: the port's second step taken from the initial state
    instead misses JAX's second step by more than 1e-4."""
    haze_all, gt_all = (torch.from_numpy(a) for a in _staged())
    state, tx_g, tx_d = _state(trees)
    step = make_train_step(tx_g, tx_d, LossWeights(perceptual=0.0))
    _, ms = make_device_loop(step, 3)(state, haze_all, gt_all, torch.tensor(IDX))
    for k in ("g_total", "d_total"):
        got, want = ms[k].numpy(), jax_loop[k]
        np.testing.assert_allclose(got[0], want[0], rtol=1e-5, err_msg=k)
        np.testing.assert_allclose(got[1:], want[1:], rtol=1e-4, err_msg=k)
    fresh, tx_g, tx_d = _state(trees)
    _, m = make_train_step(tx_g, tx_d, LossWeights(perceptual=0.0))(fresh, haze_all[IDX[1]], gt_all[IDX[1]])
    assert abs(float(m["g_total"]) - jax_loop["g_total"][1]) > 1e-4 * abs(jax_loop["g_total"][1])


@pytest.fixture(scope="module")
def val_set():
    """2 val pairs of 1×32² in the val loader's (n, 1, H, W, 3) layout."""
    return _staged(n=2, seed=5)


@pytest.fixture(scope="module")
def jax_eval(trees, val_set):
    psnr, ssim = jloop.make_device_eval(*val_set)(trees["gp"])
    return float(psnr), float(ssim)


def test_device_eval_matches_jax_and_the_host_eval(jax_eval, trees, val_set):
    """``make_device_eval`` of the trees' G against JAX's ``make_device_eval``
    and against the host loop ``cli/train.py::evaluate`` over the same
    pairs: PSNR and SSIM at rtol 1e-4 (JAX's gate against its host loop)."""
    g, _, _ = _state(trees)
    got = make_device_eval(*val_set, device="cpu")(g.g)
    host = host_evaluate(g.g, list(zip(*val_set)), "cpu")
    np.testing.assert_allclose(got, jax_eval, rtol=1e-4)
    np.testing.assert_allclose(got, host, rtol=1e-4)
    assert all(isinstance(v, float) for v in got)


# --- AsyncCheckpointer -------------------------------------------------------------

def _tiny_state(seed=0):
    """A TrainState of two small modules with Adam state (one update each)."""
    gen = torch.Generator().manual_seed(seed)
    g, d = torch.nn.Linear(8, 4), torch.nn.Linear(4, 2)
    for p in list(g.parameters()) + list(d.parameters()):
        p.data = torch.randn(p.shape, generator=gen)
    state = TrainState(g=g, d=d, g_opt=torch.optim.Adam(g.parameters(), lr=0.1),
                       d_opt=torch.optim.Adam(d.parameters(), lr=0.1))
    _update(state)
    return state


def _update(state):
    """One in-place Adam update of both nets, as a train step makes."""
    for net, opt in ((state.g, state.g_opt), (state.d, state.d_opt)):
        opt.zero_grad()
        sum(p.square().sum() for p in net.parameters()).backward()
        opt.step()
    state.step += 1
    state.d_updates += 1


def _blob(state):
    """What the file should hold: copies of the state now."""
    return {"g": {k: v.clone() for k, v in state.g.state_dict().items()},
            "d": {k: v.clone() for k, v in state.d.state_dict().items()},
            "g_opt": {i: {k: v.clone() for k, v in e.items()} for i, e in state.g_opt.state_dict()["state"].items()},
            "step": state.step}


def _file_is(path, want) -> bool:
    got = torch.load(path, weights_only=True)
    return (got["step"] == want["step"]
            and all(torch.equal(got[net][k], v) for net in ("g", "d") for k, v in want[net].items())
            and all(torch.equal(got["g_opt"]["state"][i][k], v) for i, e in want["g_opt"].items()
                    for k, v in e.items()))


def _gated(monkeypatch, gate):
    """The writer's save_checkpoint waits for ``gate`` first."""
    real = checkpoint.save_checkpoint

    def slow_save(path, state, step=None):
        assert gate.wait(30)
        return real(path, state, step)

    monkeypatch.setattr(checkpoint, "save_checkpoint", slow_save)


def test_async_checkpoint_is_the_state_at_save(tmp_path, monkeypatch):
    """The state is updated in place (Adam) after ``save()`` and before the
    writer reads anything: the file still holds the state at ``save()``,
    every parameter and Adam moment and the step."""
    state = _tiny_state()
    want = _blob(state)
    gate = threading.Event()
    _gated(monkeypatch, gate)
    saver = AsyncCheckpointer()
    saver.save(str(tmp_path), state, step=state.step)
    _update(state)  # the next chunk, while the writer waits
    assert not torch.equal(state.g.weight, want["g"]["weight"])
    gate.set()
    assert saver.wait() is True
    assert _file_is(str(tmp_path / f"ckpt_{want['step']}.pt"), want)


def test_async_checkpointer_serialises_saves_and_raises(tmp_path):
    """Saves back to back into one file do not interleave and the last one
    wins; a writer's failure is raised by the next ``wait()``."""
    saver = AsyncCheckpointer()
    path = str(tmp_path / "ckpt.pt")
    state = _tiny_state()
    for _ in range(3):
        want = _blob(state)
        saver.save(path, state)
        _update(state)
    assert saver.wait() is True
    assert _file_is(path, want)
    saver.save(str(tmp_path / "no_such_dir" / "x" / "ckpt.pt"), state)
    with pytest.raises((OSError, RuntimeError)):
        saver.wait()
    assert saver.wait() is True  # raised once


def test_async_wait_timeout_keeps_the_writer_handle(tmp_path, monkeypatch):
    """A ``wait()`` that times out returns False and keeps the writer's
    handle (a second writer could otherwise race it to ``os.replace``);
    once the writer is through, ``wait()`` returns True and drops it."""
    gate = threading.Event()
    _gated(monkeypatch, gate)
    saver = AsyncCheckpointer()
    state = _tiny_state()
    want = _blob(state)
    path = str(tmp_path / "ckpt.pt")
    saver.save(path, state)
    assert saver.wait(timeout=0.2) is False
    assert saver._thread is not None and saver._thread.is_alive()
    gate.set()
    assert saver.wait() is True and saver._thread is None
    assert _file_is(path, want)


def test_async_checkpoint_loads_into_a_train_state(tmp_path):
    """The async file (its tensors views of one flat storage per dtype)
    restores a train state through ``load_checkpoint`` with the values of a
    blocking save of the same state."""
    state, _, _ = _state()
    saver = AsyncCheckpointer()
    saver.save(str(tmp_path / "async"), state, step=0)
    checkpoint.save_checkpoint(str(tmp_path / "blocking"), state, step=0)
    assert saver.wait() is True
    a, b = (torch.load(tmp_path / d / "ckpt_0.pt", weights_only=True) for d in ("async", "blocking"))
    for net in ("g", "d"):
        assert a[net].keys() == b[net].keys() and all(torch.equal(a[net][k], v) for k, v in b[net].items())
    fresh, _, _ = create_train_state(1, device="cpu")
    checkpoint.load_checkpoint(str(tmp_path / "async" / "ckpt_0.pt"), fresh)
    assert _same_state(fresh, state)


def test_normalise_constants_serve_autograd_after_inference_mode():
    """K3's plain version keeps its two constants on the device after the
    first call (so that its backward copies nothing from the host); a first
    call under ``inference_mode`` must not make them inference tensors,
    which autograd could not save."""
    from fdgan_tpu_torch.ops import filters

    x = torch.rand(1, 16, 16, 3, dtype=torch.float64)  # a dtype no other test caches first
    with torch.inference_mode():
        filters.frequency_fuse(x)
    xr = x.clone().requires_grad_(True)
    filters.frequency_fuse(xr).sum().backward()
    assert torch.isfinite(xr.grad).all()

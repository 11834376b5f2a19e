"""A whole run, the harness's look for a chip skipped (on the CPU, at tiny
sizes), with the timed path broken underneath: ``correct`` comes out false
for each fault the cell can have, and a compared number reads at least five
times what a sound run of the same cell and seed reads, so that the fault,
not the tiny size, is what fails it. (The limits are set at the cells' own
sizes on the card; a sound training run at 2×32² on the CPU reads above
some of them.) One chip only: no cell has an exchange between chips to
leave out."""

import pytest
import torch

import bench_util
from harness import runner

_SOUND = {}


@pytest.fixture(scope="module", autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _specs(cell):
    specs = bench_util.tiny_specs()
    if cell == "dcpdn.bulk.512":  # two images a batch, so that half of it can be left out
        tiny = specs.traffic
        specs.traffic = lambda name: {**tiny(name), "batch": 2, "distinct_images": 6, "check_images": 16}
    return specs


# windows long enough for a few answers of the CPU's plain path
SECONDS = {"fdgan.bulk.620x460": 1.5, "fdgan.serve.poisson": 1.5, "dcpdn.bulk.512": 8.0, "fdgan.train.8x256": 0.5}


def _run(cell):
    return runner.run_cell(_specs(cell), cell, 2**31 + 7, SECONDS[cell], False, "cpu")


def sound(cell):
    """The cell's run with nothing broken (once a cell); call it before
    anything is patched."""
    if cell not in _SOUND:
        _SOUND[cell] = _run(cell)["checks"]
    return _SOUND[cell]


def assert_broken(cell, number=None):
    """The broken run is not correct, and a compared number (``number``
    where given) reads at least five times the sound run's."""
    base, out = sound(cell), _run(cell)
    assert all(c["value"] != "inf" for c in base.values()), base
    assert out["correct"] is False, out["checks"]
    ratios = {k: float(c["value"]) / max(float(base[k]["value"]), 1e-12) for k, c in out["checks"].items()}
    assert max(ratios.values() if number is None else [ratios[number]]) >= 5.0, (out["checks"], base)


def _half_batch(fn):
    """fn over the first half of the batch, that half's results standing in
    for the rest."""
    def broken(model, x, *a, **k):
        half = max(1, x.shape[0] // 2)
        y = fn(model, x[:half], *a, **k)
        y = y[0] if isinstance(y, tuple) else y
        return torch.cat([y] * (x.shape[0] // half + 1))[:x.shape[0]]
    return broken


def _altered(fn):
    """fn with the first answer of every batch turned into its negative."""
    def broken(model, x, *a, **k):
        y = fn(model, x, *a, **k)
        y = y[0] if isinstance(y, tuple) else y
        return torch.cat([-y[:1], y[1:]])
    return broken


@pytest.mark.parametrize("cell", ["fdgan.bulk.620x460", "fdgan.serve.poisson"])
@pytest.mark.parametrize("fault", ["half_batch", "altered"])
def test_engine_cells(monkeypatch, cell, fault):
    from fdgan_tpu_torch.models import fdgan_fast

    sound(cell)
    monkeypatch.setattr(fdgan_fast, "apply", (_half_batch if fault == "half_batch" else _altered)(fdgan_fast.apply))
    assert_broken(cell)


def test_serving_answers_routed_to_the_wrong_request(monkeypatch):
    from fdgan_tpu_torch.serve import InferenceEngine

    sound("fdgan.serve.poisson")
    stream = InferenceEngine.stream

    def shifted(self, images, *a, **k):
        prev = None
        for y in stream(self, images, *a, **k):
            yield y if prev is None else prev
            prev = y

    monkeypatch.setattr(InferenceEngine, "stream", shifted)
    assert_broken("fdgan.serve.poisson")


@pytest.mark.parametrize("fault", ["half_batch", "altered"])
def test_dcpdn_cell(monkeypatch, fault):
    from fdgan_tpu_torch.models.dcpdn import DehazePhysical

    sound("dcpdn.bulk.512")
    fwd = DehazePhysical.forward
    broken = (_half_batch if fault == "half_batch" else _altered)(fwd)
    monkeypatch.setattr(DehazePhysical, "forward", lambda self, x, *a, **k: (broken(self, x, *a, **k),))
    assert_broken("dcpdn.bulk.512")


@pytest.mark.parametrize("fault", ["unchanged", "half_batch", "d_unchanged", "stats_unfolded"])
def test_training_cell(monkeypatch, fault):
    from fdgan_tpu_torch.train import loop

    sound("fdgan.train.8x256")
    number = None
    if fault == "unchanged":  # the step returns its state as it found it
        monkeypatch.setattr(loop.Transform, "apply", lambda self, opt, count: None)
        monkeypatch.setattr(loop, "fold_stats", lambda *a, **k: None)
    elif fault == "d_unchanged":  # G's update and fold as they are; D's Adam leaves D as it was
        create = loop.create_train_state

        class Unchanged(loop.Transform):
            def apply(self, opt, count):
                pass

        def frozen_d(*a, **k):
            state, tx_g, tx_d = create(*a, **k)
            return state, tx_g, Unchanged(tx_d.lr, tx_d.clip_grad, tx_d.scheduled)

        monkeypatch.setattr(loop, "create_train_state", frozen_d)
        number = "change_gap.d.median"
    elif fault == "stats_unfolded":  # both Adam updates as they are; G's running statistics never folded
        monkeypatch.setattr(loop, "fold_stats", lambda *a, **k: None)
        number = "stats_gap.g.median"
    else:
        make = loop.make_gd_steps

        def halved(*a, **k):
            g_step, d_step = make(*a, **k)
            return (lambda st, haze, gt: g_step(st, haze[: len(haze) // 2], gt[: len(gt) // 2]),
                    lambda st, fake, gt: d_step(st, fake, gt[: len(fake)]))

        monkeypatch.setattr(loop, "make_gd_steps", halved)
    assert_broken("fdgan.train.8x256", number)

"""The port's data-parallel pieces (fdgan_tpu_torch.dist.stats and .mesh) on
the CPU.

- The parallel-variance combination (``dist.stats.merge``) against the
  statistics of the concatenated batch, in fp32, float64 and bf16, over
  parts of unequal counts.
- ``dist.stats.combine`` over two gloo ranks (subprocesses: a process group
  is process-global, and pytest's workers must not hold one): the global
  statistics, the global count, and the gradient of a loss of them, which
  each rank's backward of its own copy of the loss, averaged over the ranks,
  must equal; one all-reduce forward and one backward.
- At world size 1 nothing changes: ``combine`` returns its inputs, and the
  data-parallel train step over a gloo group of one rank is bit for bit the
  step without a group, with no collective.
- ``maybe_init_distributed``'s outcomes, as
  ``tests/test_dist.py::test_maybe_init_distributed_logs_failure`` for JAX:
  nothing without the flag; the flag alone that fails warns and leaves the
  process single; explicit coordinates that fail stop it, naming them.
"""

import json
import os
import sys
import time
import warnings

import numpy as np
import pytest
import torch
import torch.distributed as dist

from fdgan_tpu_torch.dist import mesh
from fdgan_tpu_torch.dist import stats as dist_stats
from fdgan_tpu_torch.ops.stats import reference as plain_stats

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 120  # a rank that hangs in a collective fails the test


def _run_ranks(script, nprocs, tmp_path):
    """``script`` as each of ``nprocs`` gloo ranks (FDGAN_TPU_DIST and its
    coordinates in the environment); returns the JSON each printed last."""
    logs = mesh.run_local_ranks([sys.executable, "-c", script], nprocs, TIMEOUT, cwd=tmp_path,
                                env={"PYTHONPATH": ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""),
                                     "OMP_NUM_THREADS": "1"})
    return [json.loads(log.strip().splitlines()[-1]) for log in logs]


def _parts(dtype, seed=0):
    """NHWC parts of 1, 2 and 3 images of 5×7 with 6 channels: unequal counts."""
    rng = np.random.default_rng(seed)
    return [torch.tensor(rng.normal(0.3, 1.5, (b, 5, 7, 6)), dtype=dtype) for b in (1, 2, 3)]


@pytest.mark.parametrize("dtype, tol", [
    (torch.float32, dict(rtol=1e-5, atol=1e-6)),
    (torch.float64, dict(rtol=1e-12, atol=1e-12)),
    # the one-pass fp32 statistics of bf16 values, per part and of the whole: the same inputs, fp32 sums in
    # another order (tests/test_pallas_dense.py:67-68's statistics tolerances)
    (torch.bfloat16, dict(rtol=1e-4, atol=1e-4)),
])
def test_merge_matches_the_concatenated_batch(dtype, tol):
    """Each part's statistics as the port takes them (fp32 two-pass, bf16
    one-pass; float64 two-pass in float64), merged, against the same of the
    whole."""
    def stats(x):
        if x.dtype != torch.float64:
            return plain_stats(x)
        mean = x.mean(dim=(0, 1, 2))
        return mean, (x - mean).square().mean(dim=(0, 1, 2))

    parts = _parts(dtype)
    per_part = [stats(p) for p in parts]
    counts = torch.tensor([float(p.numel() // p.shape[-1]) for p in parts], dtype=torch.float64)
    mean, var, total = dist_stats.merge(counts, torch.stack([m.double() for m, _ in per_part]),
                                        torch.stack([v.double() for _, v in per_part]))
    want_mean, want_var = stats(torch.cat(parts))
    assert float(total) == sum(p.numel() // p.shape[-1] for p in parts) == 210
    torch.testing.assert_close(mean.to(want_mean.dtype), want_mean, **tol)
    torch.testing.assert_close(var.to(want_var.dtype), want_var, **tol)


def test_world_size_one_returns_inputs_unchanged():
    mean, var = torch.randn(4), torch.rand(4)
    dist_stats.reset_counts()
    for ctx in (dist_stats.global_batch_stats(None), torch.no_grad()):
        with ctx:
            got = dist_stats.combine(mean, var, 12)
        assert got[0] is mean and got[1] is var and got[2] == 12
    assert dist_stats.collectives == {"forward": 0, "backward": 0}
    assert mesh.shard_batch((torch.zeros(4, 2),))[0].shape == (4, 2)  # no group: the whole batch


COMBINE = """
import json, torch
from fdgan_tpu_torch.dist import mesh, stats
from fdgan_tpu_torch.ops.stats import two_pass_reference
mesh.maybe_init_distributed("cpu")
r = mesh.rank()
g = torch.Generator().manual_seed(0)
x = torch.randn(5, 3, 4, 6, generator=g, dtype=torch.float64).float()  # rows 0-1 rank 0, rows 2-4 rank 1
a, b = torch.randn(6, generator=g), torch.randn(6, generator=g)
mine = (x[:2] if r == 0 else x[2:]).clone().requires_grad_(True)
with stats.global_batch_stats(mesh.process_group()):
    m, v, n = stats.combine(*two_pass_reference(mine), mine.shape[0] * 12)
    ((m * a).sum() + (v * b).square().sum()).backward()
print(json.dumps({"rank": r, "mean": m.tolist(), "var": v.tolist(), "n": float(n),
                  "grad": (mine.grad / mesh.world_size()).tolist(), "collectives": stats.collectives}))
"""


def test_combine_over_two_ranks_is_the_global_batch(tmp_path):
    """Rank 0 holds 2 images, rank 1 3: the combined statistics and count
    are the whole batch's on both ranks, and each rank's gradient (its
    backward of the loss, averaged over the ranks) is the whole batch's
    gradient at its rows."""
    res = sorted(_run_ranks(COMBINE, 2, tmp_path), key=lambda r: r["rank"])
    g = torch.Generator().manual_seed(0)
    x = torch.randn(5, 3, 4, 6, generator=g, dtype=torch.float64).float().requires_grad_(True)
    a, b = torch.randn(6, generator=g), torch.randn(6, generator=g)
    m, v = plain_stats(x)
    ((m * a).sum() + (v * b).square().sum()).backward()
    for r in res:
        assert r["n"] == 60.0 and r["collectives"] == {"forward": 1, "backward": 1}
        torch.testing.assert_close(torch.tensor(r["mean"]), m.detach(), rtol=1e-6, atol=1e-6)
        torch.testing.assert_close(torch.tensor(r["var"]), v.detach(), rtol=1e-6, atol=1e-6)
    assert res[0]["mean"] == res[1]["mean"] and res[0]["var"] == res[1]["var"]  # the same bits on every rank
    grad = torch.tensor(res[0]["grad"] + res[1]["grad"])
    torch.testing.assert_close(grad, x.grad, rtol=1e-5, atol=1e-6)


WORLD_ONE = """
import json, torch
torch.set_num_threads(1)
import numpy as np
from fdgan_tpu_torch.dist import mesh, stats
from fdgan_tpu_torch.losses.composite import LossWeights
from fdgan_tpu_torch.train.loop import create_train_state, make_train_step
mesh.maybe_init_distributed("cpu")
assert mesh.world_size() == 1 and mesh.process_group() is not None
gt = np.random.default_rng(0).uniform(size=(1, 32, 32, 3)).astype(np.float32)
haze, gt = torch.from_numpy(np.clip(0.6 * gt + 0.3, 0, 1)), torch.from_numpy(gt)
out = {}
for name, group in (("dp", mesh.process_group()), ("single", None)):
    state, tx_g, tx_d = create_train_state(0, device="cpu")
    stats.reset_counts(); mesh.reset_counts()
    _, metrics = make_train_step(tx_g, tx_d, LossWeights(perceptual=0.0), group=group)(state, haze, gt)
    out[name] = (metrics, {**state.g.state_dict(), **{"d." + k: v for k, v in state.d.state_dict().items()}},
                 dict(stats.collectives) | dict(mesh.counts))
(m1, s1, c1), (m2, s2, c2) = out["dp"], out["single"]
same = all(torch.equal(m1[k], m2[k]) for k in m2) and s1.keys() == s2.keys()
same = same and all(torch.equal(s1[k], s2[k]) for k in s2)
print(json.dumps({"same": same, "collectives": c1, "metrics": sorted(m1)}))
"""


def test_world_size_one_step_is_the_single_process_step(tmp_path):
    """A gloo group of one rank: the data-parallel step equals the step
    without a group bit for bit (metrics, G's and D's parameters and running
    statistics) and issues no collective."""
    (res,) = _run_ranks(WORLD_ONE, 1, tmp_path)
    assert res["same"], res
    assert res["collectives"] == {"forward": 0, "backward": 0, "grads": 0, "metrics": 0}
    assert "g_total" in res["metrics"] and "d_total" in res["metrics"]


BROADCAST = """
import json, torch
torch.set_num_threads(1)
from fdgan_tpu_torch.dist import mesh
from fdgan_tpu_torch.train.loop import create_train_state
mesh.maybe_init_distributed("cpu")
r = mesh.rank()
state, _, _ = create_train_state(r, device="cpu")  # rank 1: other weights
ps = list(state.g.parameters())
p = ps[0] if r == 0 else ps[1]  # Adam state on another parameter on each rank
state.g_opt.state[p] = {"step": torch.tensor(5.0 + r), "exp_avg": torch.full_like(p, 1.0 + r),
                        "exp_avg_sq": torch.full_like(p, 2.0 + r)}
state.step, state.d_updates = 5 + r, 4 + r
mesh.broadcast_state(state)
sd = {**state.g.state_dict(), **{"d." + k: v for k, v in state.d.state_dict().items()}}
opt = {i: {k: float(v.double().sum()) for k, v in e.items()} for i, e in state.g_opt.state_dict()["state"].items()}
print(json.dumps({"rank": r, "sums": {k: float(v.double().sum()) for k, v in sd.items()}, "opt": opt,
                  "d_opt": len(state.d_opt.state), "counts": [state.step, state.d_updates]}))
"""


def test_broadcast_state_sends_rank_0s_state(tmp_path):
    """Rank 1 starts from other weights, other Adam state and other counts;
    after ``broadcast_state`` it holds rank 0's: the parameters and
    buffers, Adam's moments and steps where rank 0 has them (and none where
    it has none), and the counts."""
    r0, r1 = sorted(_run_ranks(BROADCAST, 2, tmp_path), key=lambda r: r["rank"])
    assert r0["sums"] == r1["sums"] and r0["counts"] == r1["counts"] == [5, 4]
    assert r0["opt"] == r1["opt"] and set(r1["opt"]) == {"0"} and r0["d_opt"] == r1["d_opt"] == 0
    assert r1["opt"]["0"]["step"] == 5.0


@pytest.fixture
def fake_init(monkeypatch):
    calls = []

    def init(backend, **kwargs):
        calls.append((backend, kwargs))
        raise RuntimeError("no rendezvous")

    for name in ("FDGAN_TPU_DIST", "FDGAN_TPU_DIST_COORD", "FDGAN_TPU_DIST_NPROCS", "FDGAN_TPU_DIST_PID"):
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setattr(dist, "init_process_group", init)
    return calls


def test_maybe_init_distributed_without_the_flag_does_nothing(fake_init):
    mesh.maybe_init_distributed("cpu")
    assert not fake_init and mesh.world_size() == 1 and mesh.rank() == 0 and mesh.process_group() is None


def test_maybe_init_distributed_flag_alone_warns_and_stays_single(fake_init, monkeypatch):
    """The flag alone is torchrun's ``env://`` (JAX's auto-detection): a
    failure warns and the process goes on single."""
    monkeypatch.setenv("FDGAN_TPU_DIST", "1")
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        mesh.maybe_init_distributed("cpu")
    assert fake_init == [("gloo", {"init_method": "env://"})]
    assert any(issubclass(x.category, RuntimeWarning) and "no rendezvous" in str(x.message) for x in w)
    assert mesh.world_size() == 1


def test_maybe_init_distributed_explicit_coordinates_that_fail_exit(fake_init, monkeypatch):
    """Explicit coordinates that fail stop the process, naming them: alone,
    it would take itself for rank 0 of 1. A CUDA device asks for NCCL."""
    monkeypatch.setenv("FDGAN_TPU_DIST", "1")
    monkeypatch.setenv("FDGAN_TPU_DIST_COORD", "host0:29500")
    monkeypatch.setenv("FDGAN_TPU_DIST_NPROCS", "2")
    monkeypatch.setenv("FDGAN_TPU_DIST_PID", "1")
    with pytest.raises(SystemExit, match=r"coord='host0:29500', nprocs=2, pid=1\) failed: RuntimeError: no rendezvous"):
        mesh.maybe_init_distributed("cuda")
    assert fake_init == [("nccl", {"init_method": "tcp://host0:29500", "world_size": 2, "rank": 1})]


def test_local_device_follows_local_rank(monkeypatch):
    monkeypatch.setenv("LOCAL_RANK", "3")
    assert mesh.local_device() == torch.device("cuda", 3)


def test_run_local_ranks_gives_each_rank_its_coordinates(tmp_path):
    """Each rank gets its own rank, the count and one shared localhost port;
    ``argv`` may be a function of the rank."""
    show = "import os; print(os.environ['FDGAN_TPU_DIST_PID'], os.environ['FDGAN_TPU_DIST_NPROCS'], " \
           "os.environ['FDGAN_TPU_DIST_COORD'])"
    logs = mesh.run_local_ranks(lambda pid: [sys.executable, "-c", f"print({pid}, end=' '); {show}"], 3, TIMEOUT)
    fields = [log.split() for log in logs]
    assert [f[:3] for f in fields] == [[str(i), str(i), "3"] for i in range(3)]
    assert len({f[3] for f in fields}) == 1 and fields[0][3].startswith("localhost:")


def test_run_local_ranks_fails_on_a_rank_that_fails_or_hangs(tmp_path):
    """A rank's exit code other than 0 raises with its output; a rank that
    outlives the timeout raises, and is killed."""
    with pytest.raises(RuntimeError, match=r"rank 1 of 2 exited 3:\nbroken"):
        mesh.run_local_ranks([sys.executable, "-c", "import os, sys; pid = int(os.environ['FDGAN_TPU_DIST_PID']); "
                              "print('broken' if pid else 'fine'); sys.exit(3 * pid)"], 2, TIMEOUT)
    marker = tmp_path / "survived"
    with pytest.raises(TimeoutError, match="still running after 1 s"):
        mesh.run_local_ranks([sys.executable, "-c", f"import time; time.sleep(2); open({str(marker)!r}, 'w')"], 2, 1)
    time.sleep(2)
    assert not marker.exists()

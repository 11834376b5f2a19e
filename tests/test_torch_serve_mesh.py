"""The port's serving mesh on the CPU: ``InferenceEngine(mesh=..., spatial=...)``
on gloo ranks, ``cli/serve --dataShards/--spatialShards``, and JAX's checks.

The ranks run ``fdgan_tpu_torch.tools.mesh_serve`` (one launch per world
size, module-scoped, each rank on one intra-op thread) with the full-width
generator (seed-0 weights, random running statistics) on 2 images of 48×64
(bucket 64: H 64 on the ranks), and on 2 of 128² for the seam gate. They are
held:

- against JAX's ``InferenceEngine(mesh=make_mesh(2, 2), spatial=True)`` (fp32
  running BN, tests/test_serve.py:247-265) at atol 1e-5, on 1×2, 2×1 and 2×2
  meshes;
- against the port's engine in one process (on one intra-op thread, as a
  rank): running BN at atol 1e-6 on every mesh (tests/test_serve.py:229-244
  holds JAX's data axis at atol 0; the CPU's convs pick their blocking by
  the batch size, and move the output by ~1e-8 between batch 1 and 2);
  fp32 batch BN at tests/test_dist.py:191-205's atol 2e-4 / rtol 1e-3;
- by tests/test_dist.py:208-249's seam gate at 2×128² on 1×4 ranks, fp32
  batch BN: elementwise, and the rows beside each seam no worse than 5× the
  interior's.

What each rank ran per forward is held too: halo exchanges (the 42 dense
layers' and the 7 convs' with a 3×3 kernel), statistics' all-reduces (87 in
batch BN: 45 segments and 42 of K2), and no kernel launch on the CPU.
"""

import os
import shutil
import socket
import sys
import types

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from fdgan_tpu.dist.mesh import make_mesh as jax_make_mesh
from fdgan_tpu.io.torch_import import FDGAN_TRANSPOSED, convert_state_dict
from fdgan_tpu.models import fdgan as jfdgan
from fdgan_tpu.serve import InferenceEngine as JaxEngine
from fdgan_tpu_torch.dist import mesh
from fdgan_tpu_torch.models.fdgan import FDGAN
from fdgan_tpu_torch.nn.layers import BatchNorm
from fdgan_tpu_torch.serve import InferenceEngine

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER_TIMEOUT = 300  # a rank that hangs in a collective fails the test
RANK_ENV = {"PYTHONPATH": ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""), "OMP_NUM_THREADS": "1"}
ENGINE = dict(precision="fp32", bucket=64, batch_sizes=[2])
TWO = {"1x2_running": [1, 2], "2x1_running": [2, 1], "1x2_batch": [1, 2], "2x1_batch": [2, 1]}
FOUR = {"2x2_running": [2, 2], "1x4_seam": [1, 4]}
SEAM_HW = 128  # tests/test_dist.py:208's 2@128², on 1×4 ranks
EXCHANGES = 42 + 7  # a forward's halo exchanges on a spatial rank: each dense layer's, and 7 convs with a 3×3 kernel
STATS_ALLREDUCES = 3 + 42 + 42  # batch BN: the blocks' inputs, each layer's new channels, each layer's K2


def _images(n, h, w, seed):
    rng = np.random.default_rng(seed)
    return [rng.uniform(size=(h, w, 3)).astype(np.float32) for _ in range(n)]


IMAGES = _images(2, 48, 64, 0)
SEAM_IMAGES = _images(2, SEAM_HW, SEAM_HW, 1)


@pytest.fixture(scope="module")
def weights():
    """The generator's seed-0 weights with random running statistics."""
    model = FDGAN(generator=torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, BatchNorm):
                m.running_mean.copy_(0.1 * torch.randn(m.running_mean.shape, generator=gen))
                m.running_var.copy_(1.0 + 0.1 * torch.rand(m.running_var.shape, generator=gen))
    return model.state_dict()


def _launch(weights, runs, world, tmp):
    blob = {"weights": weights, "runs": runs}
    torch.save(blob, tmp / "in.pt")
    mesh.run_local_ranks([sys.executable, "-m", "fdgan_tpu_torch.tools.mesh_serve", "--input", str(tmp / "in.pt"),
                          "--out", str(tmp), "--device", "cpu"], world, WORKER_TIMEOUT, env=RANK_ENV, cwd=ROOT)
    ranks = [torch.load(tmp / f"rank{r}.pt", weights_only=True) for r in range(world)]
    shutil.rmtree(tmp)
    return {run["name"]: [rk[i] for rk in ranks] for i, run in enumerate(runs)}


def _run(name, dims, images):
    bn = "batch" if "batch" in name or "seam" in name else "running"
    run = dict(ENGINE, name=name, mesh=dims, bn_mode=bn, images=torch.from_numpy(np.stack(images)))
    if name == "2x1_running":  # the engine's default ladder: (2, 4, 8, 16), 2 images on its first rung
        run["batch_sizes"] = None
    return run


@pytest.fixture(scope="module")
def ranks(weights, tmp_path_factory):
    """Each run's per-rank results: one launch of 2 ranks, one of 4."""
    two = _launch(weights, [_run(n, d, IMAGES) for n, d in TWO.items()], 2, tmp_path_factory.mktemp("mesh2"))
    four = _launch(weights, [_run("2x2_running", FOUR["2x2_running"], IMAGES),
                             _run("1x4_seam", FOUR["1x4_seam"], SEAM_IMAGES)], 4, tmp_path_factory.mktemp("mesh4"))
    return two | four


@pytest.fixture(scope="module")
def single(weights):
    """The port's engine in one process on the same images, on one intra-op
    thread as the ranks run (the CPU's convs choose their blocking by the
    thread count, which moves fp32 results by ~1e-6)."""
    out = {}
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        for bn in ("running", "batch"):
            eng = InferenceEngine(weights, device="cpu", precision="fp32", bn_mode=bn, bucket=64, batch_sizes=(2,))
            out[bn] = np.stack(eng.predict_batch(IMAGES))
        eng = InferenceEngine(weights, device="cpu", precision="fp32", bn_mode="batch", bucket=64, batch_sizes=(2,))
        out["seam"] = np.stack(eng.predict_batch(SEAM_IMAGES))
    finally:
        torch.set_num_threads(threads)
    return out


@pytest.fixture(scope="module")
def jax_mesh(weights):
    """JAX's engine on a 2×2 data × spatial mesh of the forced CPU devices (one compile)."""
    params = convert_state_dict({k: v.numpy() for k, v in weights.items()},
                                jax.eval_shape(jfdgan.init, jax.random.PRNGKey(0)), transposed=FDGAN_TRANSPOSED)
    eng = JaxEngine(params, precision="fp32", bn_mode="running", bucket=64, batch_sizes=(2,),
                    mesh=jax_make_mesh(n_data=2, n_spatial=2, devices=jax.devices()[:4]), spatial=True)
    return np.stack(eng.predict_batch(IMAGES))


def _outputs(ranks, name):
    return ranks[name][0]["outputs"].numpy()


@pytest.mark.parametrize("name", ["1x2_running", "2x1_running", "2x2_running"])
def test_mesh_engine_matches_jax_mesh_engine(ranks, jax_mesh, name):
    np.testing.assert_allclose(_outputs(ranks, name), jax_mesh, rtol=0, atol=1e-5)


@pytest.mark.parametrize("name", ["1x2_running", "2x1_running", "2x2_running"])
def test_mesh_engine_running_bn_matches_one_process(ranks, single, name):
    np.testing.assert_allclose(_outputs(ranks, name), single["running"], rtol=0, atol=1e-6)


@pytest.mark.parametrize("name", ["1x2_batch", "2x1_batch"])
def test_mesh_engine_batch_bn_matches_one_process(ranks, single, name):
    """Batch BN couples the batch and the rows: every statistic global over the mesh."""
    np.testing.assert_allclose(_outputs(ranks, name), single["batch"], atol=2e-4, rtol=1e-3)


def test_seam_rows_match_one_process(ranks, single):
    got, ref = _outputs(ranks, "1x4_seam"), single["seam"]
    np.testing.assert_allclose(got, ref, atol=2e-4, rtol=1e-3)
    shard_h = SEAM_HW // 4
    err = np.abs(got - ref)
    seams = sorted({r for b in range(1, 4) for r in (b * shard_h - 1, b * shard_h)})
    interior = [r for r in range(SEAM_HW) if r not in seams]
    seam_max, interior_max = float(err[:, seams].max()), float(err[:, interior].max())
    assert seam_max <= max(5.0 * interior_max, 1e-5), (seam_max, interior_max)


@pytest.mark.parametrize("name", list(TWO) + list(FOUR))
def test_each_rank_ran_its_forward(ranks, name):
    """One forward a rank (its block), with the exchanges and statistics'
    all-reduces of its place in the mesh, and no kernel launch on the CPU."""
    n_data, n_spatial = (TWO | FOUR)[name]
    batch = "batch" in name or "seam" in name
    for rk in ranks[name]:
        assert rk["mesh"] == [n_data, n_spatial]
        (fwd,) = rk["forwards"]
        assert fwd["exchanges"] == (EXCHANGES if n_spatial > 1 else 0)
        assert fwd["host_staged"] == 0
        assert fwd["stats_allreduces"] == (STATS_ALLREDUCES if batch else 0)
        assert fwd["k1"] == fwd["k2"] == fwd["channel_stats"] == 0
    assert sorted(tuple(rk["coordinate"]) for rk in ranks[name]) == [(d, s) for d in range(n_data)
                                                                     for s in range(n_spatial)]


def _stub_mesh(n_data, n_spatial):
    """What the engine's checks read of a mesh, for the checks that raise
    before any collective."""
    return types.SimpleNamespace(mesh_dim_names=("data", "spatial"), mesh=torch.empty(n_data, n_spatial))


def test_engine_refuses_a_bucket_that_the_spatial_axis_does_not_divide(weights):
    with pytest.raises(ValueError, match="bucket 8 must be divisible"):
        InferenceEngine(weights, device="cpu", bucket=8, batch_sizes=(1,), mesh=_stub_mesh(1, 3), spatial=True)


def test_engine_refuses_a_ladder_that_the_data_axis_does_not_divide(weights):
    with pytest.raises(ValueError, match="divisible by the mesh data-axis size 2"):
        InferenceEngine(weights, device="cpu", bucket=64, batch_sizes=(1, 2), mesh=_stub_mesh(2, 1))


def test_engine_scales_the_default_ladder_by_the_data_axis(ranks):
    """(1, 2, 4, 8) × n_data, as JAX's (tests/test_serve.py:238): the 2×1 run
    leaves the ladder to the engine."""
    assert all(rk["batch_sizes"] == [2, 4, 8, 16] for rk in ranks["2x1_running"])
    assert all(rk["batch_sizes"] == [2] for rk in ranks["1x2_running"])


def test_make_mesh_refuses_a_mesh_that_is_not_the_world():
    with pytest.raises(ValueError, match="does not cover 1 processes"):
        mesh.make_mesh(n_data=2, n_spatial=2)
    with pytest.raises(ValueError):
        mesh.make_mesh(n_data=3, n_spatial=2)


def test_spatial_rows_split_whole_blocks_of_eight():
    assert mesh.spatial_rows(64, 2) == [(0, 32), (32, 64)]
    assert mesh.spatial_rows(48, 4) == [(0, 16), (16, 32), (32, 40), (40, 48)]  # H/8 = 6: uneven, never padded
    with pytest.raises(ValueError, match="fewer than the 2 spatial shards"):
        mesh.spatial_rows(8, 2)
    with pytest.raises(ValueError, match="not a multiple of 8"):
        mesh.spatial_rows(60, 2)


# --- cli/serve on 2 ranks -------------------------------------------------------

CLI_SIZES = [(40, 56), (64, 64), (48, 32)]


@pytest.fixture(scope="module")
def cli(tmp_path_factory):
    """cli/serve's PNGs on 2 ranks (--dataShards 2, --spatialShards 2, and
    one HTTP request) and in one process, from the same inputs."""
    from fdgan_tpu_torch.cli import serve

    tmp = tmp_path_factory.mktemp("cli")
    in_dir = tmp / "in"
    in_dir.mkdir()
    rng = np.random.default_rng(3)
    for i, (h, w) in enumerate(CLI_SIZES):
        Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)).save(in_dir / f"{i}.png")
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    logs = mesh.run_local_ranks([sys.executable, os.path.join(ROOT, "tests", "torch_serve_cli_worker.py"),
                                 str(in_dir), str(tmp), str(port)], 2, WORKER_TIMEOUT, env=RANK_ENV)
    serve.main(["--inDir", str(in_dir), "--outDir", str(tmp / "one"), "--device", "cpu", "--precision", "fp32",
                "--maxBatch", "2"])

    def pngs(d):
        return {p: np.asarray(Image.open(d / p)).astype(int) for p in sorted(os.listdir(d))}

    out = {side: pngs(tmp / side) for side in ("one", "data", "spatial")}
    out["http"] = np.asarray(Image.open(tmp / "http.png")).astype(int)
    out["http_status"] = (tmp / "http.status").read_text()
    out["logs"] = logs
    shutil.rmtree(tmp)
    return out


@pytest.mark.parametrize("side", ["data", "spatial"])
def test_cli_serve_on_two_ranks_writes_the_one_process_pngs(cli, side):
    assert sorted(cli[side]) == sorted(cli["one"]) == [f"{i}.png" for i in range(len(CLI_SIZES))]
    for name, img in cli[side].items():
        assert img.shape == cli["one"][name].shape
        assert np.abs(img - cli["one"][name]).max() <= 1, name


def test_cli_serve_http_on_two_ranks_answers_a_request(cli):
    assert cli["http_status"] == "200"
    assert np.abs(cli["http"] - cli["one"]["0.png"]).max() <= 1
    assert "serving on http://" in cli["logs"][0]


def test_cli_serve_stops_without_the_ranks_it_needs(tmp_path):
    from fdgan_tpu_torch.cli import serve

    with pytest.raises(SystemExit, match="needs 2 ranks, one process each"):
        serve.main(["--inDir", str(tmp_path), "--device", "cpu", "--spatialShards", "2"])

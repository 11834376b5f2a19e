"""The port's training CLI (fdgan_tpu_torch.cli.train) and its modules on the
CPU: checkpoints, the DCGAN init, the VGG16 import and the val evaluation.

The CLI runs ``main(["--device", "cpu", ...])`` on a tiny h5 set (4 pairs
of 32², batch 2) twice per module: a first run of one epoch and a resumed
one. It is held against the port's own train step, which
``tests/test_torch_train.py`` holds against JAX's; JAX's CLI is not run (one
JAX ``cli.train`` at 32² takes ~100 s here). Where the JAX reference is
cheap it is the reference: ``dcgan_init`` over ``jax.eval_shape`` trees,
``convert_vgg16`` with ``perceptual_loss``, and the CLI's eval formula
through a jitted ``fdgan_fast.apply``, each computed once.
"""

import contextlib
import io
import json
import os
import shutil
import sys

import h5py
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fdgan_tpu.cli import train as jtrain
from fdgan_tpu.io.torch_import import FDGAN_TRANSPOSED, convert_state_dict, convert_vgg16
from fdgan_tpu.io.torch_import import load_torch_state_dict as jload_torch_state_dict
from fdgan_tpu.losses.perceptual import perceptual_loss as jperceptual_loss
from fdgan_tpu.models import fdgan as jfdgan
from fdgan_tpu.models import fdgan_fast as jfast
from fdgan_tpu.models.discriminators import nlayer_init
from fdgan_tpu.nn import init as jinit
from fdgan_tpu.ops import metrics as jmetrics
from fdgan_tpu.ops.ssim import ssim as jssim
from fdgan_tpu_torch.cli import train as cli
from fdgan_tpu_torch.cli._common import load_discriminator, load_generator
from fdgan_tpu_torch.data import get_loader
from fdgan_tpu_torch.dist import mesh
from fdgan_tpu_torch.io.checkpoint import latest_checkpoint, load_checkpoint, save_checkpoint
from fdgan_tpu_torch.io.torch_import import _TORCHVISION_VGG16_CONVS, load_vgg16, state_dict_from_jax
from fdgan_tpu_torch.losses.composite import LossWeights
from fdgan_tpu_torch.losses.perceptual import perceptual_loss
from fdgan_tpu_torch.models.discriminators import NLayerDiscriminator
from fdgan_tpu_torch.models.fdgan import FDGAN
from fdgan_tpu_torch.models.vgg16 import _CFG, VGG16
from fdgan_tpu_torch.nn.init import DENSENET_PRETRAINED_KEYS, dcgan_init
from fdgan_tpu_torch.train.loop import create_train_state, make_train_step

SIZE, BATCH = 32, 2
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
METRICS = ["g_adv", "g_pixel", "g_ssim", "g_total", "d_total", "d_real", "d_fake"]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for this module. The port's CPU steps at 32² gain
    nothing from more, and beside the suite's other workers their thread
    barriers cost far more than the work: a step that takes ~1 s alone took
    100-200 s in the parallel tier-1 run with torch's default threads."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _write_h5(root, n, seed):
    """n pairs: gt uniform, haze = clip(0.6·gt + 0.3), as the train tests."""
    os.makedirs(root)
    rng = np.random.default_rng(seed)
    for i in range(n):
        gt = rng.uniform(size=(SIZE, SIZE, 3)).astype(np.float32)
        with h5py.File(os.path.join(root, f"{i}.h5"), "w") as f:
            f.create_dataset("gt", data=gt)
            f.create_dataset("haze", data=np.clip(0.6 * gt + 0.3, 0, 1).astype(np.float32))
    return root


def _log(exp):
    with open(os.path.join(exp, "train_log.jsonl")) as f:
        return [json.loads(line) for line in f]


def _args(ds, val, exp, *extra):
    return ["--dataroot", ds, "--valDataroot", val, "--exp", exp, "--imageSize", str(SIZE), "--batchSize",
            str(BATCH), "--epochs", "1", "--logEvery", "1", "--evalIter", "1", "--keepBest", "--device", "cpu",
            *extra]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """One epoch of the CLI (2 steps, an eval after each, keepBest), then a
    resumed epoch into the same exp dir with the best's bar set above reach."""
    tmp = tmp_path_factory.mktemp("train_cli")
    ds, val = _write_h5(str(tmp / "ds"), 4, 0), _write_h5(str(tmp / "val"), 2, 1)
    exp = str(tmp / "exp")
    first = cli.main(_args(ds, val, exp))
    log_first = _log(exp)
    best_bytes = open(os.path.join(exp, "netG_best.pth"), "rb").read()
    with open(os.path.join(exp, "netG_best.pth.json")) as f:
        best_json = json.load(f)
    # a bar no continuation reaches: the resumed run must leave the best alone
    with open(os.path.join(exp, "netG_best.pth.json"), "w") as f:
        json.dump({"psnr": 1e3, "step": best_json["step"]}, f)
    second = cli.main(_args(ds, val, exp))
    return dict(tmp=tmp, ds=ds, val=val, exp=exp, first=first, second=second, log_first=log_first,
                log=_log(exp), best_bytes=best_bytes, best_json=best_json)


# --- the parser --------------------------------------------------------------

def test_parser_defaults_match_jax():
    """Every JAX flag exists in the port with the JAX default. ``--impl``
    names other choices (kernels/plain for xla/pallas: the port's step
    always runs fdgan_fast), and ``--device`` is the port's own."""
    port, ref = vars(cli.build_parser().parse_args([])), vars(jtrain.build_parser().parse_args([]))
    assert set(ref) <= set(port) and set(port) - set(ref) == {"device"}
    shared = set(ref) - {"impl"}
    assert {k: port[k] for k in shared} == {k: ref[k] for k in shared}
    assert (port["impl"], port["device"]) == ("kernels", "cuda")


# --- the loop ---------------------------------------------------------------

def test_first_logged_step_equals_the_port_step(runs):
    """The CLI's first step (ImagePool path: the pool's first query returns
    the batch itself) is one make_train_step call on the same seed-0 state
    and the loader's first batch."""
    haze, gt = next(iter(get_loader("pix2pix", runs["ds"], 286, SIZE, batch_size=BATCH, workers=0, seed=0)))
    state, tx_g, tx_d = create_train_state(0, device="cpu")
    _, metrics = make_train_step(tx_g, tx_d, LossWeights(perceptual=0.0))(
        state, torch.from_numpy(haze), torch.from_numpy(gt))
    logged = next(r for r in runs["log_first"] if "g_total" in r)
    assert logged["step"] == 1 and logged["imgs_per_sec"] > 0
    for k in METRICS:
        np.testing.assert_allclose(logged[k], float(metrics[k]), rtol=1e-6, err_msg=k)


def test_the_run_logs_evals_and_checkpoints(runs):
    val = [r for r in runs["log_first"] if "val_psnr" in r]
    assert [r["step"] for r in val] == [0, 1, 2]  # the step-0 baseline, then every evalIter
    assert all(np.isfinite([r["val_psnr"], r["val_ssim"]]).all() for r in val)
    assert runs["first"].step == 2 and runs["first"].d_updates == 2
    assert sorted(os.listdir(runs["exp"])) == ["ckpt_2.pt", "ckpt_4.pt", "netG_best.pth", "netG_best.pth.json",
                                               "train_log.jsonl"]


def test_resume_continues_the_step_count(runs):
    assert runs["second"].step == 4 and runs["second"].d_updates == 4
    steps = [r["step"] for r in runs["log"] if "g_total" in r]
    assert steps == [1, 2, 3, 4]
    # the resumed run's step-0 eval is logged at the resumed step
    assert [r["step"] for r in runs["log"] if "val_psnr" in r][3:] == [2, 3, 4]
    assert latest_checkpoint(runs["exp"]).endswith("ckpt_4.pt")


def test_resume_prints_where_it_resumed(tmp_path, capsys):
    exp = str(tmp_path / "exp")
    os.makedirs(exp)
    state, _, _ = create_train_state(0, device="cpu")
    state.step, state.d_updates = 7, 5
    save_checkpoint(exp, state, step=7)
    opt = cli.build_parser().parse_args(["--exp", exp, "--epochs", "0", "--device", "cpu"])
    got = cli.train(opt, [], None, "cpu")
    assert f"resumed from {os.path.join(exp, 'ckpt_7.pt')} at step 7" in capsys.readouterr().out
    assert (got.step, got.d_updates) == (7, 5)


def test_keep_best_writes_the_best_and_a_worse_resume_keeps_it(runs):
    first_val = [r["val_psnr"] for r in runs["log_first"] if "val_psnr" in r]
    assert runs["best_json"]["psnr"] == pytest.approx(max(first_val))
    assert runs["best_json"]["step"] == [0, 1, 2][int(np.argmax(first_val))]
    path = os.path.join(runs["exp"], "netG_best.pth")
    assert open(path, "rb").read() == runs["best_bytes"]
    with open(path + ".json") as f:
        assert json.load(f)["psnr"] == 1e3
    g = load_generator(path, device="cpu")  # the reference names: cli/demo and cli/serve load it
    assert isinstance(g, FDGAN)


def test_best_snapshot_is_a_copy(tmp_path):
    """The best is the generator at its eval, not the live (updated) one."""
    ds, val = _write_h5(str(tmp_path / "ds"), 2, 0), _write_h5(str(tmp_path / "val"), 1, 1)
    exp = str(tmp_path / "exp")
    state = cli.main(_args(ds, val, exp, "--evalIter", "100"))  # only the step-0 eval
    best = torch.load(os.path.join(exp, "netG_best.pth"), weights_only=True)
    fresh = FDGAN(generator=torch.Generator().manual_seed(0)).state_dict()
    assert all(torch.equal(best[k], v) for k, v in fresh.items())
    assert not torch.equal(best["conv_refin1.weight"], state.g.state_dict()["conv_refin1.weight"])


@pytest.mark.parametrize("flags, dist, message", [
    # a single process has one card: the bands need a process each, and the message says how to start them
    (["--spatialShards", "2"], False, "launch N x n_data processes under FDGAN_TPU_DIST"),
    (["--accumSteps", "2"], False, "requires --poolSize 0"),
    # under FDGAN_TPU_DIST, before any rendezvous
    (["--spatialShards", "2", "--imageSize", "32"], True, "too thin for the discriminator's tail"),
    (["--deviceSteps", "2"], True, "is single-process for now; drop it under FDGAN_TPU_DIST"),  # the JAX CLI's words
])
def test_refused_flags_exit_with_their_messages(monkeypatch, flags, dist, message):
    if dist:
        monkeypatch.setenv("FDGAN_TPU_DIST", "1")
        monkeypatch.setattr(torch.distributed, "init_process_group", None)  # a rendezvous attempt would raise
    with pytest.raises(SystemExit, match=message):
        cli.main(flags + ["--device", "cpu"])


@pytest.mark.parametrize("flags, dist", [
    (["--deviceSteps", "4"], False),
    (["--noAsyncCkpt"], False),
    (["--spatialShards", "2", "--lambdaCX", "1"], True),
])
def test_once_refused_flags_pass_the_checks(monkeypatch, flags, dist):
    """Flags this CLI refused until their paths were ported pass its checks
    now (their runs: the --deviceSteps tests below, and cli/train
    --spatialShards 2 --lambdaCX 1 on 2 ranks in tests/test_torch_train_spatial.py)."""
    if dist:
        monkeypatch.setenv("FDGAN_TPU_DIST", "1")
    assert cli.refuse(cli.build_parser().parse_args(flags + ["--device", "cpu"])) is None


def test_lambda_cx_trains_and_its_first_step_is_the_port_step(runs, tmp_path):
    """``--lambdaCX 1`` (with ``--vggWeights``, a seed-0 VGG16 .pth) trains:
    the CLI's first logged step equals one ``make_train_step`` with the
    contextual and perceptual terms on the same state and batch (rtol 1e-6),
    and its contextual term is logged and finite."""
    vgg_path = str(tmp_path / "vgg16.pth")
    torch.save(VGG16(generator=torch.Generator().manual_seed(0)).state_dict(), vgg_path)
    exp = str(tmp_path / "exp")
    cli.main(["--dataroot", runs["ds"], "--exp", exp, "--imageSize", str(SIZE), "--batchSize", str(BATCH),
              "--epochs", "1", "--logEvery", "1", "--device", "cpu", "--lambdaCX", "1", "--vggWeights", vgg_path])
    haze, gt = next(iter(get_loader("pix2pix", runs["ds"], 286, SIZE, batch_size=BATCH, workers=0, seed=0)))
    state, tx_g, tx_d = create_train_state(0, device="cpu")
    weights = LossWeights(perceptual=cli.build_parser().parse_args([]).lambdaPerceptual, contextual=1.0)
    _, metrics = make_train_step(tx_g, tx_d, weights, load_vgg16(vgg_path, device="cpu"))(
        state, torch.from_numpy(haze), torch.from_numpy(gt))
    logged = next(r for r in _log(exp) if "g_total" in r)
    for k in METRICS + ["g_perceptual", "g_contextual"]:
        np.testing.assert_allclose(logged[k], float(metrics[k]), rtol=1e-6, err_msg=k)
    assert np.isfinite(logged["g_contextual"]) and logged["g_contextual"] > 0


# --- --deviceSteps -------------------------------------------------------------

K = 2  # --deviceSteps: the tiny set's 2 batches in one chunk


@pytest.fixture(scope="module")
def device_runs(runs):
    """``--deviceSteps 2`` on the tiny set for one epoch: with ``--poolSize
    0``, an eval every step and the default async checkpoints; with
    ``--poolSize 50`` and ``--noAsyncCkpt``. Each run's state, log, stdout
    and exp dir."""
    out = {}
    for pool, extra in ((0, ["--valDataroot", runs["val"], "--evalIter", "1"]), (50, ["--noAsyncCkpt"])):
        exp = str(runs["tmp"] / f"device_steps_pool{pool}")
        args = ["--dataroot", runs["ds"], "--exp", exp, "--imageSize", str(SIZE), "--batchSize", str(BATCH),
                "--epochs", "1", "--logEvery", "1", "--device", "cpu", "--deviceSteps", str(K),
                "--poolSize", str(pool)] + extra
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            state = cli.main(args)
        out[pool] = {"state": state, "log": _log(exp), "stdout": buf.getvalue(), "exp": exp}
    return out


def test_index_sequence_is_the_jax_formula():
    """The batch order of a --deviceSteps run is the JAX CLI's
    (cli/train.py:535-540), written out here from its lines."""
    for nb, epochs, k, seed in ((2, 1, 2, 0), (3, 2, 4, 7), (5, 1, 16, 1)):
        host_rng = np.random.default_rng(seed + 2)
        want = np.concatenate([host_rng.permutation(nb) for _ in range(epochs + k // nb + 1)]).astype(np.int32)
        got = cli.index_sequence(nb, epochs, k, seed)
        assert got.dtype == np.int64 and np.array_equal(got, want)
        assert len(got) >= -(-epochs * nb // k) * k  # every chunk's indices


@pytest.mark.parametrize("pool", [0, 50])
def test_device_steps_first_logged_step_is_the_port_step(runs, device_runs, pool):
    """The first step of the chunk is ``make_train_step`` (with the pool: the
    fill phase hands D the batch itself) on the seed-0 state and the staged
    batch the index sequence names first (the loader's one pass, in order),
    rtol 1e-6; both steps are logged."""
    batches = [b for b in get_loader("pix2pix", runs["ds"], 286, SIZE, batch_size=BATCH, workers=0, seed=0)
               if b[0].shape[0] == BATCH]
    haze, gt = batches[int(cli.index_sequence(len(batches), 1, K, 0)[0])]
    state, tx_g, tx_d = create_train_state(0, device="cpu")
    _, metrics = make_train_step(tx_g, tx_d, LossWeights(perceptual=0.0))(
        state, torch.from_numpy(haze), torch.from_numpy(gt))
    run = device_runs[pool]
    logged = [r for r in run["log"] if "g_total" in r]
    assert [r["step"] for r in logged] == [1, 2] and logged[0]["imgs_per_sec"] > 0
    for k in METRICS:
        np.testing.assert_allclose(logged[0][k], float(metrics[k]), rtol=1e-6, err_msg=k)
    assert f"staging 2 batches (0 MB) on device; {K} steps/dispatch" in run["stdout"]
    assert run["state"].step == run["state"].d_updates == K


def test_device_steps_checkpoints_and_evals(device_runs):
    """The epoch boundary's checkpoint is written from the background thread
    (and no second one at the end, as it holds the last step), or blocking
    with --noAsyncCkpt; either file is the final state bit for bit. The
    evals (on the device: the val set stacks) are the step-0 baseline and,
    as JAX's loop runs them, one after each chunk that crosses --evalIter,
    logged at the chunk's last step."""
    for pool, how in ((0, "snapshot queued"), (50, "(blocking)")):
        run = device_runs[pool]
        assert f"ckpt step {K}: " in run["stdout"] and how in run["stdout"]
        assert sorted(os.listdir(run["exp"])) == [f"ckpt_{K}.pt", "train_log.jsonl"]
        blob = torch.load(os.path.join(run["exp"], f"ckpt_{K}.pt"), weights_only=True)
        live = run["state"].g.state_dict()
        assert blob["step"] == K and all(torch.equal(live[k], v) for k, v in blob["g"].items())
    val = [r for r in device_runs[0]["log"] if "val_psnr" in r]
    assert [r["step"] for r in val] == [0, K] and all(np.isfinite(r["val_psnr"]) for r in val)


def test_no_card_and_no_cpu_flag_stops(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        cli.main(["--dataroot", "unused"])


def test_keep_best_needs_val(tmp_path):
    opt = cli.build_parser().parse_args(["--keepBest", "--exp", str(tmp_path), "--device", "cpu"])
    with pytest.raises(SystemExit, match="--keepBest needs --valDataroot"):
        cli.train(opt, [], None, "cpu")


# --- --netG, --netD and the checkpoints ---------------------------------------

def test_net_g_and_net_d_are_honoured(tmp_path):
    g = FDGAN(generator=torch.Generator().manual_seed(5))
    d = NLayerDiscriminator(input_nc=9, generator=torch.Generator().manual_seed(6))
    torch.save({f"module.{k}": v for k, v in g.state_dict().items()}, tmp_path / "g.pth")
    torch.save(d.state_dict(), tmp_path / "d.pth")
    opt = cli.build_parser().parse_args(["--netG", str(tmp_path / "g.pth"), "--netD", str(tmp_path / "d.pth"),
                                         "--exp", str(tmp_path / "exp"), "--epochs", "0", "--device", "cpu"])
    state = cli.train(opt, [], None, "cpu")
    for net, want in ((state.g, g), (state.d, d)):
        got = net.state_dict()
        assert all(torch.equal(got[k], v) for k, v in want.state_dict().items())


def test_msgpack_raises_naming_item_5(tmp_path):
    """Ported now, so a JAX params ``.msgpack`` no longer raises: G and D
    trees written by JAX ``save_checkpoint`` load through
    ``load_generator`` / ``load_discriminator`` and through ``--netG`` /
    ``--netD``, equal bit for bit to the trees."""
    from fdgan_tpu.io.checkpoint import save_checkpoint as jsave_checkpoint
    from zoo_params import random_params

    g_tree = random_params(lambda: jfdgan.init(jax.random.PRNGKey(0)), seed=3)
    d_tree = random_params(lambda: nlayer_init(jax.random.PRNGKey(1)), seed=4)
    g_path = jsave_checkpoint(str(tmp_path / "netG.msgpack"), g_tree)
    d_path = jsave_checkpoint(str(tmp_path / "netD.msgpack"), d_tree)
    want = {"g": state_dict_from_jax(g_tree), "d": state_dict_from_jax(d_tree)}
    opt = cli.build_parser().parse_args(["--netG", g_path, "--netD", d_path, "--exp", str(tmp_path / "exp"),
                                         "--epochs", "0", "--device", "cpu"])
    state = cli.train(opt, [], None, "cpu")
    for name, loaded in (("g", load_generator(g_path, device="cpu")), ("d", load_discriminator(d_path, device="cpu")),
                         ("g", state.g), ("d", state.d)):
        got = loaded.state_dict()
        assert got.keys() == want[name].keys() and all(torch.equal(got[k], v) for k, v in want[name].items())


def _all_tensors(state):
    out = {f"g.{k}": v for k, v in state.g.state_dict().items()}
    out.update({f"d.{k}": v for k, v in state.d.state_dict().items()})
    for name in ("g_opt", "d_opt"):
        for idx, entry in getattr(state, name).state_dict()["state"].items():
            out.update({f"{name}.{idx}.{k}": v for k, v in entry.items()})
    return out


def test_checkpoint_round_trip_is_exact(runs, tmp_path):
    src = runs["second"]
    path = save_checkpoint(str(tmp_path), src, step=src.step)
    assert path.endswith("ckpt_4.pt") and not os.path.exists(path + ".tmp")
    state, _, _ = create_train_state(1, device="cpu")
    load_checkpoint(path, state)
    want, got = _all_tensors(src), _all_tensors(state)
    assert len(got) == len(want) > 600 and (state.step, state.d_updates) == (4, 4)
    assert all(torch.equal(got[k], v) for k, v in want.items())
    # the generator of a train checkpoint loads as a netG
    g = load_generator(path, device="cpu").state_dict()
    assert all(torch.equal(g[k], v) for k, v in src.g.state_dict().items())


def _first_moment(opt_state):
    """The Adam state of the first parameter that has one (dead ones have none)."""
    return next(iter(opt_state["state"].values()))


@pytest.mark.parametrize("change, message", [
    (lambda b: b["g"].__setitem__("conv_refin1.weight", torch.zeros(64, 3, 3, 5)),
     r"g conv_refin1.weight has shape \(64, 3, 3, 5\)"),
    (lambda b: b["d"].__setitem__("model.3.weight", b["d"]["model.3.weight"].double()),
     "d model.3.weight has dtype torch.float64"),
    (lambda b: _first_moment(b["g_opt"]).__setitem__("exp_avg", _first_moment(b["g_opt"])["exp_avg"][:1]),
     r"g_opt state\[\d+\] exp_avg has shape"),
])
def test_mismatched_checkpoint_raises_naming_the_parameter(runs, tmp_path, change, message):
    blob = torch.load(latest_checkpoint(runs["exp"]), weights_only=True)
    change(blob)
    torch.save(blob, tmp_path / "bad.pt")
    before = runs["second"].g.state_dict()["conv_refin1.weight"].clone()
    with pytest.raises(ValueError, match=message):  # the checks come before any tensor is loaded
        load_checkpoint(str(tmp_path / "bad.pt"), runs["second"])
    assert torch.equal(runs["second"].g.state_dict()["conv_refin1.weight"], before)


def test_latest_checkpoint_picks_the_highest_step(tmp_path):
    assert latest_checkpoint(str(tmp_path)) is None
    for step in (2, 10, 9):
        (tmp_path / f"ckpt_{step}.pt").write_bytes(b"")
    (tmp_path / "ckpt_99.pt.tmp").write_bytes(b"")
    assert latest_checkpoint(str(tmp_path)) == str(tmp_path / "ckpt_10.pt")


def test_latest_checkpoint_takes_both_kinds_by_step(tmp_path):
    """The port's ckpt_{step}.pt and the JAX CLI's ckpt_{step}.msgpack (a
    whole TrainState) compete by step; params files and .tmp files do not."""
    for name in ("ckpt_2.pt", "ckpt_10.msgpack", "ckpt_9.pt", "netG_best.msgpack", "ckpt_99.msgpack.tmp"):
        (tmp_path / name).write_bytes(b"")
    assert latest_checkpoint(str(tmp_path)) == str(tmp_path / "ckpt_10.msgpack")
    (tmp_path / "ckpt_11.pt").write_bytes(b"")
    assert latest_checkpoint(str(tmp_path)) == str(tmp_path / "ckpt_11.pt")


def test_train_cli_multiprocess_smoke(tmp_path):
    """cli/train under FDGAN_TPU_DIST on the CPU (gloo), as
    tests/test_multiprocess.py:127-176 runs the JAX CLI: 2 processes, each
    on its own shard of 16 pairs of 32², 8 global (4 a process), one epoch;
    process 0 writes the log and the checkpoint, process 1 nothing."""
    data = _write_h5(str(tmp_path / "ds"), 16, 0)
    exps = [tmp_path / "exp0", tmp_path / "exp1"]
    logs = mesh.run_local_ranks(lambda pid: [
        sys.executable, "-m", "fdgan_tpu_torch.cli.train", "--dataroot", data, "--imageSize", str(SIZE),
        "--batchSize", "8", "--epochs", "1", "--poolSize", "0", "--exp", str(exps[pid]), "--logEvery", "1",
        "--ckptEvery", "1", "--lrD", "5e-5", "--lambdaAdv", "0.5", "--lambdaPerceptual", "0",
        "--workers", "0", "--device", "cpu"], 2, 300,
        env={"PYTHONPATH": ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""), "OMP_NUM_THREADS": "1"})
    for i, log in enumerate(logs):
        assert f"multi-process: 2 processes x 1 local devices = 2 global; this is process {i}" in log
    entries = [json.loads(line) for line in open(exps[0] / "train_log.jsonl")]
    steps = [e for e in entries if "g_total" in e]
    assert [e["step"] for e in steps] == [1, 2] and all(np.isfinite(e["g_total"]) for e in steps)
    assert sorted(os.listdir(exps[0])) == ["ckpt_2.pt", "train_log.jsonl"]
    assert not (exps[1] / "train_log.jsonl").exists() and not list(exps[1].glob("ckpt_*"))
    shutil.rmtree(exps[0])  # a train state of ~180 MB


# --- dcgan_init against JAX ---------------------------------------------------

@pytest.fixture(scope="module")
def dcgan():
    """The port's seed-0 G and D, their trees on jax.eval_shape's shapes, and
    JAX dcgan_init over them (G with the pretrained encoder skipped)."""
    g = FDGAN(generator=torch.Generator().manual_seed(0))
    d = NLayerDiscriminator(input_nc=9, generator=torch.Generator().manual_seed(1))
    key = jax.random.PRNGKey(0)
    trees = {"g": convert_state_dict({k: v.numpy() for k, v in g.state_dict().items()},
                                     jax.eval_shape(jfdgan.init, key), transposed=FDGAN_TRANSPOSED),
             "d": convert_state_dict({k: v.numpy() for k, v in d.state_dict().items()},
                                     jax.eval_shape(lambda k: nlayer_init(k, input_nc=9), key))}
    # jitted: the draws are JAX's bits either way, and one compile is cheaper than an eager one per shape
    init = jax.jit(jinit.dcgan_init, static_argnames="skip")
    want = {"g": init(key, trees["g"], skip=jinit.DENSENET_PRETRAINED_KEYS),
            "d": init(jax.random.fold_in(key, 1), trees["d"])}
    before = {"g": g.state_dict(), "d": d.state_dict()}
    before = {net: {k: v.clone() for k, v in sd.items()} for net, sd in before.items()}
    want = {net: state_dict_from_jax(jax.tree.map(np.asarray, t)) for net, t in want.items()}
    dcgan_init(g, 3, skip=DENSENET_PRETRAINED_KEYS)
    dcgan_init(d, 4)
    return dict(before=before, want=want, after={"g": g.state_dict(), "d": d.state_dict()})


def _changed(a, b):
    return {k for k, v in a.items() if not torch.equal(v, b[k])}


@pytest.mark.parametrize("net", ["g", "d"])
def test_dcgan_init_changes_what_jax_changes(dcgan, net):
    before = dcgan["before"][net]
    port, ref = _changed(before, dcgan["after"][net]), _changed(before, dcgan["want"][net])
    assert port == ref and port
    assert not any("running" in k for k in port)  # the running statistics are kept
    if net == "g":
        assert not any(k.split(".")[0] in DENSENET_PRETRAINED_KEYS for k in port)
    assert DENSENET_PRETRAINED_KEYS == jinit.DENSENET_PRETRAINED_KEYS


def test_dcgan_init_draws_the_dcgan_distributions(dcgan):
    after = {**{f"g.{k}": v for k, v in dcgan["after"]["g"].items()},
             **{f"d.{k}": v for k, v in dcgan["after"]["d"].items()}}
    changed = _changed({**{f"g.{k}": v for k, v in dcgan["before"]["g"].items()},
                        **{f"d.{k}": v for k, v in dcgan["before"]["d"].items()}}, after)
    bn = {k for k in changed if k.endswith(".weight") and after[k].dim() == 1}
    conv = torch.cat([after[k].flatten() for k in changed if k.endswith(".weight") and k not in bn])
    scale = torch.cat([after[k] for k in bn])
    for x, mu in ((conv, 0.0), (scale, 1.0)):
        n = x.numel()
        assert abs(float(x.mean()) - mu) < 5 * 0.02 / np.sqrt(n), (n, float(x.mean()))
        assert abs(float(x.std()) - 0.02) < 5 * 0.02 / np.sqrt(2 * n), (n, float(x.std()))
    assert all(not after[k].any() for k in changed if k.endswith(".bias"))


def test_dcgan_init_is_a_function_of_the_seed():
    def draw(seed):
        return dcgan_init(NLayerDiscriminator(input_nc=9), seed).state_dict()

    a, b, c = draw(7), draw(7), draw(8)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["model.0.weight"], c["model.0.weight"])


# --- the VGG16 import ---------------------------------------------------------

@pytest.fixture(scope="module")
def vgg_files(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("vgg")
    sd = VGG16(generator=torch.Generator().manual_seed(0)).state_dict()
    ref = str(tmp / "vgg16_reference.pth")
    torch.save(sd, ref)
    tv = {f"features.{i}.{p}": sd[f"{name}.{p}"] for i, (name, _, _) in zip(_TORCHVISION_VGG16_CONVS, _CFG)
          for p in ("weight", "bias")}
    tv["classifier.0.weight"] = torch.zeros(4, 8)
    torchvision = str(tmp / "vgg16_torchvision.pth")
    torch.save(tv, torchvision)
    return sd, ref, torchvision


def test_load_vgg16_reads_both_namings(vgg_files):
    sd, ref, torchvision = vgg_files
    for path in (ref, torchvision):
        got = load_vgg16(path, device="cpu").state_dict()
        assert got.keys() == sd.keys() and all(torch.equal(got[k], v) for k, v in sd.items())


def test_load_vgg16_perceptual_loss_matches_jax(vgg_files):
    _, ref, torchvision = vgg_files
    rng = np.random.default_rng(9)
    x, y = (rng.uniform(size=(1, SIZE, SIZE, 3)).astype(np.float32) for _ in range(2))
    want = float(jperceptual_loss(convert_vgg16(torchvision), jnp.asarray(x), jnp.asarray(y)))
    with torch.no_grad():
        got = float(perceptual_loss(load_vgg16(ref, device="cpu"), torch.from_numpy(x), torch.from_numpy(y)))
    np.testing.assert_allclose(got, want, rtol=1e-4)


# --- the val evaluation -------------------------------------------------------

def test_eval_matches_the_jax_cli_formula(runs):
    """The port's evaluate of the seed-0 generator (the CLI's step-0 eval)
    against JAX's evaluate (cli/train.py:362-375) on the same .pth."""
    pth = str(runs["tmp"] / "netG_seed0.pth")
    torch.save(FDGAN(generator=torch.Generator().manual_seed(0)).state_dict(), pth)
    params = convert_state_dict(jload_torch_state_dict(pth), jax.eval_shape(jfdgan.init, jax.random.PRNGKey(0)),
                                transposed=FDGAN_TRANSPOSED)
    fwd = jax.jit(lambda p, v: jfast.apply(p, v))
    val = get_loader("pix2pix", runs["val"], SIZE, SIZE, batch_size=1, workers=0, split="val", shuffle=False)
    psnrs, ssims = [], []
    for haze, gt in val:
        x_hat = fwd(params, jnp.asarray(haze))
        psnrs.append(jmetrics.psnr(np.clip(np.asarray((x_hat + 1.0) * 0.5), 0, 1), np.asarray(gt)))
        ssims.append(float(jssim(jnp.clip((x_hat + 1) * 0.5, 0, 1), jnp.asarray(gt))))
    want = (float(np.mean(psnrs)), float(np.mean(ssims)))
    got = cli.evaluate(load_generator(pth, device="cpu"), val, "cpu")
    np.testing.assert_allclose(got, want, atol=5e-5)
    step0 = next(r for r in runs["log_first"] if "val_psnr" in r)
    np.testing.assert_allclose((step0["val_psnr"], step0["val_ssim"]), got, rtol=1e-6)

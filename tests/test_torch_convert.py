"""The port's params files and converter (fdgan_tpu_torch.io.msgpack,
io.checkpoint.save_params/load_params, cli.convert) against flax and the
JAX package, on the CPU.

- the codec: the port's writer against ``flax.serialization``'s bytes,
  files crossing between the packages for every registry family;
- the leaf order: each family's JAX paths from the port's module against
  ``tree_flatten_with_path`` of ``jax.eval_shape(init)``;
- the converter: ``.pth`` → ``.msgpack`` → ``.pth`` through both CLIs on the
  same reference-named files (doubled blockUNet keys, IOHW transposed convs),
  bit for bit;
- the ``.pt2`` destination: the forward exported with the JAX CLI's six
  export flags (one export at 32², shared), and what it refuses;
- its errors.

Parameter trees are ``zoo_params`` over ``jax.eval_shape`` of the inits. The
JAX CLI builds its templates with the eager inits, which take tens of
seconds here for the full-width models: its registry is given
``jax.eval_shape`` templates of the same inits, since a conversion reads
only their structure and shapes.
"""

import jax
import jax.numpy as jnp
import msgpack as real_msgpack
import numpy as np
import pytest
import torch
from flax import serialization

from fdgan_tpu.cli import convert as jconvert
from fdgan_tpu.io import torch_import as jti
from fdgan_tpu.io.checkpoint import load_checkpoint as jload_checkpoint
from fdgan_tpu.io.checkpoint import save_checkpoint as jsave_checkpoint
from fdgan_tpu_torch.cli import convert
from fdgan_tpu_torch.cli._common import load_model
from fdgan_tpu_torch.io import msgpack
from fdgan_tpu_torch.io.checkpoint import load_params, save_params
from fdgan_tpu_torch.io.export import user_inputs as export_inputs
from fdgan_tpu_torch.io.torch_import import jax_leaves, model_registry, state_dict_from_jax
from fdgan_tpu_torch.models import fdgan_fast
from zoo_params import random_params

KEY = jax.random.PRNGKey(0)
FAMILIES = sorted(jti.model_registry())


def _jax_tree(family, seed=0):
    factory = jti.model_registry()[family][0]
    return random_params(lambda: factory(KEY, jnp.float32), seed)


@pytest.fixture
def eval_shape_templates(monkeypatch):
    """The JAX registry with ``jax.eval_shape`` templates."""
    real = jti.model_registry()
    monkeypatch.setattr(jti, "model_registry", lambda: {
        k: (lambda r, d, f=f: jax.eval_shape(lambda: f(r, d)), t, dup) for k, (f, t, dup) in real.items()})


# --- the codec ----------------------------------------------------------------

def test_writer_bytes_equal_flax():
    """fp32, bf16 and int32 tensors, a numpy scalar and a 0-d tensor, and
    enough leaves (20) for a map16 header and string-sorted keys, against
    flax on the same values as numpy arrays."""
    rng = np.random.default_rng(0)
    leaves = [rng.standard_normal((3, 4, 2, 5)).astype(np.float32),
              np.asarray(jnp.asarray(rng.standard_normal((7, 3)), jnp.bfloat16)),
              np.arange(300, dtype=np.int32), np.float32(2.5), np.asarray(np.float32(-1.0))]
    leaves += [rng.standard_normal(i + 1).astype(np.float32) for i in range(15)]
    want = serialization.msgpack_serialize({str(i): leaf for i, leaf in enumerate(leaves)})
    as_torch = [torch.from_numpy(leaves[0]), torch.from_numpy(leaves[1].view(np.int16)).view(torch.bfloat16),
                torch.from_numpy(leaves[2]), leaves[3], torch.tensor(-1.0)] + [torch.from_numpy(a) for a in leaves[5:]]
    assert msgpack.pack_leaves(as_torch) == want
    back = msgpack.unpack_leaves(want)
    assert back[1].dtype == torch.bfloat16 and back[2].dtype == torch.int32 and back[3].shape == ()
    for got, leaf in zip(back, as_torch):
        assert torch.equal(got, torch.as_tensor(leaf))
    # the reader takes every msgpack format msgpack-python writes
    value = {"a": [-33, -200, -70000, 2**40, 1.5, None, True, False, "x" * 40, b"ab" * 200], "b": list(range(20))}
    assert msgpack.unpackb(real_msgpack.packb(value, use_bin_type=True)) == value


def test_chunked_leaf_raises_naming_it():
    array = real_msgpack.ExtType(1, msgpack._leaf_payload(torch.zeros(2)).data)
    data = real_msgpack.packb({"0": array, "1": {msgpack.CHUNKED: True, "shape": {"0": 4}, "chunks": {}}})
    with pytest.raises(ValueError, match=r"leaf 1 \(model.0.bias\) is a chunked array"):
        msgpack.unpack_leaves(data, ["model.0.kernel", "model.0.bias"])


@pytest.mark.parametrize("family", FAMILIES)
def test_files_cross_between_the_packages(family, tmp_path):
    """The port reads what JAX ``save_checkpoint`` wrote, equal to the tree;
    JAX ``load_checkpoint`` reads what the port wrote, leaf for leaf."""
    tree = _jax_tree(family)
    fam = model_registry()[family]
    jpath = jsave_checkpoint(str(tmp_path / "jax.msgpack"), tree)
    model = load_model(jpath, family, device="cpu")
    want = state_dict_from_jax(tree, fam.transposed)
    got = model.state_dict()
    assert got.keys() == want.keys() and all(torch.equal(got[k], v) for k, v in want.items())
    ppath = save_params(str(tmp_path / "port.msgpack"), model, fam.transposed)
    assert open(ppath, "rb").read() == open(jpath, "rb").read()
    back = jload_checkpoint(ppath, jax.eval_shape(lambda: tree))
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        np.testing.assert_array_equal(np.asarray(a), b)


# --- the leaf order -----------------------------------------------------------

@pytest.mark.parametrize("family", FAMILIES)
def test_leaf_order_is_jax_flatten_order(family):
    """The port's (JAX path) list for the family's module equals JAX's own
    flatten order of the init's tree; no weights are made. The transposed
    set is exactly the module's ConvTranspose2d paths."""
    factory = jti.model_registry()[family][0]
    shapes = jax.eval_shape(lambda: factory(KEY, jnp.float32))
    want = [".".join(k.key for k in path) for path, _ in jax.tree_util.tree_flatten_with_path(shapes)[0]]
    fam = model_registry()[family]
    module = fam.build(device="meta")
    assert [p for p, _ in jax_leaves(module, fam.transposed)] == want
    tconvs = {n for n, m in module.named_modules() if isinstance(m, torch.nn.ConvTranspose2d)}
    assert tconvs == set(fam.transposed) == set(jti.model_registry()[family][1])


# --- the converter ------------------------------------------------------------

@pytest.mark.parametrize("family", ["fdgan", "unetg2", "patchd", "begand", "dense2"])
def test_convert_round_trip_matches_the_jax_cli(family, tmp_path, eval_shape_templates):
    """A reference-named ``.pth`` (DataParallel prefix, doubled blockUNet
    keys, IOHW ConvTranspose2d weights, written by the JAX exporter) through
    both CLIs: the ``.msgpack`` files are the same bytes, and the ``.pth``
    files have the same keys and the same tensors, bit for bit."""
    _, transposed, duplicated = jti.model_registry()[family]
    ref = jti.export_state_dict(_jax_tree(family, seed=1), prefix="module.", transposed=transposed,
                                duplicated=duplicated)
    src = str(tmp_path / "ref.pth")
    torch.save({k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in ref.items()}, src)
    outs = {}
    for side, main in (("jax", jconvert.main), ("port", convert.main)):
        mp, pth = str(tmp_path / f"{side}.msgpack"), str(tmp_path / f"{side}.pth")
        main(["--src", src, "--dst", mp, "--model", family])
        main(["--src", mp, "--dst", pth, "--model", family])
        outs[side] = (open(mp, "rb").read(), torch.load(pth, weights_only=True))
    assert outs["port"][0] == outs["jax"][0]
    got, want = outs["port"][1], outs["jax"][1]
    assert got.keys() == want.keys() == ref.keys()
    assert all(torch.equal(got[k], want[k]) for k in want)
    if family in ("unetg2", "patchd"):
        assert {"module.dlayer8.dlayer8.tconv.weight", "module.main.layer2.layer2.conv.weight"} & got.keys()
    if family == "unetg2":  # dlayer8 is 64 → 64: only the set tells IOHW from OIHW
        np.testing.assert_array_equal(got["module.dlayer8.dlayer8.tconv.weight"].numpy(),
                                      ref["module.dlayer8.dlayer8.tconv.weight"])


def test_convert_vgg16_reads_torchvision_names(tmp_path, eval_shape_templates):
    """``--model vgg16`` with torchvision's ``features.N`` keys (and a
    classifier, dropped): the same params file as the JAX CLI's."""
    from fdgan_tpu_torch.io.torch_import import _TORCHVISION_VGG16_CONVS
    from fdgan_tpu_torch.models.vgg16 import _CFG, VGG16

    state = VGG16(generator=torch.Generator().manual_seed(3)).state_dict()
    tv = {f"features.{i}.{leaf}": state[f"{cfg[0]}.{leaf}"]
          for i, cfg in zip(_TORCHVISION_VGG16_CONVS, _CFG) for leaf in ("weight", "bias")}
    tv["classifier.0.weight"] = torch.zeros(4, 4)
    src = str(tmp_path / "vgg16_tv.pth")
    torch.save(tv, src)
    jconvert.main(["--src", src, "--dst", str(tmp_path / "j.msgpack"), "--model", "vgg16"])
    convert.main(["--src", src, "--dst", str(tmp_path / "p.msgpack"), "--model", "vgg16"])
    assert open(tmp_path / "p.msgpack", "rb").read() == open(tmp_path / "j.msgpack", "rb").read()


def test_export_prefix(tmp_path):
    path = save_params(str(tmp_path / "d.msgpack"), model_registry()["begand"].build(), frozenset())
    convert.main(["--src", path, "--dst", str(tmp_path / "d.pth"), "--model", "begand", "--prefix", ""])
    assert "conv1.0.weight" in torch.load(tmp_path / "d.pth", weights_only=True)


# --- errors -------------------------------------------------------------------

def test_shlo_destination_raises_naming_pt2():
    with pytest.raises(SystemExit, match=r"--dst <name>\.pt2"):
        convert.main(["--src", "netG.msgpack", "--dst", "netG.shlo"])


@pytest.fixture(scope="module")
def pt2_export(tmp_path_factory):
    """One .pt2 export through the CLI, every export flag away from its
    default, shared by the flags' cases: a seed-0 generator's .msgpack to
    a 32² program."""
    d = tmp_path_factory.mktemp("pt2")
    model = model_registry()["fdgan"].build()
    src = save_params(str(d / "netG.msgpack"), model, model_registry()["fdgan"].transposed)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        convert.main(["--src", src, "--dst", str(d / "netG_32.pt2"), "--imageSize", "32", "--batch", "poly",
                      "--precision", "fp32", "--bnMode", "running", "--ioDtype", "uint8", "--platforms", "cpu"])
        from fdgan_tpu_torch.io.export import ArtifactRunner

        runner = ArtifactRunner(str(d / "netG_32.pt2"))
        x = np.random.default_rng(0).integers(0, 256, (3, 32, 32, 3), dtype=np.uint8)
        got = np.stack(runner(list(x)))
        with torch.inference_mode():
            y = fdgan_fast.apply(load_model(src, "fdgan", device="cpu"), torch.from_numpy(x).float() / 255.0,
                                 bn_mode="running")
    finally:
        torch.set_num_threads(threads)
    want = torch.clamp(torch.round((y + 1.0) * 127.5), 0, 255).numpy()
    return runner, got, want, str(d / "netG_32.pt2")


@pytest.mark.parametrize("flag", ["--imageSize", "--batch", "--precision", "--bnMode", "--ioDtype", "--platforms"])
def test_pt2_export_takes_the_jax_clis_flags(pt2_export, flag):
    """Each of the JAX CLI's export flags reaches the program: its size, a
    symbolic batch (3 images in one call), fp32 weights and the fp32
    forward's values, running BN (no K2 in the graph), the uint8 contract,
    the device it was traced for."""
    runner, got, want, _ = pt2_export
    inp = export_inputs(runner.exported)[0]
    if flag == "--imageSize":
        assert (runner.height, runner.width) == (32, 32)
    elif flag == "--batch":
        assert runner.batch is None and got.shape == (3, 32, 32, 3)
    elif flag == "--precision":
        assert {v.dtype for v in runner.exported.state_dict.values() if v.is_floating_point()} == {torch.float32}
        assert np.abs(got.astype(np.int16) - want).max() <= 1
    elif flag == "--bnMode":
        targets = {str(n.target) for n in runner.exported.graph.nodes if n.op == "call_function"}
        assert "fdgan.dense_layer.default" in targets and "fdgan.h_stats.default" not in targets
    elif flag == "--ioDtype":
        assert inp.dtype == torch.uint8 and got.dtype == np.uint8
    else:
        assert inp.device.type == "cpu"


def test_serve_artifact_dehazes_a_folder(pt2_export, tmp_path):
    """cli/serve --artifact: a folder of ragged PNGs through the exported
    program (ArtifactRunner), each written at its own size as the program's
    output normalised (the reference's PNG protocol); --http refused."""
    from PIL import Image

    from fdgan_tpu_torch.cli import serve
    from fdgan_tpu_torch.utils.images import normalize_to_uint8

    runner, _, _, path = pt2_export
    rng = np.random.default_rng(3)
    images = {"a.png": rng.integers(0, 256, (32, 24, 3), dtype=np.uint8),
              "b.png": rng.integers(0, 256, (20, 32, 3), dtype=np.uint8)}
    (tmp_path / "in").mkdir()
    for name, img in images.items():
        Image.fromarray(img).save(tmp_path / "in" / name)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        serve.main(["--inDir", str(tmp_path / "in"), "--outDir", str(tmp_path / "out"), "--artifact", path])
        want = runner(list(images.values()))
    finally:
        torch.set_num_threads(threads)
    for (name, img), y in zip(images.items(), want):
        got = np.asarray(Image.open(tmp_path / "out" / name))
        assert got.shape == img.shape
        np.testing.assert_array_equal(got, normalize_to_uint8(y.astype(np.float32)))
    with pytest.raises(SystemExit, match="--http serves the live engine"):
        serve.main(["--http", "8731", "--artifact", path])


@pytest.mark.parametrize("platforms", ["tpu", "cuda,cpu"])
def test_pt2_export_refuses_other_platforms(platforms):
    """A torch program is traced for one device: a list, or the TPU, stops."""
    with pytest.raises(SystemExit, match="one device"):
        convert.main(["--src", "netG.msgpack", "--dst", "netG.pt2", "--platforms", platforms])


def test_wrong_family_raises_naming_the_leaf(tmp_path):
    path = save_params(str(tmp_path / "d.msgpack"), model_registry()["nlayer"].build(), frozenset())
    with pytest.raises(ValueError, match=r"leaf main\.layer1\.conv\.kernel has shape"):
        load_model(path, "patchd", device="cpu")
    with pytest.raises(ValueError, match="leaf model.0.bias has dtype"):
        load_params(path, model_registry()["nlayer"].build(dtype=torch.bfloat16), frozenset())
    with pytest.raises(SystemExit, match="exactly one"):
        convert.main(["--src", path, "--dst", str(tmp_path / "e.msgpack"), "--model", "nlayer"])

"""The last tools of ``scripts/`` in the port, and its image reader.

* ``io/images.py::read_image`` against ``imageio.v2.imread`` bit for bit on
  every format the port reads (RGB JPEG and PNG, RGBA PNG, grayscale JPEG
  and PNG, palette PNG with and without tRNS, a base64 PNG as labelme
  stores masks), and the train dataset read with ``imageio`` made
  unimportable;
* ``apps/make_atscale_dataset.py`` against tpugs' ``scripts/
  make_atscale_dataset.py`` at a toy size (150 Gaussians, 4 cameras,
  64x48, 40 SfM points): the COLMAP files byte-equal, ``ckpt.pt`` equal,
  the frames within one unit, each JPEG byte-equal to ``imageio``'s
  encoding of the port's frame, and the colour order kept;
* ``experiments/gather_locality.py`` on the CPU (the kernels' twins) at a
  toy size: the Morton lift equal to the default lift in scene order, and
  every measurement returned;
* ``apps/convert_weights.py`` on the encoder tests' small lang-seg, DINOv2
  and CLIP-text state dicts, the towers built at those widths through
  their constructors' arguments: the converted parameter counts against
  tpugs' converters, the self-check outputs and statistics against
  tpugs' forwards, and an unknown key raising.
"""

import base64
import dataclasses
import filecmp
import functools
import importlib.util
import io
import json
import os
import sys

import imageio.v2 as imageio
import numpy as np
import pytest
import torch
from PIL import Image

from tests.test_convert_validation import make_dino_state_dict, make_lseg_state_dict
from tests.test_torch_encoders import (
    PORT_TINY_DINO,
    PORT_TINY_LSEG,
    _tpugs_lseg_encoder,
    _within,
)
from tpugs_torch.apps import convert_weights
from tpugs_torch.apps.make_atscale_dataset import main as atscale_main
from tpugs_torch.apps.make_atscale_dataset import write_jpeg
from tpugs_torch.encoders import clip_text
from tpugs_torch.experiments import gather_locality
from tpugs_torch.io.images import read_image
from tpugs_torch.train.dataset import Dataset, Parser

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = "cpu"
TOY = dict(n_gaussians=150, n_cams=4, width=64, height=48, n_sfm_points=40)


def _script(name):
    spec = importlib.util.spec_from_file_location(name, os.path.join(REPO, "scripts",
                                                                     f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ------------------------------------------------------------ the reader

_RNG = np.random.default_rng(0)
_RGB = _RNG.integers(0, 256, (48, 64, 3), dtype=np.uint8)
_RGBA = _RNG.integers(0, 256, (48, 64, 4), dtype=np.uint8)
_GRAY = _RNG.integers(0, 256, (48, 64), dtype=np.uint8)


IMAGES = {
    "rgb.jpg": lambda p: imageio.imwrite(p, _RGB),
    "gray.jpg": lambda p: imageio.imwrite(p, _GRAY),
    "rgb.png": lambda p: imageio.imwrite(p, _RGB),
    "rgba.png": lambda p: imageio.imwrite(p, _RGBA),
    "gray.png": lambda p: imageio.imwrite(p, _GRAY),
    "gray-alpha.png": lambda p: Image.fromarray(np.stack([_GRAY, _RGB[..., 0]], -1),
                                                "LA").save(p),
    "bilevel.png": lambda p: Image.fromarray(_GRAY > 127).save(p),
    "palette.png": lambda p: Image.fromarray(_RGB).quantize(colors=16).save(p),
    "palette-trns.png": lambda p: Image.fromarray(_RGB).quantize(colors=16).save(
        p, transparency=3),
}


@pytest.mark.parametrize("name", sorted(IMAGES))
def test_read_image_equals_imageio(name, tmp_path):
    path = str(tmp_path / name)
    IMAGES[name](path)
    ref = imageio.imread(path)
    for got in (read_image(path), read_image(open(path, "rb").read())):
        assert got.dtype == ref.dtype and got.shape == ref.shape
        np.testing.assert_array_equal(got, ref)


def test_read_image_of_a_labelme_mask_equals_imageio():
    buf = io.BytesIO()
    imageio.imwrite(buf, ((_GRAY > 100) * 255).astype(np.uint8), format="png")
    b64 = base64.b64encode(buf.getvalue()).decode()
    ref = imageio.imread(io.BytesIO(base64.b64decode(b64)))
    got = read_image(base64.b64decode(b64))
    assert got.dtype == ref.dtype and np.array_equal(got, ref)
    from tpugs_torch.query.affordance import decode_labelme_mask

    assert np.array_equal(decode_labelme_mask(b64), _GRAY > 100)


def test_read_image_without_cv2_raises(tmp_path, monkeypatch):
    path = str(tmp_path / "x.png")
    imageio.imwrite(path, _RGB)
    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(ImportError, match="cv2"):
        read_image(path)


# ------------------------------------------------ the at-scale dataset


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    """The port's dataset and tpugs' at the toy size (tpugs' run once)."""
    root = tmp_path_factory.mktemp("atscale")
    port = atscale_main(str(root / "port"), device=CPU, **TOY)
    _script("make_atscale_dataset").main(str(root / "ref"), **TOY)
    return root, port


def test_atscale_dataset_writes_tpugs_colmap_model_and_checkpoint(built):
    root, port = built
    for f in ("cameras.bin", "images.bin", "points3D.bin"):
        assert filecmp.cmp(root / "port/sparse/0" / f, root / "ref/sparse/0" / f,
                           shallow=False), f
    ours, ref = (torch.load(root / d / "ckpt.pt")["splats"] for d in ("port", "ref"))
    assert ours.keys() == ref.keys()
    assert all(torch.equal(ours[k], ref[k]) for k in ref)
    assert set(port["seconds"]) == {"scene", "colmap", "render", "jpeg", "ckpt"}


def test_atscale_jpegs_are_imageios_encoding_of_its_frames(built):
    root, port = built
    frames = port["frames"]
    assert len(frames) == TOY["n_cams"]
    for i, frame in enumerate(frames):
        assert frame.dtype == np.uint8 and frame.shape == (48, 64, 3)
        buf = io.BytesIO()
        imageio.imwrite(buf, frame, format="jpg")
        assert (root / "port/images" / f"frame_{i:04d}.jpg").read_bytes() == buf.getvalue()


def test_atscale_frames_within_one_unit_of_tpugs(built):
    from tpugs.utils.synthetic import orbit_cameras as j_orbit, random_scene as j_scene
    from tpugs.viz.gif import render_to_gif as j_render

    _, port = built
    scene = j_scene(TOY["n_gaussians"], seed=0, extent=0.9, scale_range=(0.008, 0.05))
    cams = j_orbit(TOY["n_cams"], TOY["width"], TOY["height"], radius=2.5)
    ref = j_render(None, scene, cams, save_frames=False)
    for g, r in zip(port["frames"], ref):
        assert g.dtype == np.uint8 and g.shape == np.asarray(r).shape
        assert np.abs(g.astype(int) - np.asarray(r).astype(int)).max() <= 1


def test_jpeg_keeps_the_colour_order(tmp_path):
    frame = np.zeros((32, 48, 3), np.uint8)
    frame[..., 0] = 220  # red
    frame[:, 24:, 2] = 200  # and blue on the right half
    path = str(tmp_path / "c.jpg")
    write_jpeg(path, frame)
    back = read_image(path).astype(int)
    assert abs(back[:, :20, 0].mean() - 220) < 3 and back[:, :20, 2].mean() < 3
    assert abs(back[:, 28:, 2].mean() - 200) < 3


def test_dataset_reads_without_imageio(built, monkeypatch):
    root, _ = built
    parser = Parser(str(root / "port"), factor=1, test_every=2)
    trainset = Dataset(parser, "train")
    want = [imageio.imread(parser.image_paths[trainset.indices[i]])[..., :3].astype(
        np.float32) / 255.0 for i in range(2)]
    monkeypatch.setitem(sys.modules, "imageio", None)
    monkeypatch.setitem(sys.modules, "imageio.v2", None)
    with pytest.raises(ImportError):
        importlib.import_module("imageio.v2")
    for i in range(2):
        got = trainset[i]["image"]
        assert got.dtype == np.float32 and np.array_equal(got, want[i])


# ------------------------------------------------------- gather locality


@pytest.fixture
def one_thread():
    """The kernels' twins at a toy size run thousands of tiny ops; on one
    thread each costs microseconds, where a thread pool on a loaded host
    waits milliseconds for its workers at every op."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_gather_locality_on_the_cpu(one_thread):
    out = gather_locality.main(["--device", CPU, "--num-gaussians", "300", "--width", "64",
                                "--height", "48", "--feature-dim", "8"])
    assert set(out["pack"]) == {"uniform-random", "sorted", "plan-default", "plan-morton"}
    assert set(out["reduce"]) == {"uniform-random", "sorted", "csr-default", "csr-morton",
                                  "slots-default", "slots-morton"}
    for r in [*out["pack"].values(), *out["reduce"].values()]:
        assert set(r) == {"ms", "rows", "m_rows_s", "gb_s"} and r["ms"] > 0
    assert out["pack"]["plan-default"]["rows"] == out["T_padded"]
    assert out["reduce"]["csr-morton"]["rows"] == out["n_isects"]
    assert set(out["lift"]) == {f"{e}-{s}" for e in ("pallas", "scatter")
                                for s in ("default", "morton")}
    from tpugs_torch.lift.batch import STAGES

    for r in out["lift"].values():
        assert len(r["views"]) == gather_locality.VIEWS
        assert all(set(v) == set(STAGES) for v in r["views"])
    for e in out["morton_equal"].values():
        assert e["ok"] and e["bit_equal"] and e["differing"] == e["weights_beyond_unmoved"] == 0


def test_a_depth_tie_changes_the_lift_only_in_its_tiles(one_thread):
    """Two Gaussians of one mean tie in depth in every view: ``tie_effects``
    finds them moved and the tiles where their order shows, the order that
    swaps them changes the weight sums of the pair only and no sum outside
    those tiles, and a sum moved outside them fails the comparison."""
    from tpugs_torch.encoders.base import LinearRGBEncoder
    from tpugs_torch.lift.batch import backproject_views
    from tpugs_torch.utils.order import inverse_permutation, permute_scene
    from tpugs_torch.utils.synthetic import orbit_cameras, random_scene

    W, H = 128, 96  # 4 x 3 tiles
    s = random_scene(300, seed=0, extent=1.0, scale_range=(0.004, 0.02), device=CPU)
    pair = dict(means=torch.zeros(2, 3), log_scales=torch.full((2, 3), float(np.log(0.05))),
                logit_opacities=torch.full((2,), 2.2),
                sh0=torch.tensor([[[1.5, -0.5, -0.5]], [[-0.5, -0.5, 1.5]]]),
                shN=torch.zeros((2,) + s.shN.shape[1:]))
    s = dataclasses.replace(s, **{k: torch.cat([v, getattr(s, k)[2:]])
                                  for k, v in pair.items()})
    perm = np.arange(300)
    perm[:2] = [1, 0]
    cams = orbit_cameras(2, W, H, radius=3.0, device=CPU)
    enc = LinearRGBEncoder(8, device=CPU)
    ties = gather_locality.tie_effects(s, perm, cams, W, H, enc)
    assert ties["moved"][:2].all() and int(ties["moved"].sum()) == 2
    assert ties["changed"][:2].all() and 2 < int(ties["changed"].sum()) < 300
    assert ties["changed_tiles"] > 0
    assert ties["moves_without_tie"] == ties["rows_beyond_rounding"] == 0
    assert ties["unexplained_changes"] == 0

    def lift(scene):
        return backproject_views(scene, cams.viewmats, cams.Ks, W, H, enc,
                                 tile_size=gather_locality.TILE, device=CPU)

    (num_m, den_m), (num, den) = lift(permute_scene(s, perm)), lift(s)
    inv = torch.as_tensor(inverse_permutation(perm))
    e = gather_locality._morton_against_default(num_m, den_m, num, den, inv, ties)
    assert e["weights_beyond_rounding"] == 2 and e["weights_beyond_unmoved"] == 0
    assert e["differing"] > 2 and e["untouched_differing"] == 0
    assert e["untouched_beyond_rounding"] == 0 and not e["bit_equal"]
    # (``ok`` also asks the module's limits, set for the default scene and
    # not for this planted pair)
    # feature sums of two untouched Gaussians trade places
    rows = inv[torch.nonzero(~ties["changed"] & (den > 0))[:2, 0]]
    num_x = num_m.clone()
    num_x[rows] = num_m[rows.flip(0)]
    e = gather_locality._morton_against_default(num_x, den_m, num, den, inv, ties)
    assert e["untouched_beyond_rounding"] == 2 and not e["ok"]


def test_slot_index_is_the_xla_engines_gather():
    """The slot table's rows, summed per column and unpermuted, are the
    XLA reduce's sums."""
    from tpugs_torch.raster.plan import build_plan, slot_columns
    from tpugs_torch.raster.projection import project
    from tpugs_torch.raster.reduce import reduce_contribs_xla
    from tpugs_torch.utils.synthetic import orbit_cameras, random_scene

    s = random_scene(300, seed=0, extent=1.0, scale_range=(0.004, 0.02), device=CPU)
    cams = orbit_cameras(1, 64, 48, radius=3.0, device=CPU)
    proj = project(s.means, s.quats, s.scales, s.opacities, cams.viewmats[0], cams.Ks[0],
                   64, 48)
    plan = build_plan(proj, 64, 48, 32)
    idx = gather_locality.slot_index(plan).long()
    assert sorted(idx.tolist()) == sorted(plan.gauss_pos.tolist())
    slot_order, culled = slot_columns(plan)
    # cover row j lists the columns with more than j rows, in column order
    cols = torch.cat([torch.nonzero(culled > j)[:, 0] for j in range(int(culled[0]))])
    rows = torch.rand((plan.T_padded, 3), generator=torch.Generator().manual_seed(0))
    sums = torch.zeros((len(culled), 3)).index_add_(0, cols, rows[idx])
    want = torch.empty_like(sums)
    want[slot_order] = sums
    torch.testing.assert_close(want, reduce_contribs_xla(rows, plan, 3))


# ----------------------------------------------------- convert_weights

TEXT = dict(vocab_size=520, context_length=77, width=12, heads=4, layers=2, embed_dim=16)
DINO_PATCH = 56  # 896 / 56 = a 16 x 16 grid at the encoder's input size


def _lseg_file_sd():
    sd = make_lseg_state_dict(np.random.default_rng(3), vocab=TEXT["vocab_size"],
                              ctx=TEXT["context_length"])
    sd["pretrained.model.head.weight"] = torch.zeros(10, 16)  # timm's unused classifier
    return sd


def _dino_sd():
    return make_dino_state_dict(np.random.default_rng(7), patch=DINO_PATCH, grid=4)


@pytest.fixture
def small_towers(monkeypatch):
    """The tool's towers at the encoder tests' widths."""
    from tpugs_torch.encoders.lseg import LSegNet

    monkeypatch.setattr(convert_weights, "LSegNet", functools.partial(LSegNet,
                                                                      **PORT_TINY_LSEG))
    monkeypatch.setattr(convert_weights, "DINOV2_VIT_L14_REG", dataclasses.replace(
        PORT_TINY_DINO, patch_size=DINO_PATCH, image_size=4 * DINO_PATCH))
    monkeypatch.setattr(convert_weights, "CLIPTextTower",
                        functools.partial(clip_text.CLIPTextTower, **TEXT))


def _bpe(tmp_path):
    p = tmp_path / "bpe.txt"
    p.write_text("#version: 0.2\nt a\nta b\nl e</w>\nv a\n")
    return str(p)


def _count(params):
    return int(sum(np.asarray(v).size for v in _script("convert_weights")._flatten(
        params).values()))


@pytest.fixture(scope="module")
def tpugs_converted():
    """tpugs' converted params and forwards of the same files."""
    import jax

    from tpugs.encoders.clip_text import CLIPTextTower as JTower
    from tpugs.encoders.clip_text import SimpleTokenizer as JTok, tokenize as jtokenize
    from tpugs.encoders.convert import load_clip_text_params, load_dino_params, load_lseg_params
    from tpugs.encoders.vit import ViTConfig as JViTConfig, VisionTransformer as JViT
    import jax.numpy as jnp
    import tempfile

    lseg_sd, dino_sd = _lseg_file_sd(), _dino_sd()
    out = {"lseg_params": _count(load_lseg_params(lseg_sd)),
           "text_params": _count(load_clip_text_params(lseg_sd)),
           "dino_params": _count(load_dino_params(dino_sd))}
    probe = np.random.default_rng(0).uniform(0, 1, (480, 480, 3)).astype(np.float32)
    out["lseg"] = np.asarray(_tpugs_lseg_encoder(lseg_sd, 480)(jnp.asarray(probe)))
    cfg = dataclasses.replace(PORT_TINY_DINO, patch_size=DINO_PATCH,
                              image_size=4 * DINO_PATCH)
    jvit = JViT(JViTConfig(**dataclasses.asdict(cfg)), act="gelu")  # DinoEncoder's
    dprobe = np.random.default_rng(0).uniform(0, 1, (224, 224, 3)).astype(np.float32)
    x = jax.image.resize(jnp.asarray(dprobe)[None], (1, 896, 896, 3), "bilinear")
    o = jax.jit(jvit.apply)(load_dino_params(dino_sd), x)
    tok = np.asarray(o["final"][:, o["n_prefix"]:, :], np.float32).reshape(1, 16, 16, -1)
    out["dino"] = np.asarray(jax.image.resize(tok, (1, 224, 224, tok.shape[-1]),
                                              "nearest"))[0]
    with tempfile.TemporaryDirectory() as d:
        bpe = os.path.join(d, "bpe.txt")
        open(bpe, "w").write("#version: 0.2\nt a\nta b\nl e</w>\nv a\n")
        toks = jtokenize(JTok(bpe), convert_weights.TEXT_PROBE)
    out["text"] = np.asarray(JTower(**TEXT).apply(load_clip_text_params(lseg_sd), toks))
    return out


def _stats_close(stats, ref, frac=2e-5):
    want = _script("convert_weights")._stats(ref)
    assert stats["shape"] == want["shape"] and stats["finite"] and want["finite"]
    scale = max(1e-6, want["absmax"])
    for k in ("mean", "std", "absmax"):
        assert abs(stats[k] - want[k]) <= frac * scale, (k, stats[k], want[k])


def test_convert_weights_against_tpugs(small_towers, tpugs_converted, tmp_path):
    lseg, dino = tmp_path / "lseg.ckpt", tmp_path / "dino.pth"
    torch.save({"state_dict": _lseg_file_sd(), "epoch": 200}, lseg)
    torch.save(_dino_sd(), dino)
    out, empty = tmp_path / "out", tmp_path / "empty"
    empty.mkdir()
    path = list(sys.path)
    report, outputs = convert_weights.main([
        "--lseg-ckpt", str(lseg), "--dino-ckpt", str(dino), "--bpe-path", _bpe(tmp_path),
        "--reference-dir", str(empty), "--out-dir", str(out), "--device", CPU])
    assert sys.path == path
    ref = tpugs_converted
    assert json.loads((out / "convert_report.json").read_text()) == report
    assert set(report) == {"lseg", "clip_text", "dino"}
    for tower, key in (("lseg", "lseg_params"), ("clip_text", "text_params"),
                       ("dino", "dino_params")):
        assert report[tower]["converted"]["parameters"] == ref[key], tower
        sd = torch.load(out / f"{tower}_state_dict.pt")
        assert len(sd) == report[tower]["converted"]["tensors"]
    for tower, key in (("lseg", "lseg"), ("clip_text", "text"), ("dino", "dino")):
        _within(outputs[tower].numpy(), ref[key])
        _stats_close(report[tower]["self_check"], ref[key])
    assert outputs["lseg"].shape == (480, 480, 16) and outputs["dino"].shape == (224, 224, 16)
    assert report["lseg"]["parity_vs_torch"].startswith("torch LSeg implementation not")
    assert report["dino"]["parity_vs_torch"].startswith("torch DINOv2 not importable")


def test_convert_weights_without_bpe_skips_the_text_probe(small_towers, tmp_path):
    path = tmp_path / "lseg.ckpt"
    torch.save(_lseg_file_sd(), path)
    report, outputs = convert_weights.main(["--lseg-ckpt", str(path), "--out-dir",
                                            str(tmp_path / "o"), "--device", CPU])
    assert report["clip_text"]["self_check"] == "pass --bpe-path to run the tokenizer probe"
    assert outputs["clip_text"] is None and set(report) == {"lseg", "clip_text"}


UNKNOWN = {
    "lseg": ("--lseg-ckpt", lambda: {**_lseg_file_sd(), "scratch.extra.weight": torch.zeros(3)}),
    "clip_text": ("--clip-text-ckpt", lambda: {
        **_lseg_file_sd(), "clip_pretrained.transformer.resblocks.0.extra.weight":
        torch.zeros(4)}),
    "dino": ("--dino-ckpt", lambda: {**_dino_sd(), "blocks.0.attn.q_norm.weight":
                                     torch.zeros(16)}),
}


@pytest.mark.parametrize("tower", sorted(UNKNOWN))
def test_convert_weights_unknown_key_raises(tower, small_towers, tmp_path):
    flag, make = UNKNOWN[tower]
    path = tmp_path / "x.ckpt"
    torch.save(make(), path)
    with pytest.raises((KeyError, RuntimeError), match="extra|q_norm|Unexpected"):
        convert_weights.main([flag, str(path), "--out-dir", str(tmp_path / "o"),
                              "--device", CPU])


# a lang-seg checkout's ``lseg.LSegNet``, standing in for the public one:
# the lang-seg layout loaded into the port's module at the tool's widths
STUB_LSEG = """
import torch

from tpugs_torch.apps import convert_weights
from tpugs_torch.encoders.convert import load_lseg_state_dict
from tpugs_torch.encoders.lseg import LSegEncoder


class LSegNet(torch.nn.Module):
    def __init__(self, **kwargs):
        super().__init__()
        self.net = convert_weights.LSegNet(device="cpu")

    def load_state_dict(self, sd, strict=True):
        return self.net.load_state_dict(load_lseg_state_dict(sd), strict=strict)

    def forward(self, x):
        return LSegEncoder.from_net(self.net)(x[0].permute(1, 2, 0)).permute(2, 0, 1)[None]
"""


@pytest.mark.parametrize("body", ["stub", "broken"])
def test_convert_weights_parity_forward_of_a_reference_checkout(body, small_towers, tmp_path):
    """``--reference-dir`` with an importable ``lseg`` runs its forward
    beside the self-check; a checkout that fails other than by a missing
    module raises. ``sys.path`` is as it was either way."""
    ref = tmp_path / "ref"
    ref.mkdir()
    (ref / "lseg.py").write_text(STUB_LSEG if body == "stub" else
                                 "raise RuntimeError('a broken checkout')\n")
    ckpt = tmp_path / "lseg.ckpt"
    torch.save(_lseg_file_sd(), ckpt)
    argv = ["--lseg-ckpt", str(ckpt), "--reference-dir", str(ref), "--out-dir",
            str(tmp_path / "o"), "--device", CPU]
    path = list(sys.path)
    try:
        if body == "broken":
            with pytest.raises(RuntimeError, match="a broken checkout"):
                convert_weights.main(argv)
        else:
            report, _ = convert_weights.main(argv)
            assert report["lseg"]["parity_vs_torch"]["max_abs_err"] == 0.0
            assert report["lseg"]["parity_vs_torch"]["cosine"] == pytest.approx(1.0)
    finally:
        sys.modules.pop("lseg", None)
    assert sys.path == path

"""Rules of the port that need no card: it imports no JAX and nothing of
tpugs; its entry points default to CUDA and raise where there is none;
the kernel wrappers reject what their kernels do not take, and CPU tensors
run the plain twins without counting a launch; the kernel build is keyed
on the sources."""

import ast
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

from tpugs_torch.convert import (
    cameras_from_numpy,
    codec_from_numpy,
    linear_encoder_from_numpy,
    scene_from_numpy,
)
from tpugs_torch.core.device import resolve_device
from tpugs_torch.dist.dryrun import dryrun_multichip
from tpugs_torch.dist.mesh import init_ranks, make_mesh
from tpugs_torch.dist.shard import backproject_views_sharded, make_trainer_step_sharded
from tpugs_torch.apps.affordance import main as affordance_main
from tpugs_torch.apps.click_and_segment import PromptSession
from tpugs_torch.apps.click_and_segment import main as click_main
from tpugs_torch.apps.llm_backend import make_hf_backend
from tpugs_torch.apps.backproject import main as backproject_main
from tpugs_torch.apps.backproject_compressed import main as compressed_main
from tpugs_torch.apps.convert_weights import main as convert_weights_main
from tpugs_torch.apps.make_atscale_dataset import main as atscale_main
from tpugs_torch.apps.segment import main as segment_main
from tpugs_torch.apps.train import main as train_main
from tpugs_torch.apps.train_codec import main as train_codec_main
from tpugs_torch.apps.viewer import main as viewer_main
from tpugs_torch.apps.viewer import render_frame
from tpugs_torch.apps.viewer_llm import main as viewer_llm_main
from tpugs_torch.apps.visualize_pca import main as pca_main
from tpugs_torch.codec.linear import LinearCodec, load_codec, train_codec
from tpugs_torch.encoders import get_encoder
from tpugs_torch.encoders.base import LinearRGBEncoder
from tpugs_torch.encoders.clip_text import CLIPTextTower
from tpugs_torch.encoders.dino import DinoEncoder
from tpugs_torch.encoders.lseg import LSegEncoder, LSegHead, LSegNet, TextEncoder, encode_text
from tpugs_torch.encoders.vit import VisionTransformer, ViTConfig
from tpugs_torch.experiments import (
    gather_locality,
    profile_stages,
    scatter_write,
    sharded_singlechip,
)
from tpugs_torch.io.checkpoints import load_checkpoint
from tpugs_torch.kernels import build
from tpugs_torch.lift.backproject import create_feature_field
from tpugs_torch.lift.batch import (
    backproject_views,
    backproject_views_split,
    create_feature_field_batch,
    estimate_sizes,
)
from tpugs_torch.lift.ops import accumulate_view
from tpugs_torch.lift.prune import prune_by_gradients, verify_pruning_equivalence
from tpugs_torch.query.affordance import load_exemplars
from tpugs_torch.raster import kernels as K
from tpugs_torch.raster.colors import prepare_colors
from tpugs_torch.raster.pack import pack_isect_all
from tpugs_torch.raster.plan import build_plan, with_scatter_extras
from tpugs_torch.raster.projection import project
from tpugs_torch.raster.train import pack_train, train_forward, train_rows
from tpugs_torch.train.config import TrainConfig
from tpugs_torch.train.lpips import lpips_distance, random_lpips_params
from tpugs_torch.train.modules import AppearanceOptModule, CameraOptModule
from tpugs_torch.train.trainer import Trainer, init_scene_from_points
from tpugs_torch.utils import synthetic
from tpugs_torch.utils.profiling import StageTimer, device_memory_stats

REPO = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "tpugs")


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module


def test_port_imports_no_jax_and_no_tpugs():
    files = sorted((REPO / "tpugs_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 15
    bad = [
        (str(f.relative_to(REPO)), m)
        for f in files
        for m in _imported_modules(f)
        if m.split(".")[0] in FORBIDDEN
    ]
    assert not bad, f"forbidden imports: {bad}"


def test_port_imports_no_imageio_and_no_matplotlib():
    """The card's machine has neither: every image the port writes or
    reads goes through ``io/images.py`` (cv2 and the port's GIF encoder),
    every colormap through the port's own tables. Imports inside functions
    count too."""
    files = sorted((REPO / "tpugs_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    bad = [
        (str(f.relative_to(REPO)), m)
        for f in files
        for m in _imported_modules(f)
        if m.split(".")[0] in ("imageio", "matplotlib")
    ]
    assert not bad, f"imports the card's machine lacks: {bad}"


def _queue_a_items():
    """Item numbers of ``ROADMAP.md``'s queue A ("### A." up to the next
    "### " heading): the lines that open with "N. "."""
    import re

    text = (REPO / "ROADMAP.md").read_text()
    start = text.index("### A.")
    queue = text[start:text.index("\n### ", start + 1)]
    return {int(m) for m in re.findall(r"^(\d+)\. ", queue, flags=re.M)}


def test_roadmap_pointers_name_queue_a_items():
    """Every "ROADMAP item N" in the port's messages and docstrings names
    an item of queue A."""
    import re

    items = _queue_a_items()
    assert items == set(range(1, len(items) + 1)) and len(items) >= 5
    pointers = [
        (str(f.relative_to(REPO)), int(n))
        for f in sorted((REPO / "tpugs_torch").rglob("*.py"))
        for n in re.findall(r"ROADMAP(?: queue A)?\s+item\s+(\d+)", f.read_text())
    ]
    assert pointers, "the port points at queue A where it raises"
    assert all(n in items for _, n in pointers), [p for p in pointers if p[1] not in items]


def _no_cuda():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA; the entry points run there")


ENTRY_POINTS = {
    "random_scene": lambda: synthetic.random_scene(10),
    "orbit_cameras": lambda: synthetic.orbit_cameras(2, 32, 32),
    "LinearRGBEncoder": lambda: LinearRGBEncoder(4),
    "scene_from_numpy": lambda: scene_from_numpy(synthetic.random_scene_arrays(5)),
    "cameras_from_numpy": lambda: cameras_from_numpy(*synthetic.orbit_arrays(1, 8, 8), 8, 8),
    "linear_encoder_from_numpy": lambda: linear_encoder_from_numpy(np.ones((3, 4))),
    "backproject_views": lambda: backproject_views(
        synthetic.random_scene(10, device="cpu"), torch.eye(4)[None], torch.eye(3)[None],
        32, 32, LinearRGBEncoder(4, device="cpu")),
    "get_encoder": lambda: get_encoder("linear:4"),
    "get_encoder lseg": lambda: get_encoder("lseg"),
    "get_encoder dino": lambda: get_encoder("dino"),
    "LSegEncoder": lambda: LSegEncoder(),
    "DinoEncoder": lambda: DinoEncoder(),
    "VisionTransformer": lambda: VisionTransformer(
        ViTConfig(image_size=32, patch_size=16, width=16, layers=1, heads=4)),
    "LSegNet": lambda: LSegNet(),
    "LSegHead": lambda: LSegHead(),
    "CLIPTextTower": lambda: CLIPTextTower(),
    "TextEncoder": lambda: TextEncoder("x.ckpt", "bpe.txt.gz"),
    "encode_text": lambda: encode_text(["a chair"], "x.ckpt", "bpe.txt.gz"),
    "backproject_views_split": lambda: backproject_views_split(
        synthetic.random_scene(10, device="cpu"), torch.eye(4)[None], torch.eye(3)[None],
        32, 32, LinearRGBEncoder(4, device="cpu")),
    "init_scene_from_points": lambda: init_scene_from_points(
        np.zeros((5, 3)), np.zeros((5, 3)), TrainConfig(feature_dim=0)),
    "Trainer": lambda: Trainer(TrainConfig(strategy="none", feature_dim=0),
                               synthetic.random_scene(10, device="cpu"), width=32, height=32),
    "Trainer tiled": lambda: Trainer(
        TrainConfig(strategy="none", feature_dim=0, raster_engine="tiled"),
        synthetic.random_scene(10, device="cpu"), width=32, height=32),
    "accumulate_view": lambda: accumulate_view(
        synthetic.random_scene(10, device="cpu"), torch.eye(4), torch.eye(3), 32, 32),
    "create_feature_field": lambda: create_feature_field(
        synthetic.random_scene(10, device="cpu"), _cpu_cams(), LinearRGBEncoder(4, device="cpu"),
        verbose=False),
    "create_feature_field_batch": lambda: create_feature_field_batch(
        synthetic.random_scene(10, device="cpu"), torch.eye(4)[None], torch.eye(3)[None], 32, 32,
        LinearRGBEncoder(4, device="cpu")),
    "estimate_sizes": lambda: estimate_sizes(synthetic.random_scene(10, device="cpu"),
                                             _cpu_cams()),
    "prune_by_gradients": lambda: prune_by_gradients(
        synthetic.random_scene(10, device="cpu"), _cpu_cams(), verbose=False),
    "load_checkpoint": lambda: load_checkpoint("ckpt.pt", "data"),
    "backproject app": lambda: backproject_main(data_dir="data", checkpoint="ckpt.pt"),
    "verify_pruning_equivalence": lambda: verify_pruning_equivalence(
        synthetic.random_scene(10, device="cpu"), synthetic.random_scene(10, device="cpu"),
        _cpu_cams(), verbose=False),
    "LinearCodec.init": lambda: LinearCodec.init(8, 2),
    "train_codec": lambda: train_codec(np.ones((3, 8)), d_lat=2, steps=1),
    "load_codec": lambda: load_codec("codec.npz"),
    "codec_from_numpy": lambda: codec_from_numpy(np.ones((8, 2)), np.ones((2, 8))),
    "load_exemplars": lambda: load_exemplars("exemplars", LinearRGBEncoder(4, device="cpu")),
    "segment app": lambda: segment_main(data_dir="data", checkpoint="ckpt.pt"),
    "backproject_compressed app": lambda: compressed_main(data_dir="data", checkpoint="ckpt.pt"),
    "train_codec app": lambda: train_codec_main(embeddings_npz="emb.npz"),
    "visualize_pca app": lambda: pca_main(data_dir="data", checkpoint="ckpt.pt"),
    "affordance app": lambda: affordance_main(data_dir="data", checkpoint="ckpt.pt"),
    "train app": lambda: train_main(data_dir="data"),
    "Trainer default strategy": lambda: Trainer(
        TrainConfig(feature_dim=0), synthetic.random_scene(10, device="cpu"), width=32, height=32),
    "CameraOptModule": lambda: CameraOptModule(2),
    "AppearanceOptModule": lambda: AppearanceOptModule(2, 4),
    "lpips_distance": lambda: lpips_distance(random_lpips_params("alex"), np.zeros((32, 32, 3)),
                                             np.zeros((32, 32, 3))),
    "render_frame": lambda: render_frame(synthetic.random_scene(10, device="cpu"), np.eye(4),
                                         np.eye(3), 32, 32),
    "PromptSession.render_rgbd_features": lambda: PromptSession(
        synthetic.random_scene(10, device="cpu"), torch.zeros((10, 4))).render_rgbd_features(
        np.eye(4), np.eye(3), 32, 32),
    "profile_stages.main": lambda: profile_stages.main(["--num-gaussians", "10"]),
    "device_memory_stats": lambda: device_memory_stats(),
    "StageTimer": lambda: StageTimer(),
    "make_hf_backend": lambda: make_hf_backend("model-dir"),
    "viewer app": lambda: viewer_main(data_dir="data", checkpoint="ckpt.pt"),
    "click_and_segment app": lambda: click_main(data_dir="data", checkpoint="ckpt.pt"),
    "viewer_llm app": lambda: viewer_llm_main(data_dir="data", checkpoint="ckpt.pt"),
    "init_ranks": lambda: init_ranks(),
    "make_mesh": lambda: make_mesh(),
    "backproject_views_sharded": lambda: backproject_views_sharded(
        synthetic.random_scene(10, device="cpu"), torch.eye(4)[None], torch.eye(3)[None],
        torch.ones(1), 32, 32, LinearRGBEncoder(4, device="cpu")),
    "make_trainer_step_sharded": lambda: make_trainer_step_sharded(Trainer(
        TrainConfig(strategy="none", feature_dim=0), synthetic.random_scene(10, device="cpu"),
        width=32, height=32, device="cpu")),
    "dryrun_multichip": lambda: dryrun_multichip(1),
    "sharded_singlechip.main": lambda: sharded_singlechip.main([]),
    "make_atscale_dataset app": lambda: atscale_main(out="atscale"),
    "gather_locality.main": lambda: gather_locality.main([]),
    "convert_weights app": lambda: convert_weights_main(["--lseg-ckpt", "x.ckpt"]),
}


def _cpu_cams():
    return synthetic.orbit_cameras(1, 32, 32, device="cpu")


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_entry_points_default_to_cuda_and_raise_without_it(name):
    _no_cuda()
    with pytest.raises(RuntimeError, match="cuda"):
        ENTRY_POINTS[name]()


def test_resolve_device():
    assert resolve_device("cpu") == torch.device("cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            resolve_device("cuda:0")


@pytest.fixture(scope="module")
def small():
    scene = synthetic.random_scene(120, seed=0, extent=0.8, scale_range=(0.02, 0.1),
                                   device="cpu")
    cams = synthetic.orbit_cameras(1, 64, 48, radius=2.5, device="cpu")
    vm, Km = cams.viewmats[0], cams.Ks[0]
    proj = project(scene.means, scene.quats, scene.scales, scene.opacities, vm, Km, 64, 48)
    plan = build_plan(proj, 64, 48, 16)
    pack = pack_isect_all(proj, prepare_colors(scene.means, scene.colors_all, vm, 3), plan)
    feats = torch.rand((plan.n_tiles, 256, 6))
    return plan, pack, feats


BAD_CALLS = {
    "render f64 pack": (lambda p, k, f: K.render_tiles(k.double(), p), TypeError),
    "render short pack": (lambda p, k, f: K.render_tiles(k[:-1], p), ValueError),
    "adjoint f16 feats": (lambda p, k, f: K.adjoint_rows(k, f.half(), p), TypeError),
    "adjoint strided feats": (
        lambda p, k, f: K.adjoint_rows(k, f.transpose(0, 1).contiguous().transpose(0, 1), p),
        ValueError),
    "adjoint 2-d feats": (lambda p, k, f: K.adjoint_rows(k, f[0], p), ValueError),
    "reduce int rows": (
        lambda p, k, f: K.reduce_rows(torch.zeros((p.T_padded, 128), dtype=torch.int32), p, 7),
        TypeError),
    "reduce too many cols": (
        lambda p, k, f: K.reduce_rows(torch.zeros((p.T_padded, 128)), p, 129), ValueError),
    "reduce wrong rows": (
        lambda p, k, f: K.reduce_rows(torch.zeros((p.T_padded + 1, 128)), p, 7), ValueError),
    "adjoint_scatter f16 feats": (
        lambda p, k, f: K.adjoint_scatter_rows(k, f.half(), with_scatter_extras(p)), TypeError),
    "adjoint_scatter f64 pack": (
        lambda p, k, f: K.adjoint_scatter_rows(k.double(), f, with_scatter_extras(p)),
        TypeError),
    "adjoint_scatter meta pack": (
        lambda p, k, f: K.adjoint_scatter_rows(k.to("meta"), f, with_scatter_extras(p)),
        ValueError),
    "adjoint_scatter plan without extras": (
        lambda p, k, f: K.adjoint_scatter_rows(k, f, p), ValueError),
    "stripe_sum int rows": (
        lambda p, k, f: K.reduce_striped(torch.zeros(
            (with_scatter_extras(p).R_striped + 1, 128), dtype=torch.int32),
            with_scatter_extras(p), 7), TypeError),
    "stripe_sum meta rows": (
        lambda p, k, f: K.reduce_striped(torch.zeros(
            (with_scatter_extras(p).R_striped + 1, 128), device="meta"),
            with_scatter_extras(p), 7), ValueError),
    "stripe_sum wrong rows": (
        lambda p, k, f: K.reduce_striped(torch.zeros((p.T_padded, 128)),
                                         with_scatter_extras(p), 7), ValueError),
    "stripe_sum too many cols": (
        lambda p, k, f: K.reduce_striped(torch.zeros(
            (with_scatter_extras(p).R_striped + 1, 128)), with_scatter_extras(p), 129),
        ValueError),
    "stripe_sum plan without extras": (
        lambda p, k, f: K.reduce_striped(torch.zeros((p.T_padded, 128)), p, 7), ValueError),
    "scatter_write meta rows": (
        lambda p, k, f: scatter_write.scatter_write(
            torch.zeros((128, 1024), dtype=torch.bfloat16, device="meta"), None, 0),
        ValueError),
}


def _train_inputs(plan, pack, d=5):
    geom = pack[:, :8].contiguous()
    cols = torch.rand((plan.T_padded, d), generator=torch.Generator().manual_seed(d))
    img = torch.zeros((plan.height, plan.width, d))
    hw = torch.zeros((plan.height, plan.width))
    done = torch.ones((plan.n_tiles,), dtype=torch.int32)
    return geom, cols, img, hw, done


BAD_CALLS.update({
    "train_fwd f64 geom": (lambda p, k, f: train_forward(k[:, :8].double(), k[:, 8:12], p),
                           TypeError),
    "train_fwd 16-col geom": (lambda p, k, f: train_forward(k, k[:, 8:12].contiguous(), p),
                              ValueError),
    "train_fwd 1-d cols": (lambda p, k, f: train_forward(k[:, :8].contiguous(), k[:, 8], p),
                           ValueError),
    "train_bwd short g": (
        lambda p, k, f: train_rows(*_bwd_args(p, k, img=lambda i: i[:-1]), p), ValueError),
    "train_bwd int64 blocks": (
        lambda p, k, f: train_rows(*_bwd_args(p, k, done=lambda d: d.long()), p), TypeError),
    "train_bwd f16 rows": (
        lambda p, k, f: train_rows(*_bwd_args(p, k), p, torch.float16), TypeError),
    "train_bwd too many channels": (
        lambda p, k, f: train_rows(*_bwd_args(p, k, d=513), p), ValueError),
})


def _bwd_args(plan, pack, d=5, img=lambda i: i, done=lambda x: x):
    geom, cols, g, hw, blocks = _train_inputs(plan, pack, d)
    return geom, cols, img(g).contiguous(), hw, hw, done(blocks)


@pytest.mark.parametrize("case", sorted(BAD_CALLS))
def test_wrappers_reject_what_kernels_do_not_take(small, case):
    plan, pack, feats = small
    call, exc = BAD_CALLS[case]
    with pytest.raises(exc):
        call(plan, pack, feats)


def test_cpu_tensors_run_the_twins_and_count_no_launch(small):
    plan, pack, feats = small
    K.LAUNCHES.reset()
    img, done = K.render_tiles(pack, plan)
    rows = K.adjoint_rows(pack, feats, plan)
    sums = K.reduce_rows(rows, plan, 7)
    assert img.shape == (plan.n_tiles, 256, 5) and done.dtype == torch.int32
    assert rows.shape == (plan.T_padded, 128) and sums.shape == (plan.num_gaussians, 7)
    geom, cols, g, hw, _ = _train_inputs(plan, pack)
    image, alpha, done = train_forward(geom, cols, plan)
    grad_rows = train_rows(geom, cols, g, hw, hw, done, plan)
    assert image.shape == (48, 64, 5) and alpha.shape == (48, 64)
    assert grad_rows.shape == (plan.T_padded, 16)
    splan = with_scatter_extras(plan)
    striped = K.adjoint_scatter_rows(pack, feats, splan)
    assert striped.shape == (splan.R_striped + 1, 128)
    assert torch.equal(K.reduce_striped(striped, splan, 7), sums)
    scatter_write.reset_launches()
    scatter_write.run_variant(scatter_write.permutation(128), True, 1)
    assert int(scatter_write.async_copy_probe(torch.arange(64, dtype=torch.int32), 2)) == 19
    assert set(scatter_write.LAUNCHES.values()) == {0}
    assert set(K.LAUNCHES.snapshot().values()) == {0}
    assert set(K.LAUNCHES.snapshot()) == {"render", "render_unculled", "adjoint", "reduce",
                                          "train_fwd",
                                          "train_fwd_wide", "train_bwd", "train_bwd_wide",
                                          "train_bwd_geom", "adjoint_scatter", "stripe_sum"}


UNPORTED = {
    "unknown engine": (dict(raster_engine="fast"), ValueError),
    "unknown strategy": (dict(strategy="adc"), ValueError),
    "unread pallas_size_margin": (dict(pallas_size_margin=2.0), NotImplementedError),
}


@pytest.mark.parametrize("case", sorted(UNPORTED))
def test_trainer_raises_on_what_is_not_ported(case):
    kw, exc = UNPORTED[case]
    cfg = TrainConfig(**{"strategy": "none", "feature_dim": 0, **kw})
    with pytest.raises(exc):
        Trainer(cfg, synthetic.random_scene(10, device="cpu"), width=32, height=32,
                n_cameras=2, device="cpu")


# Settings that raised until the rest of training was ported, and
# TrainConfig()'s own defaults.
PORTED = {
    "unread compression": dict(compression="png"),
    "default strategy": dict(strategy="default"),
    "mcmc strategy": dict(strategy="mcmc"),
    "pose optimisation": dict(pose_opt=True, pose_noise=0.01),
    "appearance optimisation": dict(app_opt=True, feature_dim=4),
    "unread data_dir": dict(data_dir="./data/bicycle"),
    "unread lpips_net": dict(lpips_net="vgg"),
    "TrainConfig defaults": None,
}


@pytest.mark.parametrize("case", sorted(PORTED))
def test_trainer_builds_what_was_ported(case):
    kw = PORTED[case]
    cfg = TrainConfig() if kw is None else TrainConfig(**{"strategy": "none", "feature_dim": 0,
                                                          **kw})
    scene = synthetic.random_scene(10, device="cpu")
    if cfg.feature_dim:
        scene = scene.replace(features=torch.zeros((10, cfg.feature_dim)),
                              feature_proj=torch.zeros((cfg.feature_dim, 4)))
    tr = Trainer(cfg, scene, width=32, height=32, n_cameras=2, device="cpu")
    assert (tr.strategy is None) == (cfg.strategy == "none")
    assert (tr.pose_params is not None) == cfg.pose_opt
    assert (tr.app_module is not None) == cfg.app_opt


def test_build_is_keyed_on_sources_and_targets_sm90a(tmp_path, monkeypatch):
    assert "arch=compute_90a,code=sm_90a" in build.NVCC_FLAGS
    names = {p.name for p in build.CSRC_DIR.glob("*.cu")}
    assert names == {"render.cu", "adjoint.cu", "reduce.cu", "train_fwd.cu", "train_bwd.cu",
                     "stripe_sum.cu", "exp_scatter_write.cu"}
    before = build.library_path()
    copy = tmp_path / "csrc"
    shutil.copytree(build.CSRC_DIR, copy)
    monkeypatch.setattr(build, "CSRC_DIR", copy)
    assert build.library_path() == before
    (copy / "reduce.cu").write_text((copy / "reduce.cu").read_text() + "\n// edit\n")
    assert build.library_path() != before


def test_every_entry_point_has_a_signature():
    """Each ``extern "C"`` function of csrc/ is bound with its argument
    types, and each bound name exists in the sources."""
    import re

    defined = set()
    for cu in build.CSRC_DIR.glob("*.cu"):
        defined |= set(re.findall(r'extern "C" int (\w+)\(', cu.read_text()))
    assert defined == set(build.SIGNATURES)


def test_build_without_nvcc_raises(tmp_path, monkeypatch):
    if shutil.which("nvcc") or Path("/usr/local/cuda/bin/nvcc").exists():
        pytest.skip("nvcc is installed here")
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.delenv("CUDA_PATH", raising=False)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "b")
    with pytest.raises(RuntimeError, match="nvcc"):
        build.build_library()

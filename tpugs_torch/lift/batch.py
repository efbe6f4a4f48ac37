"""Fused multi-view feature back-projection on the three kernels.
Counterparts: ``tpugs/lift/pallas_batch.py:69-154``
(``backproject_one_view_pallas``), ``:443`` (``backproject_views_grouped``),
``:373`` (``backproject_views_grouped_split``)
and ``tpugs/lift/batch.py`` (``StaticSizes``, ``estimate_sizes`` :38-72,
``normalize_field`` :182, ``create_feature_field_batch`` :186).

Per view: projection + SH colours, the exact per-view plan, the pack, the
render kernel (B1), the 2D encoder on the tile layout, the adjoint kernel
(B2) and the reduce kernel (B3) — or, with ``reduce_engine="scatter"``,
the scatter-write adjoint (B6) and the stripe sum (B7) on a plan built with
``scatter=True`` (``pallas_batch.py:114``), bit-equal to the default
engine. ``backproject_views`` is a plain loop
over views that accumulates ``num``/``den``; the reference's dispatch
groups and optimisation barriers amortise TPU transport latency and have
no counterpart here. ``backproject_views_split`` runs the same per-view
stages (``render_and_pack``, then ``contribution_sums``) around one encoder
call per group of views, for the ViT encoders.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional, Tuple

import torch

from tpugs_torch.core.device import DeviceLike, resolve_device
from tpugs_torch.core.scene import GaussianScene
from tpugs_torch.raster.colors import prepare_colors
from tpugs_torch.core.camera import Camera
from tpugs_torch.raster.binning import bucket, tile_bbox, tile_grid
from tpugs_torch.raster.kernels import TRANS_EPS, WORK, render_tiles
from tpugs_torch.raster.pack import pack_isect_all
from tpugs_torch.raster.plan import Plan, build_plan
from tpugs_torch.raster.projection import ProjectionConfig, project
from tpugs_torch.raster.tiled import TileConfig, contribution_sums, required_blocks, split_sums
from tpugs_torch.raster.tiles import image_to_tiles, tiles_to_image
from tpugs_torch.utils.profiling import annotation

DEFAULT_TILE = 32  # larger tiles: ~4x fewer intersections than 16
STAGES = ("project+sh", "plan", "pack", "render", "encode", "adjoint", "reduce")


@dataclasses.dataclass
class ViewResult:
    """One view's intermediates, in the order the pipeline makes them."""

    plan: Plan
    packed: torch.Tensor  # (T_padded, 16) float32
    tiles: torch.Tensor  # (n_tiles, ts*ts, 5) [rgb, depth, 1 - T]
    blocks_done: torch.Tensor  # (n_tiles,) blocks each tile processed
    feat_tiles: torch.Tensor  # (n_tiles, ts*ts, D) in the contribution dtype
    rows: torch.Tensor  # (T_padded, width) rows; (R_striped + 1, width) striped with "scatter"
    sums: torch.Tensor  # (N, D + 1) float32: features | weight

    @property
    def num(self) -> torch.Tensor:
        return split_sums(self.sums)[0]

    @property
    def den(self) -> torch.Tensor:
        return split_sums(self.sums)[1]


class Rendered(NamedTuple):
    """One view's render: its plan, pack, tiles and exit blocks."""

    plan: Plan
    packed: torch.Tensor
    tiles: torch.Tensor
    blocks_done: torch.Tensor


def render_and_pack(
    scene: GaussianScene,
    viewmat: torch.Tensor,
    K: torch.Tensor,
    width: int,
    height: int,
    tile_size: int = DEFAULT_TILE,
    proj_config: ProjectionConfig = ProjectionConfig(),
    trans_eps: float = TRANS_EPS,
    on_stage: Optional[Callable[[str], None]] = None,
    scatter: bool = False,
) -> Rendered:
    """Projection + SH colours, the plan (with the scatter engine's extras
    when ``scatter``), the pack and B1: the stages up to "render", in the
    trace's spans ``tpugs.lift.project``, ``sh``, ``plan``, ``pack`` and
    ``render``. B1's walked slots go to ``WORK`` (``raster/kernels.py``)."""
    mark = on_stage or (lambda name: None)
    with annotation("tpugs.lift.project"):
        proj = project(scene.means, scene.quats, scene.scales, scene.opacities,
                       viewmat, K, width, height, proj_config)
    with annotation("tpugs.lift.sh"):
        cols3 = prepare_colors(scene.means, scene.colors_all, viewmat, scene.sh_degree)
    mark("project+sh")
    with annotation("tpugs.lift.plan"):
        plan = build_plan(proj, width, height, tile_size, scatter=scatter)
    mark("plan")
    with annotation("tpugs.lift.pack"):
        packed = pack_isect_all(proj, cols3, plan)
    mark("pack")
    with annotation("tpugs.lift.render"):
        tiles, blocks_done = render_tiles(packed, plan, trans_eps)
        WORK.walked(blocks_done)
    mark("render")
    return Rendered(plan, packed, tiles, blocks_done)


def run_view(
    scene: GaussianScene,
    viewmat: torch.Tensor,
    K: torch.Tensor,
    width: int,
    height: int,
    encoder,
    tile_size: int = DEFAULT_TILE,
    contrib_dtype: torch.dtype = torch.bfloat16,
    proj_config: ProjectionConfig = ProjectionConfig(),
    trans_eps: float = TRANS_EPS,
    on_stage: Optional[Callable[[str], None]] = None,
    reduce_engine: str = "pallas",
) -> ViewResult:
    """The per-view pipeline on the scene's device. ``on_stage(name)`` is
    called after each of ``STAGES`` (for timing). ``reduce_engine`` is
    "pallas" (B2 + B3) or "scatter" (B6 + B7); see ``contribution_sums``."""
    mark = on_stage or (lambda name: None)
    r = render_and_pack(scene, viewmat, K, width, height, tile_size, proj_config,
                        trans_eps, mark, scatter=(reduce_engine == "scatter"))
    with annotation("tpugs.lift.encode", timed=True):
        if getattr(encoder, "pixelwise", False):
            feats = encoder(r.tiles[..., :3])
        else:
            rgb = tiles_to_image(r.tiles, width, height, tile_size)[..., :3]
            feats = image_to_tiles(encoder(rgb), tile_size)
        feats = feats.to(contrib_dtype).contiguous()
    mark("encode")
    rows, sums = contribution_sums(r.packed, feats, r.plan, trans_eps, mark, reduce_engine)
    return ViewResult(r.plan, r.packed, r.tiles, r.blocks_done, feats, rows, sums)


def backproject_one_view(
    scene: GaussianScene,
    viewmat: torch.Tensor,
    K: torch.Tensor,
    width: int,
    height: int,
    encoder,
    tile_size: int = DEFAULT_TILE,
    contrib_dtype: torch.dtype = torch.bfloat16,
    proj_config: ProjectionConfig = ProjectionConfig(),
    trans_eps: float = TRANS_EPS,
    on_stage: Optional[Callable[[str], None]] = None,
    reduce_engine: str = "pallas",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(feat_sums (N, D), weight_sums (N,)) of one view."""
    r = run_view(scene, viewmat, K, width, height, encoder, tile_size,
                 contrib_dtype, proj_config, trans_eps, on_stage, reduce_engine)
    return r.num, r.den


def backproject_views(
    scene: GaussianScene,
    viewmats: torch.Tensor,  # (C, 4, 4)
    Ks: torch.Tensor,  # (C, 3, 3)
    width: int,
    height: int,
    encoder,
    tile_size: int = DEFAULT_TILE,
    contrib_dtype: torch.dtype = torch.bfloat16,
    proj_config: ProjectionConfig = ProjectionConfig(),
    trans_eps: float = TRANS_EPS,
    device: DeviceLike = "cuda",
    on_stage: Optional[Callable[[str], None]] = None,
    reduce_engine: str = "pallas",
    cam_weights: Optional[torch.Tensor] = None,  # (C,)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """All views, one after another: (num (N, D), den (N,)) float32 on
    ``device``. The scene and cameras are moved there; the encoder's
    weights must already live there. ``contrib_dtype`` bfloat16 is the
    production path, float32 the exact one. ``reduce_engine`` "pallas"
    (default) or "scatter" give bit-equal results, "xla" equal to float
    rounding; any other value raises ValueError. ``cam_weights`` multiplies
    each view's sums (0 drops a padding camera), as the reference's scan
    does.

    Traced, the call is a ``tpugs.lift.call`` span and each view a
    ``tpugs.lift.view`` span around the stage spans (``run_view``), then
    ``tpugs.lift.accumulate``: the weighting and ``num += fs``, which the
    device runs inside the next view's "project+sh" stage."""
    with annotation("tpugs.lift.call"):
        dev = resolve_device(device)
        scene = scene.to(dev)
        viewmats = viewmats.to(dev)
        Ks = Ks.to(dev)
        cam_weights = _host_weights(cam_weights)
        n = scene.num_gaussians
        num = torch.zeros((n, encoder.feature_dim), dtype=torch.float32, device=dev)
        den = torch.zeros((n,), dtype=torch.float32, device=dev)
        for c in range(viewmats.shape[0]):
            with annotation("tpugs.lift.view"):
                fs, ws = backproject_one_view(
                    scene, viewmats[c], Ks[c], width, height, encoder, tile_size,
                    contrib_dtype, proj_config, trans_eps, on_stage, reduce_engine,
                )
                _accumulate(num, den, fs, ws, cam_weights, c)
        return num, den


def _host_weights(cam_weights) -> Optional[list]:
    """``cam_weights`` as a list of floats on the host (a host sync where
    they live on the device), or None."""
    if cam_weights is None:
        return None
    with annotation("tpugs.sync.cam_weights"):
        return torch.as_tensor(cam_weights, dtype=torch.float32).tolist()


def _accumulate(num, den, fs, ws, cam_weights: Optional[list], c: int) -> None:
    """``num += w * fs``, ``den += w * ws`` with view ``c``'s weight."""
    with annotation("tpugs.lift.accumulate"):
        if cam_weights is not None:
            fs, ws = cam_weights[c] * fs, cam_weights[c] * ws
        num += fs
        den += ws


def backproject_views_split(
    scene: GaussianScene,
    viewmats: torch.Tensor,  # (C, 4, 4)
    Ks: torch.Tensor,  # (C, 3, 3)
    width: int,
    height: int,
    encoder,
    group_size: int = 2,
    tile_size: int = DEFAULT_TILE,
    contrib_dtype: torch.dtype = torch.bfloat16,
    proj_config: ProjectionConfig = ProjectionConfig(),
    trans_eps: float = TRANS_EPS,
    device: DeviceLike = "cuda",
    on_stage: Optional[Callable[[str], None]] = None,
    reduce_engine: str = "pallas",
    cam_weights: Optional[torch.Tensor] = None,  # (C,)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The split-encoder lift for heavyweight encoders (LSeg, DINO):
    (num (N, D), den (N,)) float32 on ``device``, like ``backproject_views``.
    Per group of ``group_size`` views: render each view with B1, keeping its
    plan and pack; encode the group's stacked RGBs at once, through the
    encoder's ``staged_apply`` where it has one, else per image; then the
    adjoint and reduce of each view on its kept plan. Features are
    materialised in bfloat16 (as tpugs does) and cast to ``contrib_dtype``
    for the adjoint. ``reduce_engine`` is honoured ("pallas", "scatter" or
    "xla"); ``cam_weights`` multiplies each view's sums. The last group may
    be short: tpugs pads it with a zero-weighted view only because its
    shapes are static, which changes no sum. ``on_stage`` is called after
    each view's render stages, once per group after "encode", and after
    each view's "adjoint" and "reduce". Traced, the call is a
    ``tpugs.lift.call`` span around the stage spans of ``backproject_views``
    with no view span: ``tpugs.lift.encode`` once per group, the others
    once per view."""
    with annotation("tpugs.lift.call"):
        dev = resolve_device(device)
        scene = scene.to(dev)
        viewmats = viewmats.to(dev)
        Ks = Ks.to(dev)
        cam_weights = _host_weights(cam_weights)
        mark = on_stage or (lambda name: None)
        g = max(1, group_size)
        n, C = scene.num_gaussians, viewmats.shape[0]
        num = torch.zeros((n, encoder.feature_dim), dtype=torch.float32, device=dev)
        den = torch.zeros((n,), dtype=torch.float32, device=dev)
        for c0 in range(0, C, g):
            views = range(c0, min(c0 + g, C))
            rendered = [render_and_pack(scene, viewmats[c], Ks[c], width, height, tile_size,
                                        proj_config, trans_eps, mark,
                                        scatter=(reduce_engine == "scatter")) for c in views]
            with annotation("tpugs.lift.encode", timed=True):
                rgbs = torch.stack([tiles_to_image(r.tiles, width, height, tile_size)[..., :3]
                                    for r in rendered])
                stage = getattr(encoder, "staged_apply", None)
                if stage is not None:
                    feats = stage(rgbs)
                else:
                    feats = torch.stack([encoder(rgb).to(torch.bfloat16) for rgb in rgbs])
                feat_tiles = [image_to_tiles(f, tile_size).to(contrib_dtype).contiguous()
                              for f in feats]
                del feats, rgbs
            mark("encode")
            for c, r, f in zip(views, rendered, feat_tiles):
                _, sums = contribution_sums(r.packed, f, r.plan, trans_eps, mark, reduce_engine)
                _accumulate(num, den, *split_sums(sums), cam_weights, c)
        return num, den


def normalize_field(num: torch.Tensor, den: torch.Tensor) -> torch.Tensor:
    """num/den, L2-normalise, NaN -> 0."""
    features = num / (den[:, None] + 1e-12)
    features = features / torch.linalg.vector_norm(features, dim=-1, keepdim=True)
    return torch.nan_to_num(features, nan=0.0, posinf=0.0, neginf=0.0)


class StaticSizes(NamedTuple):
    """The reference's static shape buckets of a camera batch. The port's
    plans are exact, so these change no result; ``estimate_sizes`` still
    measures them."""

    max_cover: int
    max_blocks: int


def estimate_sizes(
    scene: GaussianScene,
    cams: Camera,
    proj_config: ProjectionConfig = ProjectionConfig(),
    tile_config: TileConfig = TileConfig(),
    probe_cameras: int = 0,
    device: DeviceLike = "cuda",
) -> StaticSizes:
    """The largest bbox cover and per-tile span in blocks over (a probe
    subset of) the cameras, each bucketed to a power of two as the
    reference does."""
    dev = resolve_device(device)
    scene = scene.to(dev)
    idxs = range(cams.num_cameras)
    if probe_cameras and probe_cameras < cams.num_cameras:
        idxs = range(0, cams.num_cameras, max(1, cams.num_cameras // probe_cameras))
    ts = tile_config.tile_size
    ntx, nty = tile_grid(cams.width, cams.height, ts)
    max_cover, max_blocks = 1, 1
    with torch.no_grad():
        for c in idxs:
            proj = project(scene.means, scene.quats, scene.scales, scene.opacities,
                           cams.viewmats[c].to(dev), cams.Ks[c].to(dev), cams.width,
                           cams.height, proj_config)
            tx0, ty0, tx1, ty1 = tile_bbox(proj.means2d, proj.radii, proj.valid, ts, ntx, nty)
            cover = int(((tx1 - tx0) * (ty1 - ty0)).max()) if scene.num_gaussians else 0
            plan = build_plan(proj, cams.width, cams.height, ts)
            max_cover = max(max_cover, bucket(cover))
            max_blocks = max(max_blocks, bucket(required_blocks(plan, tile_config.block_size)))
    return StaticSizes(bucket(max_cover), bucket(max_blocks))


def create_feature_field_batch(
    scene: GaussianScene,
    viewmats: torch.Tensor,  # (C, 4, 4)
    Ks: torch.Tensor,  # (C, 3, 3)
    width: int,
    height: int,
    encoder,
    sizes: Optional[StaticSizes] = None,
    cam_weights: Optional[torch.Tensor] = None,  # (C,)
    proj_config: ProjectionConfig = ProjectionConfig(),
    tile_config: TileConfig = TileConfig(),
    feature_dim: Optional[int] = None,
    device: DeviceLike = "cuda",
) -> torch.Tensor:
    """All views to the normalised (N, D) feature field:
    ``backproject_views`` at the reference's tiled semantics (no early
    exit, f32 rows, ``tile_config.tile_size``), then ``normalize_field``.
    ``sizes`` (the reference's static buckets) changes nothing;
    ``cam_weights`` multiplies each view's sums. The weight sums count
    the pixels inside W x H only (the kernels' rule; the reference's tiled
    adjoint also counts the rest of edge tiles)."""
    if feature_dim is not None and feature_dim != encoder.feature_dim:
        raise ValueError(f"feature_dim {feature_dim} != the encoder's {encoder.feature_dim}")
    num, den = backproject_views(
        scene, viewmats, Ks, width, height, encoder, tile_size=tile_config.tile_size,
        contrib_dtype=torch.float32, proj_config=proj_config, trans_eps=0.0, device=device,
        cam_weights=cam_weights)
    return normalize_field(num, den)

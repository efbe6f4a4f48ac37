"""Feature-3DGS trainer, the step. Counterpart: ``tpugs/train/trainer.py``
(``knn_mean_dist``, ``rgb_to_sh``, ``init_scene_from_points``,
``init_scene_random`` :47-116; ``make_optimizer`` :119; ``_feature_l1``
:157; ``Trainer`` :197 with ``train_step`` :644, ``train_chunk`` :857 and
``render_eval`` :957).

Joint RGB + feature distillation: per step, projection and SH on the
scene's tensors, the exact per-view plan, the differentiable render
(``raster/train.py``: kernel B4 forward, B5 + B3 backward; with
``raster_engine="tiled"``, ``raster/tiled.py::render_tiled``, the same
kernels with no early exit at the ``TileConfig`` tile), L1 + SSIM,
the optional depth loss, the feature L1 against the teacher, and one Adam
step per parameter group. ``train_chunk`` is a plain loop over steps: the
reference's ``lax.scan`` and static size buckets have no counterpart, and
nothing overflows because plans are exact. The screen-gradient statistic
comes from a zero ``offset2d`` probe added to the projected means (and the
absgrad probe of the render), as in the reference: no hooks.

Not ported yet (ROADMAP item 4): densification ``refine`` and its
optimizer-state surgery, pose and appearance modules, LPIPS, ``evaluate``
and checkpoints, the dataset and the apps.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from tpugs_torch.core.device import DeviceLike, resolve_device
from tpugs_torch.core.scene import GaussianScene
from tpugs_torch.raster.api import plan_render, rasterize_with_plan
from tpugs_torch.raster.plan import build_plan
from tpugs_torch.raster.projection import Projected, ProjectionConfig, project, view_directions
from tpugs_torch.raster.sh import sh_to_color
from tpugs_torch.raster.tiled import TileConfig, render_tiled
from tpugs_torch.raster.train import render_plan_train, render_scene
from tpugs_torch.train.config import NOT_READ, TrainConfig, unread_settings
from tpugs_torch.train.metrics import ssim_loss
from tpugs_torch.train.strategy import GradState, make_strategy

# scene field -> optimizer group (the reference's labels)
GROUPS = {
    "means": "means",
    "quats": "quats",
    "log_scales": "scales",
    "logit_opacities": "opacities",
    "sh0": "sh0",
    "shN": "shN",
    "features": "features",
    "feature_proj": "conv",
}
DEPTH_POINTS = 4096  # depth-loss points used per step (the reference's cap)
# Stage ends reported to ``Trainer.on_stage`` within one step, in order.
STAGES = ("teacher", "project+sh", "plan", "pack", "render", "loss", "loss backward", "B5 rows",
          "B3 reduce", "chain backward", "optimizer")


def knn_mean_dist(points: np.ndarray, k: int = 4) -> np.ndarray:
    """Mean distance to the k - 1 nearest other points (init scales)."""
    from scipy.spatial import cKDTree

    d, _ = cKDTree(points).query(points, k=k)
    return d[:, 1:].mean(axis=1)


def rgb_to_sh(rgb: np.ndarray) -> np.ndarray:
    """(..., 3) colour -> DC SH coefficient."""
    C0 = 0.28209479177387814
    return (rgb - 0.5) / C0


def init_scene_from_points(
    points: np.ndarray,
    rgbs: np.ndarray,
    cfg: TrainConfig,
    scene_scale: float = 1.0,
    device: DeviceLike = "cuda",
) -> GaussianScene:
    """SfM initialisation with the reference's numpy draws, in its order:
    positions from points, scales from kNN distances, random rotations, DC
    colours from the points' RGB, features N(0, 0.01^2) and a projection
    N(0, 1/feature_dim)."""
    dev = resolve_device(device)
    n = len(points)
    rng = np.random.default_rng(cfg.seed)
    if n >= 4:
        dist = np.clip(knn_mean_dist(points), 1e-7, None) * cfg.init_scale
    else:
        dist = np.full(n, 0.02, np.float32)
    log_scales = np.log(np.repeat(dist[:, None], 3, axis=1)).astype(np.float32)
    quats = rng.normal(size=(n, 4)).astype(np.float32)
    opac = np.full(n, cfg.init_opa, np.float32)
    logit_opa = np.log(opac / (1 - opac)).astype(np.float32)
    k_rest = (cfg.sh_degree + 1) ** 2 - 1
    sh0 = rgb_to_sh(rgbs).astype(np.float32)[:, None, :]
    shN = np.zeros((n, k_rest, 3), np.float32)
    features = proj = None
    if cfg.feature_dim:
        features = rng.normal(size=(n, cfg.feature_dim)).astype(np.float32) * 0.01
        proj = rng.normal(size=(cfg.feature_dim, cfg.feature_out_dim)).astype(
            np.float32) * (1.0 / np.sqrt(cfg.feature_dim))

    def t(a):
        return None if a is None else torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev)

    return GaussianScene(means=t(points), quats=t(quats), log_scales=t(log_scales),
                         logit_opacities=t(logit_opa), sh0=t(sh0), shN=t(shN),
                         features=t(features), feature_proj=t(proj))


def init_scene_random(cfg: TrainConfig, scene_scale: float = 1.0,
                      device: DeviceLike = "cuda") -> GaussianScene:
    rng = np.random.default_rng(cfg.seed)
    pts = rng.uniform(-1, 1, (cfg.init_num_pts, 3)) * cfg.init_extent * scene_scale
    rgbs = rng.uniform(0, 1, (cfg.init_num_pts, 3))
    return init_scene_from_points(pts, rgbs, cfg, scene_scale, device)


def means_lr(cfg: TrainConfig, scene_scale: float, batch_size: int, k: int) -> float:
    """The means' learning rate at 0-based update k: optax's
    ``exponential_decay(init, max_steps, 0.01)``, init = means_lr * scene
    scale * sqrt(batch)."""
    init = cfg.means_lr * scene_scale * float(np.sqrt(batch_size))
    return init * 0.01 ** (k / cfg.max_steps)


def make_optimizer(cfg: TrainConfig, scene: GaussianScene, scene_scale: float = 1.0,
                   batch_size: int = 1) -> torch.optim.Adam:
    """One Adam group per scene field (named by the reference's label),
    eps 1e-15, lr * sqrt(batch). The means group starts at
    ``means_lr(..., 0)``; the trainer sets it before every step."""
    bs = float(np.sqrt(batch_size))
    lrs = {
        "means": means_lr(cfg, scene_scale, batch_size, 0),
        "scales": cfg.scales_lr * bs,
        "opacities": cfg.opacities_lr * bs,
        "quats": cfg.quats_lr * bs,
        "sh0": cfg.sh0_lr * bs,
        "shN": cfg.shN_lr * bs,
        "features": cfg.features_lr * bs,
        "conv": cfg.conv_lr * bs,
    }
    groups = [
        {"params": [getattr(scene, f)], "lr": lrs[label], "name": label}
        for f, label in GROUPS.items() if getattr(scene, f) is not None
    ]
    return torch.optim.Adam(groups, eps=1e-15)


class _StageAtGrad(torch.autograd.Function):
    """Identity on its tensors whose backward calls ``mark(name)`` once their
    gradients have all arrived: on the render's outputs, the end of the
    loss's backward."""

    @staticmethod
    def forward(ctx, mark, name, *xs):
        ctx.mark, ctx.name = mark, name
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *grads):
        ctx.mark(ctx.name)
        return (None, None, *grads)


def _feature_l1(feat_img: torch.Tensor, proj_mat: torch.Tensor, teacher: torch.Tensor):
    """mean |feat_img @ proj_mat - teacher|, the teacher read as f32. At
    the garden shape the (H, W, D_out) f32 product is 2.2 GB; an 80 GB card
    holds it and its saved difference, so it is not chunked."""
    return torch.mean(torch.abs(feat_img @ proj_mat - teacher.float()))


class Trainer:
    """Single-device trainer on ``device`` (default CUDA; ``device="cpu"``
    runs the kernels' plain twins). The scene's tensors become the
    optimised leaves. ``on_stage(name)``, if set, is called at the end of
    each of ``STAGES`` within a step (for timing; "teacher" only in
    ``train_chunk``). ``record``, if set to a dict, receives each step's
    render inputs, B4 outputs, B5 inputs and rows (``render_plan_train``),
    so that the kernels can be checked on the main path's own inputs."""

    def __init__(
        self,
        cfg: TrainConfig,
        scene: GaussianScene,
        scene_scale: float = 1.0,
        teacher: Optional[Callable] = None,  # (H, W, 3) -> (H, W, D_out)
        width: int = 0,
        height: int = 0,
        n_cameras: int = 0,
        device: DeviceLike = "cuda",
    ):
        self.device = resolve_device(device)
        if cfg.raster_engine not in ("auto", "pallas", "tiled"):
            raise ValueError(f"unknown raster_engine {cfg.raster_engine!r} "
                             "(expected auto|pallas|tiled)")
        if n_cameras > 0 and (cfg.pose_opt or cfg.pose_noise > 0.0):
            raise NotImplementedError("pose optimisation is not ported yet: ROADMAP item 4")
        if n_cameras > 0 and cfg.app_opt and scene.features is not None:
            raise NotImplementedError("appearance optimisation is not ported yet: "
                                      "ROADMAP item 4")
        unread = unread_settings(cfg)
        if unread:
            raise NotImplementedError("not read by the port yet (ROADMAP item 4): " + ", ".join(
                f"TrainConfig.{k} ({NOT_READ[k]})" for k in unread))
        self.cfg = cfg
        self.scene = GaussianScene(**{
            f.name: None if getattr(scene, f.name) is None
            else getattr(scene, f.name).detach().to(self.device).clone().requires_grad_()
            for f in dataclasses.fields(scene)
        })
        self.scene_scale = scene_scale
        self.teacher = teacher
        self.teacher_dtype = getattr(torch, cfg.teacher_dtype)
        self.width = width
        self.height = height
        self.optimizer = make_optimizer(cfg, self.scene, scene_scale, cfg.batch_size)
        self.strategy = make_strategy(cfg, scene_scale, cfg.seed)
        self.grad_state = GradState.zeros(self.scene.num_gaussians, self.device)
        self.step = 0
        self.proj_config = ProjectionConfig(near_plane=cfg.near_plane,
                                            far_plane=cfg.far_plane,
                                            antialiased=cfg.antialiased)
        # "auto" and "pallas": the kernels at pallas_trans_eps and the Pallas
        # tile; "tiled": render_tiled (no early exit) at tile_config's tile
        self.engine = "tiled" if cfg.raster_engine == "tiled" else "pallas"
        self.tile_config = TileConfig()
        self.tile_size = cfg.pallas_tile_size or (32 if width * height >= (1 << 20) else 16)
        self.contrib_dtype = getattr(torch, cfg.pallas_contrib_dtype)
        self._rng = np.random.default_rng(cfg.seed + 7)
        self.on_stage: Optional[Callable[[str], None]] = None
        self.record: Optional[dict] = None

    def _mark(self, name: str) -> None:
        if self.on_stage is not None:
            self.on_stage(name)

    def _tensor(self, x, dtype=torch.float32) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x) if not torch.is_tensor(x) else x,
                               dtype=dtype).to(self.device)

    # --------------------------------------------------------- train step
    def _zero_probes(self, n: int) -> dict:
        """Zero screen-gradient probes: d loss / d "off" is the signed
        screen gradient; "abs" (live under ``cfg.absgrad``) receives the
        per-pixel-abs one."""
        def z():
            return torch.zeros((n, 2), dtype=torch.float32, device=self.device,
                               requires_grad=True)

        return {"off": z(), "abs": z() if self.cfg.absgrad else None}

    def _grow_stat(self, gprobes: dict) -> torch.Tensor:
        return gprobes["abs"] if self.cfg.absgrad else gprobes["off"]

    def _view_inputs(self, scene: GaussianScene, probes: dict, viewmat, K, sh_degree: int):
        """Projection with the offset probe, validity-masked opacities and
        the rendered channels [SH colour | depth | features]."""
        proj = project(scene.means, scene.quats, scene.scales, scene.opacities, viewmat, K,
                       self.width, self.height, self.proj_config)
        proj = proj._replace(means2d=proj.means2d + probes["off"])
        opac = torch.where(proj.valid, proj.opacities, torch.zeros_like(proj.opacities))
        colors = sh_to_color(scene.colors_all, view_directions(scene.means, viewmat), sh_degree)
        chans = [colors]
        if self.cfg.depth_loss:
            chans.append(proj.depths[:, None])
        if scene.features is not None:
            chans.append(scene.features)
        return proj, opac, torch.cat(chans, dim=-1)

    def _reg_loss(self, scene: GaussianScene) -> torch.Tensor:
        cfg = self.cfg
        reg = torch.zeros((), device=self.device)
        if cfg.opacity_reg > 0:
            reg = reg + cfg.opacity_reg * torch.mean(scene.opacities)
        if cfg.scale_reg > 0:
            reg = reg + cfg.scale_reg * torch.mean(scene.scales)
        return reg

    def _loss_from_projected(self, proj, opac, allc, abs_probe, image, teacher_feats,
                             points, point_depths, bkgd, feature_proj, feat_dim):
        cfg = self.cfg
        tiled = self.engine == "tiled"
        with torch.no_grad():
            plan = build_plan(Projected(*(t.detach() for t in proj)), self.width, self.height,
                              self.tile_config.tile_size if tiled else self.tile_size)
        self._mark("plan")
        if tiled:
            img, alpha = render_tiled(proj.means2d, proj.conics, opac, allc, plan,
                                      self.tile_config, abs_probe=abs_probe,
                                      on_stage=self.on_stage, record=self.record)
        else:
            img, alpha = render_plan_train(
                proj.means2d, proj.conics, opac, allc, plan, trans_eps=cfg.pallas_trans_eps,
                abs_probe=abs_probe, contrib_dtype=self.contrib_dtype, on_stage=self.on_stage,
                record=self.record)
        if self.on_stage is not None:
            img, alpha = _StageAtGrad.apply(self.on_stage, "loss backward", img, alpha)
        rgb = img[..., :3]
        off = 3
        if cfg.random_bkgd:
            rgb = rgb + bkgd[None, None, :] * (1.0 - alpha[..., None])
        l1 = torch.mean(torch.abs(rgb - image))
        dssim = ssim_loss(rgb, image)
        loss = (1.0 - cfg.ssim_lambda) * l1 + cfg.ssim_lambda * dssim

        zero = torch.zeros((), device=self.device)
        depth_l = zero
        if cfg.depth_loss:
            depth_img = img[..., off]
            off += 1
            if points is not None:
                xy = points.long()  # truncation, as the reference's int32 cast
                x = xy[:, 0].clamp(0, self.width - 1)
                y = xy[:, 1].clamp(0, self.height - 1)
                pred = depth_img[y, x]
                err = torch.abs(1.0 / torch.clamp(pred, min=1e-6)
                                - 1.0 / torch.clamp(point_depths, min=1e-6))
                depth_l = torch.sum(err) / max(err.shape[0], 1)
                loss = loss + cfg.depth_lambda * depth_l

        feat_l = zero
        if feat_dim is not None and teacher_feats is not None:
            feat_l = _feature_l1(img[..., off:off + feat_dim], feature_proj, teacher_feats)
            loss = loss + cfg.feature_lambda * feat_l
        aux = {"l1": l1, "ssim_loss": dssim, "feature_l1": feat_l, "depth_l": depth_l,
               "visible": proj.valid}
        return loss, aux

    def _loss_fn(self, scene: GaussianScene, probes: dict, viewmat, K, image,
                 teacher_feats, points, point_depths, bkgd, sh_degree: int):
        """(loss, aux) of one view at ``scene``; differentiable in the
        scene's tensors and in the probes."""
        proj, opac, allc = self._view_inputs(scene, probes, viewmat, K, sh_degree)
        self._mark("project+sh")
        loss, aux = self._loss_from_projected(
            proj, opac, allc, probes.get("abs"), image, teacher_feats, points,
            point_depths, bkgd, scene.feature_proj,
            None if scene.features is None else scene.features.shape[-1])
        loss = loss + self._reg_loss(scene)
        self._mark("loss")
        return loss, aux

    def _params(self):
        return [p for g in self.optimizer.param_groups for p in g["params"]]

    def _step_on(self, viewmat, K, image, teacher_feats, points, point_depths, bkgd,
                 sh_degree: int) -> dict:
        """One step on device tensors: loss, gradients, Adam update; the
        grad2d statistic (NDC units) goes to ``grad_state`` when a
        strategy is set. Returns the step's scalar tensors."""
        n = self.scene.num_gaussians
        probes = self._zero_probes(n)
        loss, aux = self._loss_fn(self.scene, probes, viewmat, K, image, teacher_feats,
                                  points, point_depths, bkgd, sh_degree)
        params = self._params()
        live = [probes["off"]] + ([probes["abs"]] if probes["abs"] is not None else [])
        grads = torch.autograd.grad(loss, params + live, allow_unused=True)
        self._mark("chain backward")
        for p, g in zip(params, grads):
            p.grad = torch.zeros_like(p) if g is None else g
        gprobes = {"off": grads[len(params)],
                   "abs": grads[len(params) + 1] if probes["abs"] is not None else None}
        for group in self.optimizer.param_groups:
            if group["name"] == "means":
                group["lr"] = means_lr(self.cfg, self.scene_scale, self.cfg.batch_size,
                                       self.step)
        self.optimizer.step()
        self._mark("optimizer")
        if self.strategy is not None:
            ndc = torch.tensor([self.width / 2.0, self.height / 2.0], device=self.device)
            grad2d = torch.linalg.vector_norm(self._grow_stat(gprobes) * ndc, dim=1)
            self.grad_state.accumulate(grad2d, aux["visible"])
            if (self.step > 0 and self.cfg.reset_every > 0
                    and self.step % self.cfg.reset_every == 0
                    and self.step < self.cfg.refine_stop_iter):
                # gsplat's opacity reset and the zeroing of the opacities
                # group's Adam moments come with the strategies
                raise NotImplementedError("opacity reset: ROADMAP item 4")
        self.step += 1
        return {"loss": loss.detach(), **{k: aux[k].detach() for k in
                                          ("l1", "ssim_loss", "feature_l1", "depth_l")}}

    def _bkgd(self) -> torch.Tensor:
        bg = (self._rng.uniform(0, 1, 3).astype(np.float32) if self.cfg.random_bkgd
              else np.zeros(3, np.float32))
        return torch.from_numpy(bg).to(self.device)

    def sh_degree_at(self, step: int) -> int:
        return min(step // self.cfg.sh_degree_interval, self.cfg.sh_degree)

    def train_step(self, batch: dict, teacher_feats=None) -> dict:
        """One step on ``batch`` ("viewmat", "K", "image" (H, W, 3) and,
        with ``depth_loss``, "points" (M, 2) and "depths" (M,), of which
        the first ``DEPTH_POINTS`` are used); returns
        the step's losses as floats."""
        cfg = self.cfg
        with_depth = cfg.depth_loss and "points" in batch
        cap = DEPTH_POINTS
        stats = self._step_on(
            self._tensor(batch["viewmat"]), self._tensor(batch["K"]),
            self._tensor(batch["image"]),
            None if teacher_feats is None else self._tensor(teacher_feats, self.teacher_dtype),
            self._tensor(batch["points"][:cap]) if with_depth else None,
            self._tensor(batch["depths"][:cap]) if with_depth else None,
            self._bkgd(), self.sh_degree_at(self.step))
        return dict(zip(stats, torch.stack(list(stats.values())).tolist()))

    def train_chunk(self, staged: dict, n_steps: int, cam_idx=None) -> dict:
        """``n_steps`` steps over a staged split ("images" (C, H, W, 3),
        "viewmats", "Ks"; with ``depth_loss``, optionally "points" (C, M, 2),
        "point_depths" and "point_masks" (C, M) as tpugs stages them; the
        teacher runs on each step's image): cameras ``cam_idx``, or drawn
        from the trainer's generator. Returns each loss per step as a numpy
        array."""
        n_cams = staged["images"].shape[0]
        if cam_idx is None:
            cam_idx = self._rng.integers(0, n_cams, n_steps)
        images = self._tensor(staged["images"])
        viewmats = self._tensor(staged["viewmats"])
        Ks = self._tensor(staged["Ks"])
        with_depth = self.cfg.depth_loss and "points" in staged
        if with_depth:
            points = self._tensor(staged["points"])
            depths = self._tensor(staged["point_depths"])
            masks = self._tensor(staged["point_masks"]) > 0
        out = []
        for c in np.asarray(cam_idx, np.int64)[:n_steps]:
            image = images[c]
            feats = None
            if self.teacher is not None and self.scene.features is not None:
                feats = self.teacher(image).to(self.teacher_dtype)
            self._mark("teacher")
            pts = points[c][masks[c]] if with_depth else None
            dep = depths[c][masks[c]] if with_depth else None
            out.append(self._step_on(viewmats[c], Ks[c], image, feats, pts, dep,
                                     self._bkgd(), self.sh_degree_at(self.step)))
        keys = out[0].keys() if out else ()
        return {k: torch.stack([s[k] for s in out]).cpu().numpy() for k in keys}

    # ---------------------------------------------------------------- eval
    def render_eval(self, viewmat, K, sh_degree: Optional[int] = None):
        """RGB render (image (H, W, 3), alpha (H, W)) through kernel B4: with
        the "tiled" engine through ``rasterize_with_plan``, else at the
        train tile and early exit (``render_scene``)."""
        viewmat, K = self._tensor(viewmat), self._tensor(K)
        if self.engine != "tiled":
            return render_scene(self.scene, viewmat, K, self.width, self.height, sh_degree,
                                self.proj_config, self.tile_size)
        deg = self.scene.sh_degree if sh_degree is None else sh_degree
        s = self.scene
        with torch.no_grad():
            plan = plan_render(s.means, s.quats, s.scales, s.opacities, viewmat, K, self.width,
                               self.height, self.proj_config, self.tile_config)
            return rasterize_with_plan(s.means, s.quats, s.scales, s.opacities, s.colors_all,
                                       viewmat, K, plan, sh_degree=deg)

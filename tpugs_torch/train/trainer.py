"""Feature-3DGS trainer. Counterpart: ``tpugs/train/trainer.py``
(``knn_mean_dist``, ``rgb_to_sh``, ``init_scene_from_points``,
``init_scene_random`` :47-116; ``make_optimizer`` :119; ``_feature_l1``
:157; ``_rigid_inverse`` :187; ``Trainer`` :197 with the pose and
appearance modules :258-346, ``train_step`` :644, ``stage_dataset`` :742,
``train_chunk`` :857, ``refine`` :929, ``render_eval`` :957, ``evaluate``
and the files :986-1198).

Joint RGB + feature distillation: per step, the pose noise and learned pose
deltas on the camera, projection and SH on the scene's tensors (plus the
appearance module's colour), the exact per-view plan, the differentiable
render (``raster/train.py``: kernel B4 forward, B5 + B3 backward; with
``raster_engine="tiled"``, ``raster/tiled.py::render_tiled``, the same
kernels with no early exit at the ``TileConfig`` tile), L1 + SSIM, the
optional depth loss, the feature L1 against the teacher, and one Adam step
per parameter group (AdamW for the pose and appearance modules).
``train_chunk`` is a plain loop over steps: the reference's ``lax.scan``
and static size buckets have no counterpart, and nothing overflows because
plans are exact. The screen-gradient statistic comes from a zero
``offset2d`` probe added to the projected means (and the absgrad probe of
the render), as in the reference: no hooks.

Densification, as in the reference: ``train_step`` refines and resets the
opacities at its step's cadence; ``train_chunk`` does neither (the app does
both between chunks). A refine builds new leaf tensors (padded to
``capacity_multiple`` for "default") and a fresh optimizer over them, so
Adam's moments and step counts restart. The means' learning rate follows
optax's schedule count, which restarts with the optimizer: it is read from
the means' Adam step count, not from the trainer's step.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Callable, Optional

import numpy as np
import torch

from tpugs_torch.core.device import DeviceLike, resolve_device
from tpugs_torch.core.scene import GaussianScene, pad_count
from tpugs_torch.raster.api import plan_render, rasterize_with_plan
from tpugs_torch.raster.plan import build_plan
from tpugs_torch.raster.projection import Projected, ProjectionConfig, project, view_directions
from tpugs_torch.raster.sh import sh_to_color
from tpugs_torch.raster.tiled import TileConfig, render_tiled
from tpugs_torch.raster.train import render_plan_train, render_scene
from tpugs_torch.train.config import NOT_READ, TrainConfig, unread_settings
from tpugs_torch.train.lpips import lpips_distance, params_to
from tpugs_torch.train.metrics import psnr, ssim, ssim_loss
from tpugs_torch.train.modules import IDENTITY_POSE, AppearanceOptModule, pose_transform
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
    """The means' learning rate at update k since the optimizer's init:
    optax's ``exponential_decay(init, max_steps, 0.01)``, init = means_lr *
    scene scale * sqrt(batch)."""
    init = cfg.means_lr * scene_scale * float(np.sqrt(batch_size))
    return init * 0.01 ** (k / cfg.max_steps)


def make_optimizer(cfg: TrainConfig, scene: GaussianScene, scene_scale: float = 1.0,
                   batch_size: int = 1) -> torch.optim.Adam:
    """One Adam group per scene field (named by the reference's label),
    eps 1e-15, lr * sqrt(batch). The means group starts at
    ``means_lr(..., 0)``; the trainer sets it before every step from the
    group's Adam step count."""
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




def _rigid_inverse(m: torch.Tensor) -> torch.Tensor:
    """Inverse of a rigid 4x4 [R t; 0 1] (viewmat <-> camtoworld)."""
    rt = m[:3, :3].T
    top = torch.cat([rt, (-rt @ m[:3, 3])[:, None]], dim=1)
    return torch.cat([top, m.new_tensor([[0.0, 0.0, 0.0, 1.0]])])


def _leaves(scene: GaussianScene, device: torch.device) -> GaussianScene:
    """The scene's tensors as fresh optimisable leaves on ``device``."""
    return GaussianScene(**{
        f.name: None if getattr(scene, f.name) is None
        else getattr(scene, f.name).detach().to(device).clone().requires_grad_()
        for f in dataclasses.fields(scene)
    })


def _put_optimizer(flat: dict, prefix: str, opt: torch.optim.Optimizer) -> None:
    """An optimizer's ``state_dict`` as npz entries: its groups as JSON, each
    state tensor as an array."""
    sd = opt.state_dict()
    flat[f"{prefix}.groups"] = np.frombuffer(json.dumps(sd["param_groups"]).encode(), np.uint8)
    for idx, st in sd["state"].items():
        for k, v in st.items():
            flat[f"{prefix}.state.{idx}.{k}"] = torch.as_tensor(v).detach().cpu().numpy()


def _get_optimizer(data, prefix: str, opt: torch.optim.Optimizer) -> None:
    state: dict = {}
    for key in data.files:
        if key.startswith(f"{prefix}.state."):
            idx, k = key[len(prefix) + 7:].split(".", 1)
            state.setdefault(int(idx), {})[k] = torch.from_numpy(data[key])
    groups = json.loads(data[f"{prefix}.groups"].tobytes().decode())
    opt.load_state_dict({"state": state, "param_groups": groups})


class Trainer:
    """Single-device trainer on ``device`` (default CUDA; ``device="cpu"``
    runs the kernels' plain twins). The scene's tensors become the
    optimised leaves. ``lpips_params`` (``train/lpips.py``'s tree) make
    ``evaluate`` report LPIPS. ``on_stage(name)``, if set, is called at the
    end of each of ``STAGES`` within a step (for timing; "teacher" only in
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
        lpips_params: Optional[dict] = None,
        device: DeviceLike = "cuda",
    ):
        self.device = resolve_device(device)
        if cfg.raster_engine not in ("auto", "pallas", "tiled"):
            raise ValueError(f"unknown raster_engine {cfg.raster_engine!r} "
                             "(expected auto|pallas|tiled)")
        unread = unread_settings(cfg)
        if unread:
            raise NotImplementedError("not read by the port: " + ", ".join(
                f"TrainConfig.{k} ({NOT_READ[k]})" for k in unread))
        self.cfg = cfg
        self.scene = _leaves(scene, self.device)
        self.scene_scale = scene_scale
        self.teacher = teacher
        self.teacher_dtype = getattr(torch, cfg.teacher_dtype)
        self.width = width
        self.height = height
        self.n_cameras = n_cameras
        self.lpips_params = None if lpips_params is None else params_to(lpips_params, self.device)
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
        self._tb = None
        self._rng = np.random.default_rng(cfg.seed + 7)
        self.on_stage: Optional[Callable[[str], None]] = None
        self.record: Optional[dict] = None
        self._init_pose_app()

    # -------------------------------------------------- pose / appearance
    def _init_pose_app(self):
        """Pose deltas (AdamW at pose_opt_lr * sqrt(BS), weight decay
        pose_opt_reg), the fixed pose noise (``default_rng(seed + 11)``) and
        the appearance module (AdamW: embeds at 10x the head's rate with
        weight decay app_opt_reg, the head without), whose output head
        starts at zero. torch's AdamW defaults differ from optax's, so every
        setting is passed."""
        cfg, n, dev = self.cfg, self.n_cameras, self.device
        bs = float(np.sqrt(cfg.batch_size))
        self.pose_params = self.pose_optimizer = self.pose_perturb = None
        self.app_module = self.app_optimizer = None
        if cfg.pose_opt and n > 0:
            self.pose_params = torch.tensor(IDENTITY_POSE, device=dev).repeat(n, 1)
            self.pose_params.requires_grad_()
            self.pose_optimizer = torch.optim.AdamW(
                [self.pose_params], lr=cfg.pose_opt_lr * bs, betas=(0.9, 0.999), eps=1e-8,
                weight_decay=cfg.pose_opt_reg)
        if cfg.pose_noise > 0.0 and n > 0:
            rng = np.random.default_rng(cfg.seed + 11)
            noise = rng.normal(0, cfg.pose_noise, (n, 9)).astype(np.float32)
            noise[:, :6] += np.array([1, 0, 0, 0, 1, 0], np.float32)
            self.pose_perturb = torch.from_numpy(noise).to(dev)
        if cfg.app_opt and n > 0 and self.scene.features is not None:
            gen = torch.Generator().manual_seed(cfg.seed + 13)
            self.app_module = AppearanceOptModule(
                n, self.scene.features.shape[-1], cfg.app_embed_dim, cfg.sh_degree,
                device="cpu", generator=gen).to(dev)
            with torch.no_grad():
                self.app_module.out.weight.zero_()
                self.app_module.out.bias.zero_()
            head = [p for name, p in self.app_module.named_parameters() if name != "embeds"]
            self.app_optimizer = torch.optim.AdamW([
                {"params": [self.app_module.embeds], "lr": cfg.app_opt_lr * bs * 10.0,
                 "weight_decay": cfg.app_opt_reg, "name": "embeds"},
                {"params": head, "lr": cfg.app_opt_lr * bs, "weight_decay": 0.0,
                 "name": "head"},
            ], betas=(0.9, 0.999), eps=1e-8)

    def module_state(self):
        """(pose params, pose optimizer, appearance module, its optimizer);
        entries are None when the module is disabled."""
        return self.pose_params, self.pose_optimizer, self.app_module, self.app_optimizer

    def set_module_state(self, modules) -> None:
        """Write back a ``module_state`` 4-tuple."""
        self.pose_params, self.pose_optimizer, self.app_module, self.app_optimizer = modules

    # ------------------------------------------------------- observability
    def enable_tensorboard(self, log_dir: str):
        """Scalar logging through torch's SummaryWriter (host-side)."""
        from torch.utils.tensorboard import SummaryWriter

        self._tb = SummaryWriter(log_dir=log_dir)
        return self._tb

    def log_scalars(self, stats: dict, step: Optional[int] = None) -> None:
        if self._tb is None:
            return
        step = self.step if step is None else step
        for k, v in stats.items():
            if np.isscalar(v) or getattr(v, "ndim", 1) == 0:
                self._tb.add_scalar(f"train/{k}", float(v), step)
        self._tb.add_scalar("train/num_GS", self.scene.num_gaussians, step)

    def _mark(self, name: str) -> None:
        if self.on_stage is not None:
            self.on_stage(name)

    def _tensor(self, x, dtype=torch.float32) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x) if not torch.is_tensor(x) else x,
                               dtype=dtype).to(self.device)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _detached(self) -> GaussianScene:
        return GaussianScene(**{f.name: None if getattr(self.scene, f.name) is None
                                else getattr(self.scene, f.name).detach()
                                for f in dataclasses.fields(self.scene)})

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

    def _view_inputs(self, scene: GaussianScene, probes: dict, viewmat, K, cam_id,
                     sh_degree: int):
        """The camera after the pose noise and the learned pose deltas (both
        on camtoworld), projection with the offset probe, validity-masked
        opacities and the rendered channels [SH colour (+ appearance) |
        depth | features]."""
        if self.pose_perturb is not None or self.pose_params is not None:
            c2w = _rigid_inverse(viewmat)
            if self.pose_perturb is not None:
                c2w = c2w @ pose_transform(self.pose_perturb[cam_id])
            if self.pose_params is not None:
                c2w = c2w @ pose_transform(self.pose_params[cam_id])
            viewmat = _rigid_inverse(c2w)
        proj = project(scene.means, scene.quats, scene.scales, scene.opacities, viewmat, K,
                       self.width, self.height, self.proj_config)
        proj = proj._replace(means2d=proj.means2d + probes["off"])
        opac = torch.where(proj.valid, proj.opacities, torch.zeros_like(proj.opacities))
        dirs = view_directions(scene.means, viewmat)
        colors = sh_to_color(scene.colors_all, dirs, sh_degree)
        if self.app_module is not None:
            colors = colors + self.app_module(scene.features, cam_id, dirs)
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
                 teacher_feats, points, point_depths, bkgd, sh_degree: int, cam_id=0):
        """(loss, aux) of one view of camera ``cam_id`` at ``scene``;
        differentiable in the scene's tensors, the probes and the pose and
        appearance parameters."""
        proj, opac, allc = self._view_inputs(scene, probes, viewmat, K, cam_id, sh_degree)
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

    def _module_optimizers(self):
        return [o for o in (self.pose_optimizer, self.app_optimizer) if o is not None]

    def _group(self, name: str) -> dict:
        return next(g for g in self.optimizer.param_groups if g["name"] == name)

    def means_step_count(self) -> int:
        """Updates of the means since the optimizer's init: optax's schedule
        count, which a refine restarts."""
        st = self.optimizer.state.get(self._group("means")["params"][0])
        return int(st["step"]) if st else 0

    def _step_on(self, viewmat, K, image, teacher_feats, points, point_depths, bkgd,
                 sh_degree: int, cam_id=0) -> dict:
        """One step on device tensors: loss, gradients, Adam updates; the
        grad2d statistic (NDC units) goes to ``grad_state`` when a
        strategy is set. Returns the step's scalar tensors; the step count
        is the caller's."""
        n = self.scene.num_gaussians
        probes = self._zero_probes(n)
        loss, aux = self._loss_fn(self.scene, probes, viewmat, K, image, teacher_feats,
                                  points, point_depths, bkgd, sh_degree, cam_id)
        params = self._params()
        modules = [p for o in self._module_optimizers() for g in o.param_groups
                   for p in g["params"]]
        live = [probes["off"]] + ([probes["abs"]] if probes["abs"] is not None else [])
        grads = torch.autograd.grad(loss, params + modules + live, allow_unused=True)
        self._mark("chain backward")
        for p, g in zip(params + modules, grads):
            p.grad = torch.zeros_like(p) if g is None else g
        gprobes = dict(zip(("off", "abs"), grads[len(params) + len(modules):]))
        self._group("means")["lr"] = means_lr(self.cfg, self.scene_scale, self.cfg.batch_size,
                                              self.means_step_count())
        self.optimizer.step()
        for opt in self._module_optimizers():
            opt.step()
        self._mark("optimizer")
        if self.strategy is not None:
            ndc = torch.tensor([self.width / 2.0, self.height / 2.0], device=self.device)
            grad2d = torch.linalg.vector_norm(self._grow_stat(gprobes) * ndc, dim=1)
            self.grad_state.accumulate(grad2d, aux["visible"])
        return {"loss": loss.detach(), **{k: aux[k].detach() for k in
                                          ("l1", "ssim_loss", "feature_l1", "depth_l")}}

    def _bkgd(self) -> torch.Tensor:
        bg = (self._rng.uniform(0, 1, 3).astype(np.float32) if self.cfg.random_bkgd
              else np.zeros(3, np.float32))
        return torch.from_numpy(bg).to(self.device)

    def sh_degree_at(self, step: int) -> int:
        return min(step // self.cfg.sh_degree_interval, self.cfg.sh_degree)

    def train_step(self, batch: dict, teacher_feats=None) -> dict:
        """One step on ``batch`` ("viewmat", "K", "image" (H, W, 3), optional
        "image_id" (the pose and appearance index, default 0) and, with
        ``depth_loss``, "points" (M, 2) and "depths" (M,), of which the
        first ``DEPTH_POINTS`` are used); then, with a strategy, the refine
        and the opacity reset due at this step. Returns the step's losses
        as floats."""
        cfg = self.cfg
        with_depth = cfg.depth_loss and "points" in batch
        cap = DEPTH_POINTS
        stats = self._step_on(
            self._tensor(batch["viewmat"]), self._tensor(batch["K"]),
            self._tensor(batch["image"]),
            None if teacher_feats is None else self._tensor(teacher_feats, self.teacher_dtype),
            self._tensor(batch["points"][:cap]) if with_depth else None,
            self._tensor(batch["depths"][:cap]) if with_depth else None,
            self._bkgd(), self.sh_degree_at(self.step), int(batch.get("image_id", 0)))
        if self.strategy is not None:
            if (cfg.refine_start_iter <= self.step < cfg.refine_stop_iter
                    and self.step % cfg.refine_every == 0 and self.step > 0):
                self.refine()
            if (self.step > 0 and cfg.reset_every > 0 and self.step % cfg.reset_every == 0
                    # gsplat stops all maintenance, resets included, at
                    # refine_stop_iter
                    and self.step < cfg.refine_stop_iter):
                self.reset_opacities()
        self.step += 1
        out = dict(zip(stats, torch.stack(list(stats.values())).tolist()))
        if self._tb is not None and self.step % cfg.tb_every == 0:
            self.log_scalars(out)
        return out

    # ------------------------------------------------------ chunked steps
    def stage_dataset(self, dataset) -> dict:
        """A whole split as device tensors: "images" (C, H, W, 3),
        "viewmats", "Ks", "image_ids" and, with ``depth_loss``, the first
        4096 depth points of each view padded with masks ("points",
        "point_depths", "point_masks"), as tpugs stages them."""
        imgs, vms, Ks, ids = [], [], [], []
        pts, deps, masks = [], [], []
        cap = DEPTH_POINTS
        for i in range(len(dataset)):
            d = dataset[i]
            imgs.append(self._tensor(d["image"]))
            vms.append(self._tensor(d["viewmat"]))
            Ks.append(self._tensor(d["K"]))
            ids.append(int(d.get("image_id", i)))
            if self.cfg.depth_loss and "points" in d:
                p = np.zeros((cap, 2), np.float32)
                z = np.ones((cap,), np.float32)
                m = np.zeros((cap,), np.float32)
                k = min(cap, len(d["points"]))
                p[:k] = np.asarray(d["points"])[:k]
                z[:k] = np.asarray(d["depths"])[:k]
                m[:k] = 1.0
                pts.append(p)
                deps.append(z)
                masks.append(m)
        staged = {"images": torch.stack(imgs), "viewmats": torch.stack(vms),
                  "Ks": torch.stack(Ks),
                  "image_ids": torch.tensor(ids, dtype=torch.int64, device=self.device)}
        if pts:
            staged["points"] = self._tensor(np.stack(pts))
            staged["point_depths"] = self._tensor(np.stack(deps))
            staged["point_masks"] = self._tensor(np.stack(masks))
        return staged

    def train_chunk(self, staged: dict, n_steps: int, cam_idx=None) -> dict:
        """``n_steps`` steps over a staged split (``stage_dataset``'s keys;
        "image_ids" defaults to the camera's index; the teacher runs on each
        step's image): cameras ``cam_idx``, or drawn from the trainer's
        generator. No refine and no opacity reset, as in tpugs: the app
        runs both between chunks. Returns each loss per step as a numpy
        array."""
        n_cams = staged["images"].shape[0]
        if cam_idx is None:
            cam_idx = self._rng.integers(0, n_cams, n_steps)
        images = self._tensor(staged["images"])
        viewmats = self._tensor(staged["viewmats"])
        Ks = self._tensor(staged["Ks"])
        ids = staged.get("image_ids")
        ids = list(range(n_cams)) if ids is None else torch.as_tensor(ids).tolist()
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
                                     self._bkgd(), self.sh_degree_at(self.step), ids[c]))
            self.step += 1
        keys = out[0].keys() if out else ()
        res = {k: torch.stack([s[k] for s in out]).cpu().numpy() for k in keys}
        if self._tb is not None:
            self.log_scalars({k: float(v[-1]) for k, v in res.items()}, self.step)
        return res

    # -------------------------------------------------------- densification
    def _reset_opt_group(self, label: str) -> None:
        """Clear one group's state (moments and step count), as a fresh
        optax init of that group does."""
        for p in self._group(label)["params"]:
            self.optimizer.state.pop(p, None)

    def reset_opacities(self) -> None:
        """The strategy's opacity reset, then a fresh state for the
        opacities' Adam group (gsplat zeroes its moments: stale second
        moments would let the opacities rebound)."""
        new = self.strategy.reset_opacities(self._detached())
        with torch.no_grad():
            self.scene.logit_opacities.copy_(new.logit_opacities)
        self._reset_opt_group("opacities")

    def refine(self) -> dict:
        """One refine of the strategy on ``grad_state``: new leaf tensors
        (for "default", padded with transparent rows to a multiple of
        ``capacity_multiple`` when it is set), a zero ``GradState`` and a
        fresh optimizer over the new leaves. Returns the strategy's info
        plus "alive", the refined count before padding."""
        cfg = self.cfg
        new_scene, new_state, info = self.strategy.refine(self._detached(), self.grad_state)
        info["alive"] = new_scene.num_gaussians
        if cfg.capacity_multiple and cfg.strategy == "default":
            cap = pad_count(new_scene.num_gaussians, cfg.capacity_multiple)
            new_scene = new_scene.pad_to(cap)
            new_state = GradState.zeros(cap, self.device)
        self.scene, self.grad_state = _leaves(new_scene, self.device), new_state
        del new_scene
        self.optimizer = make_optimizer(cfg, self.scene, self.scene_scale, cfg.batch_size)
        return info

    # ---------------------------------------------------------------- eval
    def render_eval(self, viewmat, K, sh_degree: Optional[int] = None):
        """RGB render (image (H, W, 3), alpha (H, W)) through kernel B4: with
        the "tiled" engine through ``rasterize_with_plan``, else at the
        train tile and early exit (``render_scene``)."""
        viewmat, K = self._tensor(viewmat), self._tensor(K)
        s = self._detached()
        if self.engine != "tiled":
            return render_scene(s, viewmat, K, self.width, self.height, sh_degree,
                                self.proj_config, self.tile_size)
        deg = s.sh_degree if sh_degree is None else sh_degree
        with torch.no_grad():
            plan = plan_render(s.means, s.quats, s.scales, s.opacities, viewmat, K, self.width,
                               self.height, self.proj_config, self.tile_config)
            return rasterize_with_plan(s.means, s.quats, s.scales, s.opacities, s.colors_all,
                                       viewmat, K, plan, sh_degree=deg)

    def evaluate(self, dataset, max_images: Optional[int] = None) -> dict:
        """Mean PSNR, SSIM (and LPIPS with ``lpips_params``) of the clipped
        renders against the split's images; "ellipse_time" is the mean
        seconds per render, the device synchronised; the PNG compression
        eval when ``cfg.compression == "png"``."""
        psnrs, ssims, lpipses, times = [], [], [], []
        n = len(dataset) if max_images is None else min(max_images, len(dataset))
        for i in range(n):
            data = dataset[i]
            t0 = time.perf_counter()
            img, _ = self.render_eval(data["viewmat"], data["K"])
            img = torch.clamp(img, 0, 1)
            self._sync()
            times.append(time.perf_counter() - t0)
            gt = self._tensor(data["image"])
            psnrs.append(float(psnr(img, gt)))
            ssims.append(float(ssim(img, gt)))
            if self.lpips_params is not None:
                lpipses.append(float(lpips_distance(self.lpips_params, img, gt, self.device)))
        out = {
            "psnr": float(np.mean(psnrs)) if psnrs else 0.0,
            "ssim": float(np.mean(ssims)) if ssims else 0.0,
            "ellipse_time": float(np.mean(times)) if times else 0.0,
            "num_GS": self.scene.num_gaussians,
        }
        if lpipses:
            out["lpips"] = float(np.mean(lpipses))
        if self.cfg.compression == "png":
            out["compression"] = self.eval_compression(dataset, max_images=max_images)
        return out

    def _render_pair(self, restored: GaussianScene, viewmat, K):
        """Clipped renders of the scene and of ``restored`` at one view."""
        orig, _ = self.render_eval(viewmat, K)
        kept, self.scene = self.scene, restored
        try:
            rec, _ = self.render_eval(viewmat, K)
        finally:
            self.scene = kept
        return torch.clamp(rec, 0, 1), torch.clamp(orig, 0, 1)

    def eval_compression(self, dataset=None, max_images=None) -> dict:
        """PNG-compress the scene (``io/compression.py``) and report its
        size and the PSNR of the decompressed scene's renders against the
        scene's: over the split's views, or without one over a single
        synthetic view framing the scene."""
        import tempfile

        from tpugs_torch.io.compression import (
            compress_scene,
            compressed_size_bytes,
            decompress_scene,
        )

        with tempfile.TemporaryDirectory() as td:
            compress_scene(self._detached(), td)
            size = compressed_size_bytes(td)
            restored = decompress_scene(td, device=self.device)
        if dataset is not None and len(dataset):
            n = len(dataset) if max_images is None else min(max_images, len(dataset))
            vals = [float(psnr(*self._render_pair(restored, dataset[i]["viewmat"],
                                                  dataset[i]["K"]))) for i in range(n)]
            return {"compressed_bytes": int(size), "psnr_vs_uncompressed": float(np.mean(vals))}
        means = self.scene.means.detach().cpu().numpy()
        center = means.mean(axis=0)
        r = float(np.percentile(np.linalg.norm(means - center, axis=1), 90))
        vm = np.eye(4, dtype=np.float32)
        vm[:3, 3] = -center + np.array([0, 0, 2.5 * max(r, 1e-3)])
        f = 1.2 * max(self.width, self.height, 64)
        K = np.array([[f, 0, max(self.width, 64) / 2], [0, f, max(self.height, 64) / 2],
                      [0, 0, 1]], np.float32)
        return {"compressed_bytes": int(size),
                "psnr_vs_uncompressed": float(psnr(*self._render_pair(restored, vm, K)))}

    # ------------------------------------------------------------- outputs
    def save_checkpoint(self, path: str) -> None:
        """The scene as an npz in tpugs' layout (``io/checkpoints.py``); see
        ``save_checkpoint_full`` for the resumable state."""
        from tpugs_torch.io.checkpoints import save_scene_npz

        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        save_scene_npz(self.scene, path)

    def save_checkpoint_full(self, path: str) -> None:
        """Resumable checkpoint in the port's own npz layout: "step", the
        scene's fields ("scene.<field>"), the optimizer's ``state_dict``
        ("opt.*"), and where enabled the pose params and their optimizer
        ("pose", "pose_opt.*") and the appearance module's state dict and
        optimizer ("app.<name>", "app_opt.*")."""
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        flat = {"step": np.asarray(self.step)}
        for f in dataclasses.fields(self.scene):
            t = getattr(self.scene, f.name)
            if t is not None:
                flat[f"scene.{f.name}"] = t.detach().cpu().numpy()
        _put_optimizer(flat, "opt", self.optimizer)
        if self.pose_params is not None:
            flat["pose"] = self.pose_params.detach().cpu().numpy()
            _put_optimizer(flat, "pose_opt", self.pose_optimizer)
        if self.app_module is not None:
            for k, v in self.app_module.state_dict().items():
                flat[f"app.{k}"] = v.cpu().numpy()
            _put_optimizer(flat, "app_opt", self.app_optimizer)
        np.savez(path, **flat)

    def load_checkpoint_full(self, path: str) -> None:
        """Restore a ``save_checkpoint_full`` file, its N included (a
        checkpoint taken after densification restores its own size); the
        densification statistics restart at zero."""
        with np.load(path, allow_pickle=False) as data:
            self.step = int(data["step"])
            self.scene = _leaves(GaussianScene(**{
                f.name: torch.from_numpy(data[f"scene.{f.name}"])
                if f"scene.{f.name}" in data.files else None
                for f in dataclasses.fields(self.scene)}), self.device)
            self.optimizer = make_optimizer(self.cfg, self.scene, self.scene_scale,
                                            self.cfg.batch_size)
            _get_optimizer(data, "opt", self.optimizer)
            if self.pose_params is not None and "pose" in data.files:
                with torch.no_grad():
                    self.pose_params.copy_(torch.from_numpy(data["pose"]))
                _get_optimizer(data, "pose_opt", self.pose_optimizer)
            if self.app_module is not None and "app.embeds" in data.files:
                self.app_module.load_state_dict({
                    k: torch.from_numpy(data[f"app.{k}"])
                    for k in self.app_module.state_dict()})
                _get_optimizer(data, "app_opt", self.app_optimizer)
        self.grad_state = GradState.zeros(self.scene.num_gaussians, self.device)

    def save_stats(self, stats: dict, path: str) -> None:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as fh:
            json.dump(stats, fh)

    def render_traj(self, Ks, output_path: str, n_frames: int = 60):
        """Frames (uint8, host) of an ellipse orbit around the scene's
        centre; a GIF at ``output_path`` when it is not empty."""
        from tpugs_torch.train.traj import c2w_to_viewmat, generate_ellipse_path_z
        from tpugs_torch.viz.common import to_uint8
        from tpugs_torch.viz.gif import save_gif

        means = self.scene.means.detach().cpu().numpy()
        center = means.mean(axis=0)
        r = float(np.percentile(np.linalg.norm(means - center, axis=1), 90))
        t = np.linspace(0, 2 * np.pi, 8, endpoint=False)
        poses = np.stack([
            np.concatenate([np.eye(3), (center + 2.5 * r * np.array(
                [np.cos(a), -0.4, np.sin(a)]))[:, None]], axis=1)
            for a in t])
        path = generate_ellipse_path_z(poses, n_frames=n_frames)
        K = Ks[0] if Ks.ndim == 3 else Ks
        frames = [to_uint8(self.render_eval(c2w_to_viewmat(c2w), K)[0]) for c2w in path]
        if output_path:
            save_gif(frames, output_path)
        return frames

"""Sharded execution: the back-projection over many views and training with
sharded Gaussians. Counterpart: ``tpugs/dist/shard.py``
(``backproject_views_sharded`` and ``backproject_views_sharded_pallas``
:38-151, ``gather_scene`` :92, ``make_trainer_step_sharded`` and
``_sharded_step_parts`` :154-380, ``make_trainer_chunk_sharded`` :383,
``refine_sharded`` :481, ``make_sharded_train_step`` :508).

tpugs runs one program over a ``jax.sharding.Mesh`` (``shard_map``, whose
autodiff inserts the collectives). The port runs the same arithmetic in one
process per rank on ``torch.distributed`` (``dist/mesh.py``), each rank
holding its own shard:

* The lift: each rank lifts its contiguous block of C/world cameras (in
  the mesh's row-major rank order) through ``lift/batch.py::
  backproject_views``; the (num | den) sums are all-reduced over every axis
  but the last and reduce-scattered over the last ("gauss"), so each rank
  keeps its contiguous block of N/gauss_n Gaussians (tpugs' ``P("gauss")``,
  not the reference's ``points[rank::world]`` stride). One engine: the
  kernels on CUDA, their twins on the CPU; tpugs' ``sizes`` have no
  counterpart because the port's plans are exact.
* Training: the Gaussians and their optimizer state are sharded over
  "gauss", the cameras are data-parallel over "cam". Each rank projects its
  own shard and all-gathers the projected rows over "gauss" (gsplat's
  ``distributed=True``); the gather's backward is a reduce-scatter sum
  (``_GatherRows``). Gradients are summed over "cam" (the DDP all-reduce);
  the inputs that every gauss rank holds whole (``feature_proj``, the pose
  and appearance modules) are summed over "gauss" as well.

Every rank makes every collective, in the same order. Where tpugs counts
the regularisers once per camera shard (its cam psum adds ``cam_n`` copies
of each shard's sum), the port divides them by ``cam_n``, so that every
mesh gives the (1, 1) mesh's loss.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from tpugs_torch.core.scene import GaussianScene
from tpugs_torch.dist.mesh import axis_size, block, flat_index, make_mesh, mesh_device
from tpugs_torch.lift.batch import DEFAULT_TILE, backproject_views
from tpugs_torch.raster.kernels import TRANS_EPS
from tpugs_torch.raster.projection import Projected, ProjectionConfig

# Columns of one projected row in the exchange, before the rendered channels.
_PROJ_COLS = (("means2d", 2), ("conics", 3), ("depths", 1), ("radii", 1), ("opacities", 1),
              ("valid", 1), ("cut_r2", 1), ("sig_cut", 1))


def _reduce_scatter(out: torch.Tensor, x: torch.Tensor, group) -> None:
    """``reduce_scatter_tensor`` (sum), without the FutureWarning that newer
    torch prints for it: the replacement it names is not in older ones."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", FutureWarning)
        dist.reduce_scatter_tensor(out, x, group=group)


def _all_gather(out: torch.Tensor, x: torch.Tensor, group) -> None:
    """``all_gather_into_tensor``, without that FutureWarning either."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", FutureWarning)
        dist.all_gather_into_tensor(out, x, group=group)


class _GatherRows(torch.autograd.Function):
    """All-gather of row blocks over ``group`` (rank order); its backward
    reduce-scatters the summed cotangent, so each rank gets its own rows'
    gradient summed over the group."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        k = dist.get_world_size(group)
        out = x.new_empty((k * x.shape[0], *x.shape[1:]))
        _all_gather(out, x.contiguous(), group)
        return out

    @staticmethod
    def backward(ctx, grad):
        k = dist.get_world_size(ctx.group)
        out = grad.new_empty((grad.shape[0] // k, *grad.shape[1:]))
        _reduce_scatter(out, grad.contiguous(), ctx.group)
        return out, None


def gather_rows(x: torch.Tensor, group) -> torch.Tensor:
    """Differentiable all-gather of ``x``'s rows over ``group``."""
    return _GatherRows.apply(x, group)


def _all_reduce_many(tensors: Sequence[torch.Tensor], group) -> List[torch.Tensor]:
    """Sum each tensor over ``group`` in one collective (outside autograd)."""
    flat = torch.cat([t.detach().reshape(-1).float() for t in tensors])
    dist.all_reduce(flat, group=group)
    out, at = [], 0
    for t in tensors:
        out.append(flat[at:at + t.numel()].view(t.shape))
        at += t.numel()
    return out


def backproject_views_sharded(
    scene: GaussianScene,
    viewmats: torch.Tensor,  # (C, 4, 4); C divisible by the mesh size (pad_cameras)
    Ks: torch.Tensor,  # (C, 3, 3)
    cam_weights: torch.Tensor,  # (C,)
    width: int,
    height: int,
    encoder,
    mesh: Optional[DeviceMesh] = None,
    proj_config: ProjectionConfig = ProjectionConfig(),
    tile_size: int = DEFAULT_TILE,
    reduce_engine: str = "pallas",
    contrib_dtype: torch.dtype = torch.bfloat16,
    trans_eps: float = TRANS_EPS,
    on_stage: Optional[Callable[[str], None]] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """All-view back-projection over the mesh (default ``make_mesh()``: the
    default group on CUDA). Every rank passes the same scene and cameras;
    rank ``flat_index`` lifts cameras ``[i C/world, (i+1) C/world)`` with
    ``backproject_views`` (the arguments after ``mesh`` are its own), then
    (num | den) is summed over the other axes and reduce-scattered over the
    last. Returns this rank's (num (N/g, D), den (N/g,)): Gaussians
    ``[j N/g, (j+1) N/g)`` for its coordinate j on the last axis of size g,
    which must divide N. ``on_stage`` also gets "collectives"."""
    mesh = make_mesh() if mesh is None else mesh
    names = mesh.mesh_dim_names
    gauss_n = axis_size(mesh, names[-1])
    n, c, world = scene.num_gaussians, viewmats.shape[0], mesh.size()
    if n % gauss_n:
        raise ValueError(f"N = {n} does not split over {gauss_n} ranks on {names[-1]!r}")
    if c % world:
        raise ValueError(f"{c} cameras do not split over {world} ranks: pad_cameras first")
    i = flat_index(mesh)
    num, den = backproject_views(
        scene, block(viewmats, i, world), block(Ks, i, world), width, height, encoder,
        tile_size, contrib_dtype, proj_config, trans_eps, mesh_device(mesh), on_stage,
        reduce_engine, block(torch.as_tensor(cam_weights), i, world))
    sums = torch.cat([num, den[:, None]], dim=1)
    del num, den
    for name in names[:-1]:
        dist.all_reduce(sums, group=mesh.get_group(name))
    out = sums.new_empty((n // gauss_n, sums.shape[1]))
    _reduce_scatter(out, sums, mesh.get_group(names[-1]))
    if on_stage is not None:
        on_stage("collectives")
    return out[:, :-1], out[:, -1]


def gather_scene(shard: GaussianScene, group) -> GaussianScene:
    """Every per-Gaussian field all-gathered over ``group`` (differentiable);
    ``feature_proj`` is shared, not per Gaussian, and stays the local one."""
    return GaussianScene(**{
        f.name: None if getattr(shard, f.name) is None
        else getattr(shard, f.name) if f.name == "feature_proj"
        else gather_rows(getattr(shard, f.name), group)
        for f in dataclasses.fields(shard)})


def shard_scene(scene: GaussianScene, mesh: DeviceMesh) -> GaussianScene:
    """This rank's block of the per-Gaussian fields (its coordinate on the
    mesh's last axis); ``feature_proj`` whole."""
    gauss = mesh.mesh_dim_names[-1]
    j, g = mesh.get_local_rank(gauss), axis_size(mesh, gauss)
    return GaussianScene(**{
        f.name: None if getattr(scene, f.name) is None
        else getattr(scene, f.name) if f.name == "feature_proj"
        else block(getattr(scene, f.name), j, g)
        for f in dataclasses.fields(scene)})


def shard_trainer(trainer, mesh: DeviceMesh) -> None:
    """Make ``trainer`` hold this rank's shard of its scene: the block's
    leaves, a zero ``GradState`` of the block's length and a fresh optimizer
    (``make_optimizer``'s groups) over them. Pose and appearance stay whole
    (replicated)."""
    from tpugs_torch.train.strategy import GradState
    from tpugs_torch.train.trainer import _leaves, make_optimizer

    shard = shard_scene(trainer._detached(), mesh)
    trainer.scene = _leaves(shard, trainer.device)
    trainer.grad_state = GradState.zeros(shard.num_gaussians, trainer.device)
    trainer.optimizer = make_optimizer(trainer.cfg, trainer.scene, trainer.scene_scale,
                                       trainer.cfg.batch_size)


def _pack_rows(proj: Projected, opac, allc, abs_probe) -> torch.Tensor:
    """One (n, 11 + D [+ 2]) float row per Gaussian: the projection, the
    masked opacity, the rendered channels and the absgrad probe."""
    cols = [getattr(proj, name).float().reshape(proj.means2d.shape[0], k)
            for name, k in _PROJ_COLS]
    cols += [opac[:, None], allc] + ([] if abs_probe is None else [abs_probe])
    return torch.cat(cols, dim=1)


def _unpack_rows(rows: torch.Tensor, d: int, with_abs: bool):
    at, parts = 0, {}
    for name, k in _PROJ_COLS:
        parts[name] = rows[:, at] if k == 1 else rows[:, at:at + k]
        at += k
    parts["valid"] = parts["valid"] > 0.5
    opac, allc = rows[:, at], rows[:, at + 1:at + 1 + d]
    abs_g = rows[:, at + 1 + d:at + 3 + d] if with_abs else None
    return Projected(**parts), opac, allc, abs_g


def _set_means_lr(trainer, opt) -> None:
    """The means' learning rate from their Adam step count, as ``_step_on``
    sets it, where ``opt`` has a "means" group (``make_optimizer``)."""
    from tpugs_torch.train.trainer import means_lr

    for g in opt.param_groups:
        if g.get("name") == "means":
            st = opt.state.get(g["params"][0])
            k = int(st["step"]) if st else 0
            g["lr"] = means_lr(trainer.cfg, trainer.scene_scale, trainer.cfg.batch_size, k)


def make_trainer_step_sharded(trainer, mesh: Optional[DeviceMesh] = None, batch_size: int = 1,
                              exchange_rows: int = 0):
    """The sharded train step with the trainer's loss (L1 + SSIM, the
    feature L1 through ``feature_proj``, the regularisers), its pose and
    appearance modules and any optimizer (default mesh ``make_mesh()``).
    Returns ``step(scene_shard, opt, modules, viewmats, Ks, images,
    teachers, bkgds, cam_ids) -> (scene_shard, opt, modules, loss, grad2d,
    vis, xover)`` on this rank's LOCAL batch of ``batch_size / cam_n``
    cameras:

    * ``scene_shard``: GaussianScene of leaf tensors, this rank's block of
      N/gauss_n Gaussians (``shard_trainer``/``shard_scene``); ``opt`` an
      optimizer over them, stepped in place (a "means" group gets its
      learning rate from its Adam step count, as ``Trainer._step_on``);
    * ``modules``: ``trainer.module_state()``, replicated on every rank,
      stepped in place with their gradients summed over both axes;
    * ``teachers`` (b, H, W, D_out), taken as given (cast them to the
      trainer's ``teacher_dtype`` first for ``_step_on``'s numbers); any
      placeholder without a feature field; ``cam_ids`` index the pose and
      appearance modules;
    * ``loss``: the batch mean, the same on every rank; ``grad2d`` (N/g,)
      the screen-gradient norm in NDC units and ``vis`` (N/g,) the views
      that saw each Gaussian, summed over the batch; ``xover`` the real rows
      that ``exchange_rows`` dropped.

    ``exchange_rows`` > 0 exchanges each shard's frustum survivors only,
    compacted (stable) to that many rows per view; ``xover`` counts those
    beyond it. The SH degree is ``cfg.sh_degree``."""
    mesh = make_mesh() if mesh is None else mesh
    if mesh_device(mesh).type != trainer.device.type:
        raise ValueError(f"a {mesh.device_type} mesh for a trainer on {trainer.device}")
    names = mesh.mesh_dim_names
    cam_axis, gauss_axis = names[0], names[-1]
    cam_n, gauss_n = axis_size(mesh, cam_axis), axis_size(mesh, gauss_axis)
    if batch_size % cam_n:
        raise ValueError(f"batch {batch_size} does not split over {cam_n} camera ranks")
    cam_group, gauss_group = mesh.get_group(cam_axis), mesh.get_group(gauss_axis)
    cfg = trainer.cfg
    ndc = torch.tensor([trainer.width / 2.0, trainer.height / 2.0], device=trainer.device)

    def step(scene_shard, opt, modules, viewmats, Ks, images, teachers, bkgds, cam_ids):
        trainer.set_module_state(modules)
        n_local = scene_shard.num_gaussians
        n = n_local * gauss_n
        cap = min(exchange_rows, n_local) if exchange_rows > 0 else 0
        feat_dim = None if scene_shard.features is None else scene_shard.features.shape[-1]
        probes = trainer._zero_probes(n_local)
        zero = torch.zeros((), device=trainer.device)
        loss, vis, xover = zero, torch.zeros((n_local,), device=trainer.device), zero
        for b, cam_id in enumerate(torch.as_tensor(cam_ids).tolist()):
            proj, opac, allc = trainer._view_inputs(scene_shard, probes, viewmats[b], Ks[b],
                                                    cam_id, cfg.sh_degree)
            rows = _pack_rows(proj, opac, allc, probes["abs"])
            if cap:
                keep = torch.argsort((~proj.valid).to(torch.uint8), stable=True)[:cap]
                xover = xover + torch.clamp(proj.valid.sum() - cap, min=0).float()
                rows = rows[keep]
            proj_g, opac_g, allc_g, abs_g = _unpack_rows(gather_rows(rows, gauss_group),
                                                         allc.shape[1], probes["abs"] is not None)
            l, _ = trainer._loss_from_projected(
                proj_g, opac_g, allc_g, abs_g, images[b],
                teachers[b] if feat_dim is not None else None, None, None, bkgds[b],
                scene_shard.feature_proj, feat_dim)
            # every gauss rank renders the same loss: scaled by 1/gauss_n, the
            # gather's reduce-scatter sums its rows' cotangents back to one
            loss = loss + l / (batch_size * gauss_n)
            vis = vis + proj.valid.float()
        # the regularisers' global means: shard sums over N, once over the cameras
        if cfg.opacity_reg > 0:
            loss = loss + cfg.opacity_reg * torch.sum(scene_shard.opacities) / (n * cam_n)
        if cfg.scale_reg > 0:
            loss = loss + cfg.scale_reg * torch.sum(scene_shard.scales) / (
                n * scene_shard.scales.shape[-1] * cam_n)

        fields = [f.name for f in dataclasses.fields(scene_shard)
                  if getattr(scene_shard, f.name) is not None]
        params = [getattr(scene_shard, f) for f in fields]
        mods = [p for o in trainer._module_optimizers() for g in o.param_groups
                for p in g["params"]]
        live = [probes["off"]] + ([probes["abs"]] if probes["abs"] is not None else [])
        grads = torch.autograd.grad(loss, params + mods + live, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(params + mods + live,
                                                                         grads)]
        g_scene, g_mods = grads[:len(params)], grads[len(params):len(params) + len(mods)]
        g_probe = trainer._grow_stat(dict(zip(("off", "abs"), grads[len(params) + len(mods):])))
        # data parallelism over the cameras: sum everything (the DDP all-reduce)
        loss, xover, vis, g_probe, *rest = _all_reduce_many(
            [loss, xover, vis, g_probe] + g_scene + g_mods, cam_group)
        g_scene, g_mods = rest[:len(params)], rest[len(params):]
        if gauss_n > 1:
            # what no gather carries: each gauss rank holds 1/gauss_n of it
            proj_at = fields.index("feature_proj") if "feature_proj" in fields else None
            shared = [loss, xover] + g_mods + ([g_scene[proj_at]] if proj_at is not None else [])
            loss, xover, *rest = _all_reduce_many(shared, gauss_group)
            g_mods = rest[:len(g_mods)]
            if proj_at is not None:
                g_scene[proj_at] = rest[-1]
        grad2d = torch.linalg.vector_norm(g_probe * ndc, dim=1)
        for p, g in zip(params + mods, g_scene + g_mods):
            p.grad = g
        _set_means_lr(trainer, opt)
        opt.step()
        for o in trainer._module_optimizers():
            o.step()
        return scene_shard, opt, trainer.module_state(), loss, grad2d, vis, xover

    return step


def make_trainer_chunk_sharded(trainer, mesh: Optional[DeviceMesh] = None, batch_size: int = 1,
                               n_steps: int = 1, exchange_rows: int = 0):
    """``n_steps`` sharded steps over a staged split, as a loop of
    ``make_trainer_step_sharded``'s step. Returns ``chunk(scene_shard, opt,
    modules, staged, cam_sel) -> (scene_shard, opt, modules, stats)``:

    * ``staged``: this rank's block of ``Trainer.stage_dataset``'s dict
      (its camera coordinate's C_local cameras; plus "teachers" (C_local,
      H, W, D_out) with a feature field and optional "bkgds" (C_local, 3));
    * ``cam_sel`` (n_steps, batch_size): row s holds GLOBAL staged indices
      grouped by camera shard, rank i's ``batch_size/cam_n`` of them in
      ``[i C_local, (i+1) C_local)``, which the loop turns into local offsets;
    * ``stats``: "loss" per step (n_steps,), "grad2d" and "vis" summed over
      the steps (N/g,), "xover" summed."""
    mesh = make_mesh() if mesh is None else mesh
    step = make_trainer_step_sharded(trainer, mesh, batch_size, exchange_rows)
    cam_axis = mesh.mesh_dim_names[0]
    per_dev = batch_size // axis_size(mesh, cam_axis)
    i = mesh.get_local_rank(cam_axis)
    dev = mesh_device(mesh)

    def chunk(scene_shard, opt, modules, staged, cam_sel):
        c_local = staged["viewmats"].shape[0]
        sel = torch.as_tensor(np.asarray(cam_sel), dtype=torch.int64)
        loc = sel[:n_steps, i * per_dev:(i + 1) * per_dev] - i * c_local
        if loc.numel() and (int(loc.min()) < 0 or int(loc.max()) >= c_local):
            raise ValueError(f"cam_sel picks cameras outside camera shard {i}")
        losses, g2d, vis, xover = [], 0.0, 0.0, 0.0
        for s in range(n_steps):
            idx = loc[s].to(dev)
            teachers = (staged["teachers"][idx] if scene_shard.features is not None
                        else torch.zeros((per_dev, 1, 1, 1), device=dev))
            bkgds = (staged["bkgds"][idx] if "bkgds" in staged
                     else torch.zeros((per_dev, 3), device=dev))
            scene_shard, opt, modules, loss, grad2d, v, x = step(
                scene_shard, opt, modules, staged["viewmats"][idx], staged["Ks"][idx],
                staged["images"][idx], teachers, bkgds, staged["image_ids"][idx])
            losses.append(loss)
            g2d, vis, xover = g2d + grad2d, vis + v, xover + x
        stats = {"loss": torch.stack(losses), "grad2d": g2d, "vis": vis, "xover": xover}
        return scene_shard, opt, modules, stats

    return chunk


def refine_sharded(trainer, mesh: DeviceMesh) -> dict:
    """Densification of a sharded trainer (``shard_trainer``): the shards
    and the ``GradState`` all-gathered, the same ``Trainer.refine`` on every
    rank (its numpy draws, from the same seed in the same order, give every
    rank the same scene), padded with transparent rows to a multiple of the
    gauss axis; the trainer keeps this rank's block, a zero ``GradState`` and
    a fresh optimizer. Rebuild the step afterwards. Returns the refine's info
    (duplicated, split, pruned, alive)."""
    from tpugs_torch.train.strategy import GradState

    gauss = mesh.mesh_dim_names[-1]
    group, gauss_n = mesh.get_group(gauss), axis_size(mesh, gauss)
    with torch.no_grad():
        trainer.scene = gather_scene(trainer._detached(), group)
        trainer.grad_state = GradState(gather_rows(trainer.grad_state.grad2d_sum, group),
                                       gather_rows(trainer.grad_state.count, group))
    info = trainer.refine()
    n = trainer.scene.num_gaussians
    trainer.scene = trainer._detached().pad_to(-(-n // gauss_n) * gauss_n)
    shard_trainer(trainer, mesh)
    return info


def make_sharded_train_step(mesh: DeviceMesh, width: int, height: int, lr: float = 1e-3,
                            proj_config: ProjectionConfig = ProjectionConfig(),
                            tile_config=None):
    """A plain sharded train step, kept as a test oracle (tpugs' round-1
    step): L1 to the targets, SGD, the scene gathered whole over the gauss
    axis (``gather_scene``) and rendered with ``raster/tiled.py::
    render_tiled``. Returns ``step(scene_shard, viewmats, Ks, targets) ->
    (scene_shard, loss)`` on this rank's block of Gaussians and its camera
    shard; the gradients are averaged over "cam"."""
    from tpugs_torch.raster.plan import build_plan
    from tpugs_torch.raster.projection import project, view_directions
    from tpugs_torch.raster.sh import sh_to_color
    from tpugs_torch.raster.tiled import TileConfig, render_tiled

    tile_config = TileConfig() if tile_config is None else tile_config
    names = mesh.mesh_dim_names
    cam_n, gauss_n = axis_size(mesh, names[0]), axis_size(mesh, names[-1])
    cam_group, gauss_group = mesh.get_group(names[0]), mesh.get_group(names[-1])

    def render_one(scene, vm, K):
        proj = project(scene.means, scene.quats, scene.scales, scene.opacities, vm, K, width,
                       height, proj_config)
        with torch.no_grad():
            plan = build_plan(Projected(*(t.detach() for t in proj)), width, height,
                              tile_config.tile_size)
        opac = torch.where(proj.valid, proj.opacities, torch.zeros_like(proj.opacities))
        colors = sh_to_color(scene.colors_all, view_directions(scene.means, vm),
                             scene.sh_degree)
        return render_tiled(proj.means2d, proj.conics, opac, colors, plan, tile_config)[0]

    def step(scene_shard, viewmats, Ks, targets):
        fields = [f.name for f in dataclasses.fields(scene_shard)
                  if getattr(scene_shard, f.name) is not None]
        shard = scene_shard.replace(**{
            f: getattr(scene_shard, f).detach().requires_grad_() for f in fields})
        scene = gather_scene(shard, gauss_group)
        loss = sum(torch.mean(torch.abs(render_one(scene, viewmats[b], Ks[b]) - targets[b]))
                   for b in range(viewmats.shape[0])) / viewmats.shape[0]
        params = [getattr(shard, f) for f in fields]
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)]
        loss, *grads = _all_reduce_many([loss] + grads, cam_group)
        # the gather's reduce-scatter sums gauss_n copies of each cotangent
        new = {f: (p - lr * g / (cam_n * gauss_n)).detach()
               for f, p, g in zip(fields, params, grads)}
        return scene_shard.replace(**new), loss / cam_n

    return step

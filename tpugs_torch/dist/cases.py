"""The sharded programs' cases at tpugs' ``tests/test_dist.py`` sizes (128
Gaussians for the lift, the 96-point trainer of its
``_make_trainer_for_shard``, 48x32 pixels), as rank functions for
``spawn.run_ranks``: every rank builds the same inputs from seeds and
returns its results as arrays, which the CPU tests hold against each
other, the single-process lift and tpugs. They live here, not in a test
file, because a spawned rank imports the module of its function, and the
test modules import JAX.

``dist_cases`` runs the lift and pad_cameras on meshes (4, 1), (2, 2) and
(1, 4), the train step (SGD at lr 0.1, as tpugs' test uses ``optax.sgd``,
so that updates compare gradients) on the same meshes, its cases without
features, with pose and appearance, with the exchange cap, the chunk
against its steps, the refine cycle, the oracle step and the dry run; then
rank 0 leaves the shared group and runs the (1, 1) references on a group
of its own, with ``Trainer._step_on`` against the (1, 1) step and
``experiments/sharded_singlechip.py``.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

W, H = 48, 32
MESHES = ((4, 1), (2, 2), (1, 4))
B, C_STAGED, CHUNK_STEPS = 4, 8, 3
LR = 0.1


def lift_inputs(n: int = 128, n_cams: int = 8):
    from tpugs_torch.encoders.base import LinearRGBEncoder
    from tpugs_torch.utils.synthetic import orbit_cameras, random_scene

    scene = random_scene(n, seed=0, extent=0.8, scale_range=(0.02, 0.1), device="cpu")
    cams = orbit_cameras(n_cams, W, H, radius=2.5, device="cpu")
    return scene, cams, LinearRGBEncoder(4, device="cpu")


LIFT_KW = dict(tile_size=16, contrib_dtype=torch.float32, trans_eps=0.0)  # tpugs' tiled lift


def make_trainer(feature: bool = True, random_features: bool = False, **kw):
    """tpugs' ``_make_trainer_for_shard`` on the CPU; ``random_features``
    draws the features as its step test does (at the zero init the head's
    gradient is exactly zero)."""
    from tpugs_torch.train.config import TrainConfig
    from tpugs_torch.train.trainer import Trainer, init_scene_random

    cfg = TrainConfig(**{**dict(
        max_steps=10, init_num_pts=96, init_extent=0.6, sh_degree=1,
        feature_dim=8 if feature else 0, feature_out_dim=16 if feature else 0,
        strategy="none", reset_every=0, random_bkgd=False, batch_size=B, seed=5), **kw})
    scene = init_scene_random(cfg, device="cpu")
    if random_features:
        f_rng = np.random.default_rng(11)
        scene = scene.replace(features=torch.from_numpy(
            f_rng.normal(0, 0.3, tuple(scene.features.shape)).astype(np.float32)))
    return Trainer(cfg, scene, width=W, height=H, n_cameras=B, device="cpu")


def batch_inputs(seed: int = 0, n: int = B, feature: bool = True):
    """Cameras, images, teachers (a placeholder without features), zero
    backgrounds and camera ids of tpugs' step tests."""
    from tpugs_torch.utils.synthetic import orbit_cameras

    cams = orbit_cameras(n, W, H, radius=2.5, device="cpu")
    rng = np.random.default_rng(seed)
    images = torch.from_numpy(rng.uniform(0, 1, (n, H, W, 3)).astype(np.float32))
    teachers = (torch.from_numpy(rng.uniform(-1, 1, (n, H, W, 16)).astype(np.float32))
                if feature else torch.zeros((n, 1, 1, 1)))
    return (cams.viewmats, cams.Ks, images, teachers, torch.zeros((n, 3)),
            torch.arange(n))


def _sgd(trainer):
    """SGD everywhere: the updates are then -lr x the gradients."""
    trainer.optimizer = torch.optim.SGD(trainer._params(), lr=LR)
    if trainer.pose_params is not None:
        trainer.pose_optimizer = torch.optim.SGD([trainer.pose_params], lr=LR)
    if trainer.app_module is not None:
        trainer.app_optimizer = torch.optim.SGD(trainer.app_module.parameters(), lr=LR)


def _state(trainer) -> dict:
    from tpugs_torch.convert import scene_to_numpy

    # copies: the CPU tensors' numpy views would follow later in-place updates
    out = {f"scene.{k}": v.copy() for k, v in scene_to_numpy(trainer.scene).items()}
    if trainer.pose_params is not None:
        out["pose"] = trainer.pose_params.detach().numpy().copy()
    if trainer.app_module is not None:
        out.update({f"app.{k}": v.detach().numpy().copy()
                    for k, v in trainer.app_module.state_dict().items()})
    return out


def _local(mesh, inputs):
    """This rank's camera block of a batch's inputs."""
    from tpugs_torch.dist.mesh import axis_size, block

    cam = mesh.mesh_dim_names[0]
    i, c = mesh.get_local_rank(cam), axis_size(mesh, cam)
    return [block(x, i, c) for x in inputs]


def step_case(mesh, feature=True, random_features=False, exchange_rows=0, seed=0, **kw):
    """One SGD step of the sharded trainer at batch 4 on ``mesh``: the
    updated shard (and pose / appearance), loss, grad2d, vis and xover."""
    from tpugs_torch.dist.shard import make_trainer_step_sharded, shard_trainer

    tr = make_trainer(feature, random_features, **kw)
    if tr.pose_params is not None:
        p_rng = np.random.default_rng(7)  # non-trivial pose deltas
        with torch.no_grad():
            tr.pose_params += torch.from_numpy(
                p_rng.normal(0, 1e-3, tuple(tr.pose_params.shape)).astype(np.float32))
    shard_trainer(tr, mesh)
    _sgd(tr)
    step = make_trainer_step_sharded(tr, mesh, B, exchange_rows)
    _, _, modules, loss, grad2d, vis, xover = step(
        tr.scene, tr.optimizer, tr.module_state(),
        *_local(mesh, batch_inputs(seed, feature=feature)))
    tr.set_module_state(modules)
    return {**_state(tr), "loss": loss, "grad2d": grad2d, "vis": vis, "xover": xover}


def chunk_cases(mesh):
    """The chunk over 8 staged cameras for 3 steps, and the same steps one
    by one (tpugs' ``test_trainer_chunk_sharded_matches_stepwise``)."""
    from tpugs_torch.dist.mesh import axis_size, block
    from tpugs_torch.dist.shard import (
        make_trainer_chunk_sharded,
        make_trainer_step_sharded,
        shard_trainer,
    )

    vms, ks, images, teachers, bkgds, ids = batch_inputs(0, C_STAGED)
    cam = mesh.mesh_dim_names[0]
    i, c = mesh.get_local_rank(cam), axis_size(mesh, cam)
    c_local, per_dev = C_STAGED // c, B // c
    sel = np.stack([np.concatenate([
        np.random.default_rng(s + 100 * k).choice(c_local, per_dev, replace=False) + k * c_local
        for k in range(c)]) for s in range(CHUNK_STEPS)]).astype(np.int64)
    out = {}
    tr = make_trainer()
    shard_trainer(tr, mesh)
    _sgd(tr)
    staged = {"viewmats": vms, "Ks": ks, "images": images, "teachers": teachers,
              "image_ids": ids}
    staged = {k: block(v, i, c) for k, v in staged.items()}
    chunk = make_trainer_chunk_sharded(tr, mesh, B, CHUNK_STEPS)
    _, _, _, stats = chunk(tr.scene, tr.optimizer, tr.module_state(), staged, sel)
    out["chunk"] = {**_state(tr), **stats}
    tr = make_trainer()
    shard_trainer(tr, mesh)
    _sgd(tr)
    step = make_trainer_step_sharded(tr, mesh, B)
    losses = []
    for s in range(CHUNK_STEPS):
        idx = torch.from_numpy(sel[s, i * per_dev:(i + 1) * per_dev])
        loss = step(tr.scene, tr.optimizer, tr.module_state(), vms[idx], ks[idx], images[idx],
                    teachers[idx], bkgds[idx], ids[idx])[3]
        losses.append(loss)
    out["stepwise"] = {**_state(tr), "loss": torch.stack(losses)}
    return out


def refine_case(mesh):
    """tpugs' refine cycle: an SGD step, its statistics accumulated,
    ``refine_sharded`` (strategy "default", growth forced), the step rebuilt
    and taken with the trainer's fresh Adam. The refined shard, the info
    and the second step's loss (taken before its update)."""
    from tpugs_torch.dist.shard import make_trainer_step_sharded, refine_sharded, shard_trainer

    tr = make_trainer(feature=False, strategy="default", capacity_multiple=0,
                      grow_grad2d=1e-12)
    shard_trainer(tr, mesh)
    _sgd(tr)
    inputs = _local(mesh, batch_inputs(2, feature=False))
    step = make_trainer_step_sharded(tr, mesh, B)
    _, _, _, _, g2d, vis, _ = step(tr.scene, tr.optimizer, tr.module_state(), *inputs)
    tr.grad_state.accumulate(g2d, vis)
    info = refine_sharded(tr, mesh)
    refined = _state(tr)
    step = make_trainer_step_sharded(tr, mesh, B)
    loss2, g2d2 = step(tr.scene, tr.optimizer, tr.module_state(), *inputs)[3:5]
    return {**refined, "info": info, "loss2": loss2, "grad2d2": g2d2,
            "n_local": tr.scene.num_gaussians}


def oracle_case(mesh, steps: int = 3):
    """tpugs' round-1 oracle: ``make_sharded_train_step`` toward black
    targets (lr 5e-3)."""
    from tpugs_torch.dist.shard import make_sharded_train_step, shard_scene

    scene, cams, _ = lift_inputs(128, 4)
    step = make_sharded_train_step(mesh, W, H, lr=5e-3)
    s = shard_scene(scene, mesh)
    vms, ks, targets = _local(mesh, (cams.viewmats, cams.Ks, torch.zeros((4, H, W, 3))))
    losses = []
    for _ in range(steps):
        s, loss = step(s, vms, ks, targets)
        losses.append(loss)
    return {"loss": torch.stack(losses), "sh0": s.sh0, "sh0_before": shard_scene(scene, mesh).sh0}


def dist_cases(rank: int, world: int) -> dict:
    from tpugs_torch.dist.dryrun import dryrun_ranks
    from tpugs_torch.dist.mesh import make_mesh, pad_cameras
    from tpugs_torch.dist.shard import backproject_views_sharded

    out = {"coords": {}, "errors": {}}
    scene, cams, enc = lift_inputs()
    for shape in MESHES:
        mesh = make_mesh(shape, device="cpu")
        out["coords"][str(shape)] = np.asarray(mesh.get_coordinate())
        num, den = backproject_views_sharded(scene, cams.viewmats, cams.Ks, torch.ones(8), W, H,
                                             enc, mesh, **LIFT_KW)
        out[f"lift {shape}"] = {"num": num, "den": den}
        out[f"step {shape}"] = step_case(mesh, random_features=True)
    mesh = make_mesh((4, 1), device="cpu")
    bad = {  # each raises before any collective
        "mesh (3, 1)": lambda: make_mesh((3, 1), device="cpu"),
        "7 cameras": lambda: backproject_views_sharded(
            scene, cams.viewmats[:7], cams.Ks[:7], torch.ones(7), W, H, enc, mesh),
        "N = 130 on (1, 4)": lambda: backproject_views_sharded(
            lift_inputs(130)[0], cams.viewmats, cams.Ks, torch.ones(8), W, H, enc,
            make_mesh((1, 4), device="cpu")),
    }
    for name, call in bad.items():
        try:
            call()
        except ValueError as e:
            out["errors"][name] = str(e)
    vms, ks, w = pad_cameras(cams.viewmats[:5], cams.Ks[:5], 8)
    num, den = backproject_views_sharded(scene, vms, ks, w, W, H, enc, mesh, **LIFT_KW)
    out["pad"] = {"num": num, "den": den, "weights": w}
    mesh = make_mesh((2, 2), device="cpu")
    out.update(train_cases(mesh))
    n_local = 96 // 2  # the cap at 0 (off), at every local row and at 4
    out.update({f"cap {cap}": step_case(mesh, exchange_rows=cap) for cap in (0, n_local, 4)})
    out.update(chunk_cases(mesh))
    out["oracle"] = oracle_case(mesh)
    out["dryrun"] = dryrun_ranks("cpu")
    if rank == 0:
        dist.destroy_process_group()
        out["solo"] = solo_cases()
    return out


def train_cases(mesh) -> dict:
    """The step on the "tiled" engine, without features (with both
    regularisers), with pose and appearance; the refine cycle."""
    return {
        "tiled": step_case(mesh, random_features=True, raster_engine="tiled"),
        "nofeat": step_case(mesh, feature=False, seed=1, opacity_reg=0.01, scale_reg=0.01),
        "pose_app": step_case(mesh, random_features=True, seed=3, pose_opt=True,
                              pose_noise=1e-3, app_opt=True),
        "refine": refine_case(mesh),
    }


def solo_cases() -> dict:
    """The (1, 1) references on a group of one rank; the (1, 1) step at
    batch 1 with the trainer's Adam against ``Trainer._step_on``; the
    ``experiments.sharded_singlechip`` comparison at a small size."""
    from tpugs_torch.dist.mesh import make_mesh, single_rank_group
    from tpugs_torch.dist.shard import make_trainer_step_sharded, shard_trainer
    from tpugs_torch.experiments import sharded_singlechip

    with single_rank_group("cpu"):
        mesh = make_mesh((1, 1), device="cpu")
        out = {"step": step_case(mesh, random_features=True)}
        out.update(train_cases(mesh))
        out["oracle"] = oracle_case(mesh, steps=1)
        vms, ks, images, teachers, bkgds, ids = batch_inputs(0)
        ref, tr = make_trainer(random_features=True), make_trainer(random_features=True)
        shard_trainer(tr, mesh)
        step = make_trainer_step_sharded(tr, mesh, 1)
        loss = step(tr.scene, tr.optimizer, tr.module_state(), vms[:1], ks[:1], images[:1],
                    teachers[:1], bkgds[:1], ids[:1])[3]
        ref_loss = ref._step_on(vms[0], ks[0], images[0], teachers[0], None, None, bkgds[0],
                                ref.cfg.sh_degree, 0)["loss"]
        out["vs _step_on"] = {"loss": loss, "ref_loss": ref_loss, "state": _state(tr),
                              "ref_state": _state(ref)}
        out["singlechip"] = sharded_singlechip.main(
            ["--device", "cpu", "--num-gaussians", "256", "--width", "64", "--height", "48",
             "--feature-dim", "8", "--views", "2"])
    return out


def raise_on_rank(rank: int, world: int, bad: int) -> None:
    """Rank ``bad`` raises before a collective that the others enter."""
    if rank == bad:
        raise ValueError(f"rank {rank} fails on purpose")
    dist.all_reduce(torch.ones(1))

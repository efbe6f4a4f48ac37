"""A dry run of the sharded programs at tiny shapes. Counterpart:
``__graft_entry__.py::dryrun_multichip`` (:49-234).

On a (world/2, 2) mesh (or (world, 1) for an odd world): the real trainer
step (feature field, pose and appearance, strategy "default" with growth
forced), ``refine_sharded``, the rebuilt step; the chunk over 2 staged
cameras per camera shard; the sharded lift of ``world`` views padded to
the mesh. tpugs runs its trainer twice, on its pure-JAX and its Pallas
engine; the port has one engine (the kernels on CUDA, their twins on the
CPU), so once.

    python -m tpugs_torch.dist.dryrun --n-ranks 4 --device cpu   # 4 gloo ranks
    python -m tpugs_torch.dist.dryrun --n-ranks 1                # one card, NCCL
    torchrun --nproc-per-node 4 -m tpugs_torch.dist.dryrun --n-ranks 4   # four cards
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from tpugs_torch.core.device import DeviceLike, resolve_device


def dryrun_ranks(device: DeviceLike = "cuda") -> dict:
    """The dry run on this rank of the started default group. Raises on a
    non-finite loss, grad2d, chunk loss or feature; returns the mesh, the
    losses, N after the refine and the lifted rows' shape."""
    from tpugs_torch.dist.mesh import block, make_mesh, mesh_device, pad_cameras
    from tpugs_torch.dist.shard import (
        backproject_views_sharded,
        make_trainer_chunk_sharded,
        make_trainer_step_sharded,
        refine_sharded,
        shard_trainer,
    )
    from tpugs_torch.encoders.base import LinearRGBEncoder
    from tpugs_torch.lift.batch import normalize_field
    from tpugs_torch.train.config import TrainConfig
    from tpugs_torch.train.trainer import Trainer, init_scene_random
    from tpugs_torch.utils.synthetic import orbit_cameras, random_scene

    world = dist.get_world_size()
    shape = (world // 2, 2) if world % 2 == 0 and world > 1 else (world, 1)
    mesh = make_mesh(shape, device=device)
    dev = mesh_device(mesh)
    width, height = 48, 32
    batch, i = shape[0], mesh.get_local_rank("cam")  # one camera per camera shard

    def local(x):
        return block(x, i, shape[0])

    def check_finite(x, what):
        if not bool(torch.isfinite(torch.as_tensor(x)).all()):
            raise RuntimeError(f"dry run: {what} not finite")

    cfg = TrainConfig(
        max_steps=10, init_num_pts=64 * shape[1], init_extent=0.6, sh_degree=1, feature_dim=8,
        feature_out_dim=16, strategy="default", grow_grad2d=1e-12, capacity_multiple=0,
        reset_every=0, random_bkgd=False, batch_size=batch, seed=0, pose_opt=True, app_opt=True)
    n_steps, c_total = 2, batch * 2  # the chunk: 2 staged cameras per camera shard
    trainer = Trainer(cfg, init_scene_random(cfg, device=dev), width=width, height=height,
                      n_cameras=c_total, device=dev)
    shard_trainer(trainer, mesh)
    cams = orbit_cameras(batch, width, height, radius=2.5, device=dev)
    rng = np.random.default_rng(0)
    images = torch.from_numpy(
        rng.uniform(0, 1, (batch, height, width, 3)).astype(np.float32)).to(dev)
    teachers = torch.from_numpy(
        rng.uniform(-1, 1, (batch, height, width, 16)).astype(np.float32)).to(dev)
    inputs = [local(x) for x in (cams.viewmats, cams.Ks, images, teachers,
                                 torch.zeros((batch, 3), device=dev),
                                 torch.arange(batch, device=dev))]
    step = make_trainer_step_sharded(trainer, mesh, batch)
    _, _, modules, loss, grad2d, vis, _ = step(trainer.scene, trainer.optimizer,
                                               trainer.module_state(), *inputs)
    check_finite(loss, "train step loss")
    check_finite(grad2d, "grad2d")
    trainer.grad_state.accumulate(grad2d, vis)
    refine_sharded(trainer, mesh)
    step = make_trainer_step_sharded(trainer, mesh, batch)
    loss_r = step(trainer.scene, trainer.optimizer, trainer.module_state(), *inputs)[3]
    check_finite(loss_r, "post-refine loss")

    cams_c = orbit_cameras(c_total, width, height, radius=2.5, device=dev)
    c_local = c_total // shape[0]
    staged = {
        "images": torch.from_numpy(
            rng.uniform(0, 1, (c_total, height, width, 3)).astype(np.float32)).to(dev),
        "viewmats": cams_c.viewmats, "Ks": cams_c.Ks,
        "image_ids": torch.arange(c_total, device=dev),
        "teachers": torch.from_numpy(
            rng.uniform(-1, 1, (c_total, height, width, 16)).astype(np.float32)).to(dev),
    }
    staged = {k: block(v, i, shape[0]) for k, v in staged.items()}
    sel = np.stack([np.concatenate([c * c_local + (np.arange(batch // shape[0]) + s) % c_local
                                    for c in range(shape[0])]) for s in range(n_steps)])
    chunk = make_trainer_chunk_sharded(trainer, mesh, batch, n_steps)
    stats = chunk(trainer.scene, trainer.optimizer, trainer.module_state(), staged, sel)[3]
    check_finite(stats["loss"], "chunk losses")

    scene = random_scene(64 * shape[1] * 2, seed=0, extent=0.8, scale_range=(0.02, 0.08),
                         device=dev)
    cams_l = orbit_cameras(world, width, height, radius=2.5, device=dev)
    vms, ks, w = pad_cameras(cams_l.viewmats, cams_l.Ks, world)
    num, den = backproject_views_sharded(scene, vms, ks, w, width, height,
                                         LinearRGBEncoder(8, device=dev), mesh, tile_size=16)
    feats = normalize_field(num, den)
    check_finite(feats, "lifted features")
    return {"mesh": shape, "loss": float(loss), "loss_after_refine": float(loss_r),
            "n_after_refine": trainer.scene.num_gaussians * shape[1],
            "chunk_losses": stats["loss"].cpu().numpy(), "features": tuple(feats.shape)}


def _rank(rank: int, world: int, device: str) -> dict:
    return dryrun_ranks(device)


def dryrun_multichip(n_ranks: int, device: DeviceLike = "cuda") -> dict:
    """The dry run over ``n_ranks`` ranks; returns rank 0's result. On the
    CPU: ``n_ranks`` spawned gloo ranks. On CUDA: this rank of a started
    group of ``n_ranks`` (torchrun), or for ``n_ranks`` 1 a group of one
    started here."""
    from tpugs_torch.dist.mesh import single_rank_group
    from tpugs_torch.dist.spawn import run_ranks

    dev = resolve_device(device)
    if dev.type == "cpu":
        out = run_ranks(_rank, n_ranks, ("cpu",))[0]
    elif dist.is_initialized():
        if dist.get_world_size() != n_ranks:
            raise RuntimeError(f"the group has {dist.get_world_size()} ranks, not {n_ranks}")
        out = dryrun_ranks(dev)
    elif n_ranks == 1:
        with single_rank_group(dev):
            out = dryrun_ranks(dev)
    else:
        raise RuntimeError(f"{n_ranks} CUDA ranks need one process each: start them under "
                           "torchrun and call init_ranks first")
    print(f"dryrun_multichip ok: mesh={out['mesh']}, loss={out['loss']:.4f}, "
          f"N after refine {out['n_after_refine']}, features={out['features']}")
    return out


if __name__ == "__main__":
    import argparse
    import os

    ap = argparse.ArgumentParser()
    ap.add_argument("--n-ranks", type=int, default=1)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args()
    if "LOCAL_RANK" in os.environ:  # under torchrun: one process per card
        from tpugs_torch.dist.mesh import init_ranks

        init_ranks(a.device)
        try:
            dryrun_multichip(a.n_ranks, a.device)
        finally:
            dist.destroy_process_group()
    else:
        dryrun_multichip(a.n_ranks, a.device)

"""CLI: Feature-3DGS training. Counterpart: ``tpugs/apps/train.py``.

COLMAP parse -> SfM init -> train steps with joint RGB + feature
distillation, densification, periodic eval and checkpoints -> final eval,
checkpoints and a trajectory GIF. On the command line:

    python -m tpugs_torch.apps.train --data-dir DATA --result-dir OUT \\
        --data-factor 1 --max-steps 6 --feature-dim 8 --feature-out-dim 4 \\
        --teacher linear:4 --strategy none --test-every 4 --eval-every 0 \\
        --save-every 0 [--chunked] [--device cpu]

``main`` parses the data and builds the trainer; ``run`` is the loop, so
that a caller with its splits in memory drives the same loop.
"""

from __future__ import annotations

import math
import os
import time
from functools import reduce
from typing import Callable, Optional

import numpy as np
import torch


def run(trainer, trainset, valset, result_dir: str, eval_every: int = 7000,
        save_every: int = 7000, chunked: bool = False, chunk_steps: int = 50, seed: int = 42,
        encoder: Optional[Callable] = None,
        on_update: Optional[Callable[[int, dict], None]] = None,
        viewer_every: int = 100) -> dict:
    """Train ``trainer`` up to ``cfg.max_steps`` and return the final eval.

    Per step: a camera drawn from ``default_rng(seed)``, the teacher
    ``encoder`` on its image, ``train_step`` (which refines and resets at
    its cadence). ``chunked``: ``train_chunk`` over the staged split in
    chunks of the gcd of every event cadence (at most ``chunk_steps``),
    with the refine and the opacity reset at the step after a chunk. Eval
    (``stats/val_step{step}.json``) and checkpoints (``ckpts/ckpt_{step}.npz``
    and ``full_{step}.npz``) at their cadence; at the end the final eval
    (``stats/val_final.json``) and both checkpoints at ``max_steps - 1``.
    ``on_update(step, stats)`` is called every ``viewer_every`` steps (per
    chunk when chunked)."""
    cfg = trainer.cfg

    def maybe_eval_save(step):
        if eval_every and step > 0 and step % eval_every == 0:
            metrics = trainer.evaluate(valset)
            print(f"eval @ {step}: {metrics}", flush=True)
            trainer.save_stats(metrics, os.path.join(result_dir, f"stats/val_step{step}.json"))
        if save_every and step > 0 and step % save_every == 0:
            trainer.save_checkpoint(os.path.join(result_dir, f"ckpts/ckpt_{step}.npz"))
            trainer.save_checkpoint_full(os.path.join(result_dir, f"ckpts/full_{step}.npz"))

    t0 = time.time()
    if chunked:
        staged = trainer.stage_dataset(trainset)
        cadences = [cfg.sh_degree_interval, 100]
        if cfg.strategy != "none":
            cadences += [cfg.refine_every]
            if cfg.reset_every > 0:
                cadences.append(cfg.reset_every)
        if eval_every:
            cadences.append(eval_every)
        if save_every:
            cadences.append(save_every)
        chunk = reduce(math.gcd, cadences)
        if chunk_steps > 0 and chunk > chunk_steps:
            # the largest divisor of the event gcd under the cap, so that
            # chunk boundaries still land on every event step
            chunk = max(d for d in range(1, chunk + 1) if chunk % d == 0 and d <= chunk_steps)
        start = trainer.step
        while trainer.step < cfg.max_steps:
            stats = trainer.train_chunk(staged, min(chunk, cfg.max_steps - trainer.step))
            step = trainer.step
            rate = (step - start) / (time.time() - t0)
            print(f"step {step} loss {stats['loss'][-1]:.4f} l1 {stats['l1'][-1]:.4f} "
                  f"feat {stats['feature_l1'][-1]:.4f} N {trainer.scene.num_gaussians} "
                  f"{rate:.2f} it/s", flush=True)
            if trainer.strategy is not None:
                if (cfg.refine_start_iter <= step < cfg.refine_stop_iter
                        and step % cfg.refine_every == 0):
                    info = trainer.refine()
                    print(f"refine @ {step}: {info}", flush=True)
                if (cfg.reset_every > 0 and step % cfg.reset_every == 0
                        # resets stop with densification, as in gsplat
                        and step < cfg.refine_stop_iter):
                    trainer.reset_opacities()
            if on_update is not None:
                on_update(step, {k: float(v[-1]) for k, v in stats.items()})
            if step < cfg.max_steps:
                maybe_eval_save(step)
    else:
        rng = np.random.default_rng(seed)
        for step in range(trainer.step, cfg.max_steps):
            data = trainset[int(rng.integers(0, len(trainset)))]
            feats = (encoder(torch.as_tensor(data["image"], dtype=torch.float32)
                             .to(trainer.device)) if encoder is not None else None)
            stats = trainer.train_step(data, teacher_feats=feats)
            if step % 100 == 0:
                rate = (step + 1) / (time.time() - t0)
                print(f"step {step} loss {stats['loss']:.4f} l1 {stats['l1']:.4f} "
                      f"feat {stats['feature_l1']:.4f} N {trainer.scene.num_gaussians} "
                      f"{rate:.2f} it/s", flush=True)
            if on_update is not None and step % viewer_every == 0:
                on_update(step, stats)
            maybe_eval_save(step)

    metrics = trainer.evaluate(valset)
    print("final eval:", metrics)
    trainer.save_stats(metrics, os.path.join(result_dir, "stats/val_final.json"))
    trainer.save_checkpoint(os.path.join(result_dir, f"ckpts/ckpt_{cfg.max_steps - 1}.npz"))
    trainer.save_checkpoint_full(os.path.join(result_dir, f"ckpts/full_{cfg.max_steps - 1}.npz"))
    return metrics


def main(
    data_dir: str = "./data/garden",
    result_dir: str = "./results/garden",
    data_factor: int = 4,
    max_steps: int = 30_000,
    feature_dim: int = 128,
    feature_out_dim: int = 512,
    teacher: str = "linear:512",
    strategy: str = "default",
    init_type: str = "sfm",
    sh_degree: int = 3,
    test_every: int = 8,
    eval_every: int = 7000,
    save_every: int = 7000,
    depth_loss: bool = False,
    steps_scaler: float = 1.0,
    seed: int = 42,
    pose_opt: bool = False,
    pose_noise: float = 0.0,
    app_opt: bool = False,
    absgrad: bool = False,
    grow_grad2d: float = 0.0002,
    compression: str = "",
    lpips_weights: str = "",
    resume: str = "",
    chunked: bool = False,
    chunk_steps: int = 50,
    capacity_multiple: int = 16384,
    viewer_port: int = -1,
    viewer_every: int = 100,
    raster_engine: str = "auto",
    device: str = "cuda",
):
    """Train a feature 3DGS scene on a COLMAP dataset. ``capacity_multiple``
    pads N after each "default" refine (0: exact N); ``lpips_weights`` a
    ``.pth``/``.npz`` of LPIPS weights for the evals; ``resume`` a
    ``full_*.npz``; ``viewer_port`` >= 0 serves the live viewer;
    ``device``: where everything runs, "cuda" or "cpu"."""
    from tpugs_torch.core.device import resolve_device
    from tpugs_torch.encoders import get_encoder
    from tpugs_torch.train.config import TrainConfig
    from tpugs_torch.train.dataset import Dataset, Parser
    from tpugs_torch.train.trainer import Trainer, init_scene_from_points, init_scene_random

    dev = resolve_device(device)
    cfg = TrainConfig(
        data_dir=data_dir, result_dir=result_dir, data_factor=data_factor,
        max_steps=max_steps, feature_dim=feature_dim, feature_out_dim=feature_out_dim,
        strategy=strategy, init_type=init_type, sh_degree=sh_degree, test_every=test_every,
        depth_loss=depth_loss, steps_scaler=steps_scaler, seed=seed, pose_opt=pose_opt,
        pose_noise=pose_noise, app_opt=app_opt, absgrad=absgrad, grow_grad2d=grow_grad2d,
        compression=compression, capacity_multiple=capacity_multiple,
        raster_engine=raster_engine,
    ).adjust_steps()

    os.makedirs(result_dir, exist_ok=True)
    parser = Parser(data_dir, factor=data_factor, normalize=cfg.normalize_world_space,
                    test_every=test_every)
    trainset = Dataset(parser, "train", load_depths=depth_loss)
    valset = Dataset(parser, "val")
    sample = trainset[0]
    height, width = sample["image"].shape[:2]

    if cfg.init_type == "sfm" and len(parser.points):
        scene = init_scene_from_points(parser.points, parser.points_rgb, cfg,
                                       parser.scene_scale, device=dev)
    else:
        scene = init_scene_random(cfg, parser.scene_scale, device=dev)

    encoder = get_encoder(teacher, device=dev) if feature_dim else None
    lpips_params = None
    if lpips_weights:
        from tpugs_torch.train.lpips import load_lpips_file

        lpips_params = load_lpips_file(lpips_weights)
    trainer = Trainer(cfg, scene, parser.scene_scale, teacher=encoder, width=width,
                      height=height, n_cameras=parser.num_images, lpips_params=lpips_params,
                      device=dev)
    if resume:
        trainer.load_checkpoint_full(resume)
        print(f"resumed from {resume} at step {trainer.step}", flush=True)

    on_update = None
    if viewer_port >= 0:
        from tpugs_torch.train.viewer import LiveViewer, orbit_viewmat
        from tpugs_torch.viz.common import to_uint8

        viewer = LiveViewer(port=viewer_port)
        print(f"live viewer: http://localhost:{viewer.port}/", flush=True)
        center = scene.means.cpu().numpy().mean(axis=0)
        default_vm = np.asarray(sample["viewmat"], np.float32)
        view_K = np.asarray(sample["K"], np.float32)

        def viewer_update(step, stats):
            """Render the browser's view and push frame and stats."""
            cam = viewer.render_request()
            vm = (orbit_viewmat(center, cam["yaw"], cam["pitch"], cam["radius"])
                  if cam else default_vm)
            img, _ = trainer.render_eval(vm, view_K)
            viewer.update(step, stats, to_uint8(img[..., :3]), num_rays_per_step=width * height)

        on_update = viewer_update

    run(trainer, trainset, valset, result_dir, eval_every, save_every, chunked, chunk_steps,
        seed, encoder, on_update, viewer_every)
    try:
        trainer.render_traj(np.asarray(sample["K"]), os.path.join(result_dir, "traj.gif"),
                            n_frames=30)
    except Exception as e:  # the reference's: a trajectory is a nicety, not a gate
        print("render_traj failed:", e)
    return trainer


if __name__ == "__main__":
    from tpugs_torch.utils.cli import cli

    cli(main)

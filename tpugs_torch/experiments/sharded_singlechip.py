"""The sharded programs on one device, on a (1, 1) mesh. Counterpart:
``scripts/bench_sharded_singlechip.py``.

Is the sharded program equal to the unsharded one, and what does sharding
cost on one device? On a group of one rank (NCCL on the card, gloo on the
CPU; the caller's group where one is started, else one started here):

* the lift: ``backproject_views_sharded`` against ``backproject_views`` on
  the seed-0 scene and ``--views`` orbit views (``LinearRGBEncoder``):
  relative error of num and den, and whether they are bit-equal;
* the train step: the sharded step at batch 1 against ``Trainer.
  train_step`` from the same initial scene (strategy "none", a linear
  teacher): the two losses.

Each time is the faster of 2 calls after one warm-up call, on the host
clock with the card synchronised (on the CPU, the host clock alone: no
device time). Parity holds at a relative 5e-3, tpugs' bound; one collective
on one rank copies, so equality is expected.

    python -m tpugs_torch.experiments.sharded_singlechip [--device cpu] \\
        [--num-gaussians N --width W --height H --feature-dim D --views V] \\
        [--skip-train] [--skip-backproject]

``main(argv)`` returns what it printed.
"""

from __future__ import annotations

import argparse
import contextlib
import time

import numpy as np
import torch
import torch.distributed as dist

from tpugs_torch.core.device import resolve_device

PARITY = 5e-3


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--num-gaussians", type=int, default=2**17)
    ap.add_argument("--width", type=int, default=648)
    ap.add_argument("--height", type=int, default=420)
    ap.add_argument("--feature-dim", type=int, default=64)
    ap.add_argument("--views", type=int, default=4)
    ap.add_argument("--skip-train", action="store_true")
    ap.add_argument("--skip-backproject", action="store_true")
    ap.add_argument("--device", default="cuda")
    return ap


def _rel(got: torch.Tensor, ref: torch.Tensor) -> float:
    return float((got - ref).abs().max() / (ref.abs().max() + 1e-30))


def main(argv=None) -> dict:
    args = _parser().parse_args(argv)
    dev = resolve_device(args.device)
    from tpugs_torch.dist.mesh import single_rank_group

    group = contextlib.nullcontext() if dist.is_initialized() else single_rank_group(dev)
    with group:
        return _run(args, dev)


def _run(args, dev) -> dict:
    from tpugs_torch.dist.mesh import make_mesh, mesh_device
    from tpugs_torch.encoders.base import LinearRGBEncoder
    from tpugs_torch.lift.batch import backproject_views
    from tpugs_torch.utils.synthetic import orbit_cameras, random_scene

    mesh = make_mesh((1, 1), device=dev.type)
    dev = mesh_device(mesh)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    clock = "host clock, card synchronised" if dev.type == "cuda" else "host clock on the CPU"
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"device: {dev} ({name}); one rank, backend {dist.get_backend()}", flush=True)

    def timed(fn):
        out = fn()
        sync()
        best = None
        for _ in range(2):
            t0 = time.perf_counter()
            out = fn()
            sync()
            dt = time.perf_counter() - t0
            best = dt if best is None else min(best, dt)
        return out, 1e3 * best

    W, H, V = args.width, args.height, args.views
    scene = random_scene(args.num_gaussians, seed=0, extent=1.0, scale_range=(0.004, 0.02),
                         device=dev)
    cams = orbit_cameras(V, W, H, radius=3.0, device=dev)
    result = {"device": name, "clock": clock}
    if not args.skip_backproject:
        from tpugs_torch.dist.shard import backproject_views_sharded

        enc = LinearRGBEncoder(args.feature_dim, device=dev)
        (num0, den0), t_un = timed(lambda: backproject_views(
            scene, cams.viewmats, cams.Ks, W, H, enc, device=dev))
        (num1, den1), t_sh = timed(lambda: backproject_views_sharded(
            scene, cams.viewmats, cams.Ks, torch.ones(V, device=dev), W, H, enc, mesh))
        err, derr = _rel(num1, num0), _rel(den1, den0)
        equal = torch.equal(num1, num0) and torch.equal(den1, den0)
        ok = err < PARITY and derr < PARITY
        print(f"[backproject] unsharded {t_un:.1f} ms, sharded (1x1 mesh) {t_sh:.1f} ms "
              f"({t_sh / t_un:.2f}x; {clock}), rel err num {err:.2e} den {derr:.2e}, "
              f"bit-equal {equal}, parity={'OK' if ok else 'FAIL'}", flush=True)
        result["backproject"] = {"unsharded_ms": t_un, "sharded_ms": t_sh, "rel_err_num": err,
                                 "rel_err_den": derr, "bit_equal": equal, "ok": ok}
        del num0, den0, num1, den1
        if not ok:
            raise RuntimeError("sharded back-projection parity failed")
    if not args.skip_train:
        result["train"] = _train(args, dev, mesh, cams, timed, clock)
    print("single-device sharded dispatch: all OK", flush=True)
    return result


def _train(args, dev, mesh, cams, timed, clock) -> dict:
    from tpugs_torch.dist.shard import make_trainer_step_sharded, shard_trainer
    from tpugs_torch.encoders import get_encoder
    from tpugs_torch.train.config import TrainConfig
    from tpugs_torch.train.trainer import Trainer, init_scene_from_points

    W, H = args.width, args.height
    rng = np.random.default_rng(0)
    n = args.num_gaussians
    pts = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    rgbs = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    cfg = TrainConfig(max_steps=100, sh_degree=3, feature_dim=32,
                      feature_out_dim=args.feature_dim, strategy="none", random_bkgd=False)

    def trainer():
        return Trainer(cfg, init_scene_from_points(pts, rgbs, cfg, device=dev), width=W,
                       height=H, n_cameras=args.views, device=dev)

    teacher = get_encoder(f"linear:{args.feature_dim}", device=dev)
    image = torch.from_numpy(rng.uniform(0, 1, (H, W, 3)).astype(np.float32)).to(dev)
    tr = trainer()
    feats = teacher(image).to(tr.teacher_dtype)
    shard_trainer(tr, mesh)
    step = make_trainer_step_sharded(tr, mesh, 1)
    args_sh = (cams.viewmats[:1], cams.Ks[:1], image[None], feats[None],
               torch.zeros((1, 3), device=dev), torch.zeros(1, dtype=torch.int64))
    loss_sh = float(step(tr.scene, tr.optimizer, tr.module_state(), *args_sh)[3])
    _, t_sh = timed(lambda: step(tr.scene, tr.optimizer, tr.module_state(), *args_sh))
    batch = {"image": image, "viewmat": cams.viewmats[0], "K": cams.Ks[0], "image_id": 0}
    tr2 = trainer()
    loss_un = tr2.train_step(batch, teacher_feats=feats)["loss"]
    _, t_un = timed(lambda: tr2.train_step(batch, teacher_feats=feats))
    rel = abs(loss_sh - loss_un) / (abs(loss_un) + 1e-30)
    ok = rel < PARITY
    print(f"[train-step] unsharded loss {loss_un:.6f} ({t_un:.1f} ms), sharded (1x1) loss "
          f"{loss_sh:.6f} ({t_sh:.1f} ms, {t_sh / max(t_un, 1e-9):.2f}x; {clock}), rel diff "
          f"{rel:.2e}, parity={'OK' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise RuntimeError("sharded train step parity failed")
    return {"unsharded_ms": t_un, "sharded_ms": t_sh, "loss_unsharded": loss_un,
            "loss_sharded": loss_sh, "rel_diff": rel, "ok": ok}


if __name__ == "__main__":
    main()

"""Per-stage timing of the fused back-projection, and the eager lift's
stage split. Counterpart: ``scripts/profile_stages.py``.

On view 0 of the seed-0 scene and the 4-view orbit rig, each stage of
``lift/batch.py::run_view`` on its own: the plan (with ``--plan-breakdown``
its sub-stages, ``raster/plan.py::PLAN_STAGES``, split in place by
``build_plan``'s marks), the pack (projection, SH and geometry), B1 alone
and with the pack, the encoder, B2 (bf16 rows), the reduce (B3 and the
XLA engine), the reference's unpermute A/B on the XLA engine's sums
(``unpermute_write_back``, the port's form, against ``unpermute_gather``,
the reference's default), then the whole view through
``run_view`` (traced with ``--profile-dir``). It ends with the roofline
table of the reference's analytic models at the H100's peaks, the view's
speed of light (``sol_estimate``) and the card's memory statistics (on
the CPU only the speed of light: its times are not the card's).

Each time is the median over ``--iters`` calls after one warm-up call.
On the card: the CUDA-event time of the call and the host's time to
return from it, from an idle card (a stage whose host time is close to
its event time is bound by the host). On the CPU both are the host clock.
The port's plan is exact per view, so the reference's size buckets have
no counterpart: the plan's exact sizes are printed instead. The roofline
rows price 16x16 tiles (the models' own assumption) whatever ``--tile``
is; ``chip_smoke.py``'s kernel bounds count the pairs each run walks.

    python -m tpugs_torch.experiments.profile_stages [--plan-breakdown] \\
        [--profile-dir DIR] [--num-gaussians N --width W --height H \\
        --feature-dim D --tile T --iters I] [--device cpu]

``main(argv)`` returns what it printed, with the full view's ``num`` and
``den``, the two reduces' sums and the two unpermutes', for the checks of
its callers.
"""

from __future__ import annotations

import argparse
import time
from typing import Callable, Dict, Sequence, Tuple

import torch

from tpugs_torch.core.device import resolve_device
from tpugs_torch.raster.projection import ProjectionConfig
from tpugs_torch.utils.profiling import StageTimer


def unpermute_write_back(acc: torch.Tensor, order: torch.Tensor) -> torch.Tensor:
    """Rows of ``acc``, in the column order ``order`` of ``slot_columns``,
    back in original order by writing each row to its place: the form of
    ``raster/reduce.py::reduce_contribs_xla``."""
    out = torch.empty_like(acc)
    out[order] = acc
    return out


def unpermute_gather(acc: torch.Tensor, order: torch.Tensor) -> torch.Tensor:
    """The same rows by a gather through the inverse permutation: the
    reference's default (``pallas_tiled.py:2106-2119``, its A/B hook)."""
    return acc[torch.argsort(order)]


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def timed(fn: Callable[[], object], iters: int, dev: torch.device) -> Tuple[float, float]:
    """(device ms, host ms) of one call of ``fn``: medians over ``iters``
    calls after one warm-up call. On CUDA the device ms is the CUDA-event
    time of the call and the host ms its return time from an idle card; on
    the CPU both are the host clock."""
    fn()
    _sync(dev)
    dev_ms, host_ms = [], []
    for _ in range(iters):
        if dev.type == "cuda":
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            e0.record()
            fn()
            t1 = time.perf_counter()
            e1.record()
            torch.cuda.synchronize(dev)
            dev_ms.append(e0.elapsed_time(e1))
            host_ms.append(1e3 * (t1 - t0))
        else:
            t0 = time.perf_counter()
            fn()
            host_ms.append(1e3 * (time.perf_counter() - t0))
            dev_ms.append(host_ms[-1])
    mid = iters // 2
    return sorted(dev_ms)[mid], sorted(host_ms)[mid]


def split(fn: Callable[[Callable[[str], None]], object], names: Sequence[str], iters: int,
          dev: torch.device) -> Dict[str, float]:
    """Mean ms of each named stage of ``fn(mark)``, which calls ``mark(name)``
    after each stage: CUDA events recorded at the marks on the card, the
    host clock on the CPU; ``iters`` calls after one warm-up call."""
    fn(lambda name: None)
    _sync(dev)
    total = dict.fromkeys(names, 0.0)
    for _ in range(iters):
        marks = []
        if dev.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            start.record()

            def mark(name):
                ev = torch.cuda.Event(enable_timing=True)
                ev.record()
                marks.append((name, ev))
        else:
            start = time.perf_counter()

            def mark(name):
                marks.append((name, time.perf_counter()))
        fn(mark)
        _sync(dev)
        prev = start
        for name, at in marks:
            total[name] += (prev.elapsed_time(at) if dev.type == "cuda"
                            else 1e3 * (at - prev))
            prev = at
    return {k: v / iters for k, v in total.items()}


def eager_lift_split(scene, cams, encoder, timer: StageTimer,
                     proj_config: ProjectionConfig = ProjectionConfig(),
                     tile_size: int = 16) -> torch.Tensor:
    """``lift/backproject.py::create_feature_field`` composed of its own
    calls, each stage under ``timer`` (on the timer's device): per view
    project+sh (``plan_render``'s projection, ``rasterize_with_plan``'s
    and the SH colours), plan, pack (B4's), B4, encode, pack (B2's, and
    the features to tiles), B2, B3, accumulate; then normalise. Returns
    the (N, D) field, which equals ``create_feature_field``'s."""
    import dataclasses

    from tpugs_torch.lift.backproject import DENOM_INIT
    from tpugs_torch.raster.binning import tile_grid
    from tpugs_torch.raster.colors import prepare_colors
    from tpugs_torch.raster.kernels import adjoint_rows, reduce_rows
    from tpugs_torch.raster.pack import pack_rows
    from tpugs_torch.raster.plan import build_plan
    from tpugs_torch.raster.projection import project
    from tpugs_torch.raster.tiles import image_to_tiles
    from tpugs_torch.raster.train import pack_train, train_forward

    dev = timer.device
    scene = scene.to(dev)
    n, d, w, h = scene.num_gaussians, encoder.feature_dim, cams.width, cams.height
    ntx, nty = tile_grid(w, h, tile_size)
    num = torch.zeros((n, d), dtype=torch.float32, device=dev)
    den = torch.full((n,), DENOM_INIT, dtype=torch.float32, device=dev)
    geometry = (scene.means, scene.quats, scene.scales, scene.opacities)
    with torch.no_grad():
        for c in range(cams.num_cameras):
            vm, K = cams.viewmats[c].to(dev), cams.Ks[c].to(dev)
            with timer.stage("project+sh"):
                proj = project(*geometry, vm, K, w, h, proj_config)
                proj_r = project(*geometry, vm, K, w, h, proj_config)
                cols = prepare_colors(scene.means, scene.colors_all, vm, scene.sh_degree)
            with timer.stage("plan"):
                plan = build_plan(proj, w, h, tile_size)
            with timer.stage("pack"):
                opac = torch.where(proj_r.valid, proj_r.opacities,
                                   torch.zeros_like(proj_r.opacities))
                geom, colp = pack_train(proj_r.means2d, proj_r.conics, opac, cols, plan)
            with timer.stage("B4"):
                rgb, _, _ = train_forward(geom, colp, plan, 0.0)
            with timer.stage("encode"):
                feats = encoder(rgb)
            with timer.stage("pack"):
                opac = torch.where(proj.valid, proj.opacities, torch.zeros_like(proj.opacities))
                packed = pack_rows(proj.means2d, proj.conics, opac, None, None, plan)
                feat_tiles = image_to_tiles(feats.float(), tile_size).contiguous()
            with timer.stage("B2"):
                whole = dataclasses.replace(plan, width=ntx * tile_size,
                                            height=nty * tile_size)
                rows = adjoint_rows(packed, feat_tiles, whole, trans_eps=0.0)
            with timer.stage("B3"):
                sums = reduce_rows(rows, plan, d + 1)
            with timer.stage("accumulate"):
                num = num + sums[:, :d]
                den = den + sums[:, d]
            del rows, packed, feat_tiles, geom, colp
        with timer.stage("normalise"):
            features = num / den[:, None]
            features = features / torch.linalg.vector_norm(features, dim=-1, keepdim=True)
            features = torch.nan_to_num(features, nan=0.0, posinf=0.0, neginf=0.0)
    return features


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--num-gaussians", type=int, default=2**19)
    ap.add_argument("--width", type=int, default=1296)
    ap.add_argument("--height", type=int, default=840)
    ap.add_argument("--feature-dim", type=int, default=512)
    ap.add_argument("--tile", type=int, default=32)
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--plan-breakdown", action="store_true",
                    help="also time the plan's sub-stages in place")
    ap.add_argument("--profile-dir", type=str, default="",
                    help="write a torch.profiler Chrome trace of the full view here")
    ap.add_argument("--device", type=str, default="cuda")
    return ap


def main(argv=None) -> dict:
    args = _parser().parse_args(argv)
    dev = resolve_device(args.device)
    from tpugs_torch.encoders.base import LinearRGBEncoder
    from tpugs_torch.lift.batch import run_view
    from tpugs_torch.raster.colors import prepare_colors
    from tpugs_torch.raster.kernels import adjoint_rows, reduce_rows, render_tiles
    from tpugs_torch.raster.pack import pack_isect_all
    from tpugs_torch.raster.plan import PLAN_STAGES, build_plan, slot_columns
    from tpugs_torch.raster.projection import project
    from tpugs_torch.raster.reduce import reduce_contribs_xla
    from tpugs_torch.raster.tiles import image_to_tiles, tiles_to_image
    from tpugs_torch.utils.profiling import (
        adjoint_model,
        annotation,
        device_memory_stats,
        reduce_model,
        render_model,
        sol_estimate,
        trace,
    )
    from tpugs_torch.utils.synthetic import orbit_cameras, random_scene

    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"device: {dev} ({name})", flush=True)
    W, H, D, ts, it = args.width, args.height, args.feature_dim, args.tile, args.iters
    scene = random_scene(args.num_gaussians, seed=0, extent=1.0, scale_range=(0.004, 0.02),
                         device=dev)
    cams = orbit_cameras(4, W, H, radius=3.0, device=dev)
    encoder = LinearRGBEncoder(feature_dim=D, device=dev)
    vm, K = cams.viewmats[0], cams.Ks[0]
    geometry = (scene.means, scene.quats, scene.scales, scene.opacities)
    ms, host = {}, {}

    def stage(label, fn):
        ms[label], host[label] = timed(fn, it, dev)
        print(f"{label:<32} {ms[label]:9.3f} ms (host {host[label]:.3f} ms)", flush=True)

    with torch.no_grad():
        proj = project(*geometry, vm, K, W, H)
        stage("plan", lambda: build_plan(proj, W, H, ts))
        plan = build_plan(proj, W, H, ts)
        slot_order, culled = slot_columns(plan)
        sizes = {"n_tiles": plan.n_tiles, "n_isects": plan.n_isects,
                 "T_padded": plan.T_padded, "max_cover": int(culled[0])}
        print(f"plan sizes (exact; no buckets): {sizes}", flush=True)
        plan_ms = {}
        if args.plan_breakdown:
            plan_ms = split(lambda mark: build_plan(proj, W, H, ts, on_stage=mark),
                            PLAN_STAGES, it, dev)
            for k, v in plan_ms.items():
                print(f"  {k:<30} {v:9.3f} ms (CUDA events in place)" if dev.type == "cuda"
                      else f"  {k:<30} {v:9.3f} ms (host clock in place)", flush=True)

        def pack():
            p = project(*geometry, vm, K, W, H)
            return pack_isect_all(p, prepare_colors(scene.means, scene.colors_all, vm,
                                                    scene.sh_degree), plan)

        stage("pack(proj+sh+geom)", pack)
        packed = pack()
        stage("render kernel (B1)", lambda: render_tiles(packed, plan))
        stage("render(incl pack)", lambda: render_tiles(pack(), plan))
        tiles, _ = render_tiles(packed, plan)

        def encode():
            if getattr(encoder, "pixelwise", False):
                return encoder(tiles[..., :3])
            return image_to_tiles(encoder(tiles_to_image(tiles, W, H, ts)[..., :3]), ts)

        stage("encoder", encode)
        feats = encode().to(torch.bfloat16).contiguous()
        stage("adjoint kernel (B2, bf16)", lambda: adjoint_rows(packed, feats, plan))
        rows = adjoint_rows(packed, feats, plan)
        n_contrib_rows = int(rows.shape[0])
        stage("reduce (B3)", lambda: reduce_rows(rows, plan, D + 1))
        stage("reduce (xla)", lambda: reduce_contribs_xla(rows, plan, D + 1))
        sums = {"pallas": reduce_rows(rows, plan, D + 1),
                "xla": reduce_contribs_xla(rows, plan, D + 1)}
        acc = sums["xla"][slot_order]  # the XLA engine's sums before its unpermute
        for label, fn in (("write-back", unpermute_write_back), ("gather", unpermute_gather)):
            stage(f"unpermute ({label})", lambda fn=fn: fn(acc, slot_order))
            sums[label] = fn(acc, slot_order)
        del rows, feats, tiles, packed, acc

        def full():
            return run_view(scene, vm, K, W, H, encoder, ts)

        r = full()
        num, den = r.num, r.den
        del r
        with trace(args.profile_dir) as trace_path:
            with annotation("FULL view"):
                stage("FULL view (run_view)", full)

    # Roofline of the reference's analytic models (16x16 tiles) at the
    # H100's peaks, on the event times: the card's only.
    n_isect, n_pix = plan.T_padded, W * H
    sol = sol_estimate(n_isect, n_pix, D, slot_rows=plan.n_isects)
    print("SOL (analytic models, H100 peaks): per-view floor {:.3f} ms (render {:.3f}, "
          "encode {:.3f}, adjoint {:.3f}, plan {:.3f}, reduce {:.3f})".format(
              sol["total"] * 1e3, sol["render"] * 1e3, sol["encode"] * 1e3,
              sol["adjoint"] * 1e3, sol["plan"] * 1e3, sol["reduce"] * 1e3), flush=True)
    report = None
    if dev.type == "cuda":
        rt = StageTimer(dtype="bf16", device=dev)
        models = {"render(incl pack)": render_model(n_isect, n_pix, 3),
                  "adjoint kernel (B2, bf16)": adjoint_model(n_isect, D + 1),
                  "reduce (B3)": reduce_model(n_contrib_rows, D + 1)}
        for label, m in models.items():
            rt.add(label, ms[label] / 1e3, **m)
        full_ms = ms["FULL view (run_view)"]
        rt.add("FULL view (run_view)", full_ms / 1e3,
               flops=sum(m["flops"] for m in models.values()),
               hbm_bytes=sum(m["hbm_bytes"] for m in models.values()))
        report = rt.report()
        print(report, flush=True)
        print(f"measured full view {full_ms:.3f} ms -> "
              f"{100.0 * sol['total'] * 1e3 / full_ms:.1f}% of speed of light", flush=True)
    else:
        print("roofline and speed-of-light share: not measured (a CPU run)", flush=True)
    mem = device_memory_stats(dev)
    if mem:
        print(f"device memory: {mem}", flush=True)
    return {"device": name, "ms": ms, "host_ms": host, "plan_ms": plan_ms, "sizes": sizes,
            "num": num, "den": den, "sums": sums, "roofline": report, "sol": sol,
            "memory": mem, "trace": trace_path}


if __name__ == "__main__":
    main()

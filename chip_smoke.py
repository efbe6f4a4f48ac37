#!/usr/bin/env python3
"""Drive the PyTorch port (``tpugs_torch``) on one CUDA card and check it.

    python3 chip_smoke.py        # from the repo root; one H100, nvcc on the box

Five phases; the first failure ends the run with a nonzero exit:

1. build   — compile ``tpugs_torch/csrc/*.cu`` for sm_90a and load them.
2. kernels — each kernel (B1 render, B2 adjoint in f32 and bf16, B3
             reduce; B4 train_fwd, B5 train_bwd in f32 and bf16 with B3's
             sums of its rows) against its plain PyTorch twin on CUDA
             tensors, at mid shapes with edge cases: W, H not multiples of
             the tile, empty tiles, tiles that exit early, Gaussians
             covering many tiles, D = 3, 20 and 131; then
             ``render_plan_train`` with a background and the absgrad probe
             against the same call on the CPU.
3. full width — the canonical back-projection shape (N = 2^19 Gaussians,
             1296 x 840, D = 512, tile 32, linear encoder, 8 orbit views
             after one warm-up view) through ``backproject_views``; per-stage
             CUDA-event times, ms/view, views/s, peak memory; 64 random
             tiles of one view held against the twins; every kernel must
             have launched at least once per view.
4. training — the garden-scale feature-3DGS train step (2^19 Gaussians,
             1296 x 840, 131 rendered channels, a 512-d teacher, SH 3,
             tile 32) through ``Trainer.train_chunk``: 3 warm-up steps, 10
             timed steps at SH 3; ms/step, steps/s, peak memory, per-stage
             CUDA-event times; the loss finite, every parameter moved, B4,
             B5 and B3 launched every step; 64 random tiles of one step held
             against the twins.
5. kernels line — one JSON object per kernel with its launches, errors,
             time, the twin's time, its bound on this card and, for B3 (on
             the lift's rows and on the train rows), the time of one
             library call (sparse CSR product) that computes the same sums.

The last line is ``{"ok": true, "device": {...}}``. Without a CUDA card,
or without the package beside this file, it exits nonzero and prints no
result. Nothing here imports JAX or the ``tpugs`` package.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
import warnings

import torch

# Published H100 SXM peaks (NVIDIA data sheet, dense): the bounds below.
PEAK_BYTES_S = 3.35e12
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12
PAIR_OPS = 30  # f32 operations per evaluated (pixel, Gaussian) pair, incl. exp

N_FULL, W_FULL, H_FULL, D_FULL, TILE, VIEWS = 2**19, 1296, 840, 512, 32, 8


def bound(bytes_, ops, peak):
    """(least ms for this work on the card, what bounds it)."""
    t_bytes, t_ops = 1e3 * bytes_ / PEAK_BYTES_S, 1e3 * ops / peak
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def rec(kid, name, src, replaces, n, err, ms, plain, b, lib=None):
    return {"id": kid, "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": n, "max_abs_err": err[0],
            "max_err": err[-1], "ms": ms, "plain_ms": plain, "bound_ms": b[0],
            "bound_by": b[1], "library_ms": lib}


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def rel_err(got: torch.Tensor, ref: torch.Tensor):
    got, ref = got.float(), ref.float()
    abs_err = float((got - ref).abs().max()) if ref.numel() else 0.0
    scale = float(ref.abs().max()) if ref.numel() else 0.0
    return abs_err, abs_err / scale if scale > 0 else abs_err


def within_rows_tol(of_group: float, of_row: float, dtype) -> bool:
    from tpugs_torch.raster.kernels import ROWS_TOL

    group_tol, row_tol = ROWS_TOL[dtype]
    return of_group <= group_tol and of_row <= row_tol


def time_cuda(fn, iters: int, warmup: int = 1) -> float:
    """Mean ms per call by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(iters):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / iters


def span_rows(plan, tiles: torch.Tensor) -> torch.Tensor:
    """Padded row indices of the spans of ``tiles``."""
    count = (plan.tile_ends[tiles] - plan.tile_starts[tiles]).long()
    length = (count + 127) // 128 * 128
    start = plan.padded_starts[tiles].long()
    owner = torch.repeat_interleave(torch.arange(len(tiles), device=tiles.device), length)
    first = torch.cumsum(length, 0) - length
    return start[owner] + torch.arange(int(length.sum()), device=tiles.device) - first[owner]


def gaussians_of(plan, rows: torch.Tensor) -> torch.Tensor:
    """Original indices of the Gaussians with an intersection in ``rows``."""
    rank = plan.padded_gid[rows].long()
    rank = rank[rank < plan.num_gaussians]
    return torch.unique(plan.order[rank])


def phase_build():
    from tpugs_torch.kernels.build import build_library, load_library

    t0 = time.perf_counter()
    so = build_library()
    load_library()
    dt = time.perf_counter() - t0
    ptxas = [
        line.strip() for line in so.with_suffix(".log").read_text().splitlines()
        if "registers" in line or "Compiling entry" in line or "spill" in line
    ] if so.with_suffix(".log").exists() else ["(library was already built)"]
    print(f"phase 1 build: {dt:.1f} s -> {so}", flush=True)
    for line in ptxas:
        print(f"  ptxas: {line}")


def phase_kernels():
    """Kernels against twins at mid shapes; returns nothing, raises on a
    disagreement."""
    from tpugs_torch.encoders.base import LinearRGBEncoder
    from tpugs_torch.raster import kernels as K
    from tpugs_torch.raster.colors import prepare_colors
    from tpugs_torch.raster.pack import pack_isect_all
    from tpugs_torch.raster.plan import build_plan
    from tpugs_torch.raster.projection import project
    from tpugs_torch.utils.synthetic import orbit_cameras, random_scene

    W, H = 300, 200
    scene = random_scene(20000, seed=1, extent=0.6, scale_range=(0.01, 0.12), device="cuda")
    cams = orbit_cameras(2, W, H, radius=3.0, device="cuda")
    for ts, D, view in ((32, 64, 0), (16, 20, 1)):
        vm, Km = cams.viewmats[view], cams.Ks[view]
        proj = project(scene.means, scene.quats, scene.scales, scene.opacities, vm, Km, W, H)
        plan = build_plan(proj, W, H, ts)
        packed = pack_isect_all(
            proj, prepare_colors(scene.means, scene.colors_all, vm, scene.sh_degree), plan)
        spans = plan.tile_ends - plan.tile_starts
        covers = plan.gauss_offsets[1:] - plan.gauss_offsets[:-1]

        img_k, done_k = K.render_tiles(packed, plan)
        torch.cuda.synchronize()
        img_t, done_t = K.render_tiles_plain(packed, plan)
        nb = (spans + 127) // 128
        check(bool((spans == 0).any()), "an empty tile")
        check(bool((done_t < nb).any()), "a tile that exits early")
        check(int(covers.max()) >= 6, "a Gaussian covering many tiles")
        a, r = rel_err(img_k, img_t)
        print(f"phase 2 ts={ts} B1 render: max abs {a:.3e} rel {r:.3e} "
              f"(exit blocks differ on {int((done_k != done_t).sum())} tiles)", flush=True)
        check(r <= 1e-4, "B1 within 1e-4 relative of its twin")

        enc = LinearRGBEncoder(D, seed=3, device="cuda")
        feats = enc(img_k[..., :3]).contiguous()
        rows32 = K.adjoint_rows(packed, feats, plan)
        torch.cuda.synchronize()
        a, g, r = K.rows_error(rows32, K.adjoint_rows_plain(packed, feats, plan), D)
        print(f"phase 2 ts={ts} D={D} B2 adjoint f32: max abs {a:.3e}, "
              f"{g:.3e} of column-group max, {r:.3e} of row max", flush=True)
        check(within_rows_tol(g, r, torch.float32), "B2 f32 rows within ROWS_TOL of its twin")

        fbf = feats.to(torch.bfloat16)
        rows_bf = K.adjoint_rows(packed, fbf, plan)
        torch.cuda.synchronize()
        rows_bf_t = K.adjoint_rows_plain(packed, fbf, plan)
        a, g, r = K.rows_error(rows_bf, rows_bf_t, D)
        red_k = K.reduce_rows(rows_bf, plan, D + 1)
        torch.cuda.synchronize()
        red_t = K.reduce_rows_plain(rows_bf_t, plan, D + 1)
        _, r_den = rel_err(red_k[:, D], red_t[:, D])
        _, r_num = rel_err(red_k[:, :D], red_t[:, :D])
        print(f"phase 2 ts={ts} D={D} B2 adjoint bf16: rows max abs {a:.3e}, "
              f"{g:.3e} of column-group max, {r:.3e} of row max; "
              f"reduced den {r_den:.3e} num {r_num:.3e} of max", flush=True)
        check(within_rows_tol(g, r, torch.bfloat16), "B2 bf16 rows within ROWS_TOL of the twin")
        check(r_den <= 5e-3 and r_num <= 1e-2, "B2 bf16 sums within 0.5% / 1%")

        for rows in (rows32, rows_bf):
            red = K.reduce_rows(rows, plan, D + 1)
            torch.cuda.synchronize()
            same = torch.equal(red, K.reduce_rows_plain(rows, plan, D + 1))
            print(f"phase 2 ts={ts} B3 reduce {rows.dtype}: bit-equal to twin: {same}", flush=True)
            check(same, "B3 bit-equal to its twin on the same rows")


def within_grad_tol(of_group: float, of_entry: float, dtype) -> bool:
    from tpugs_torch.raster.train import GRAD_ROWS_TOL

    group_tol, entry_tol = GRAD_ROWS_TOL[dtype]
    return of_group <= group_tol and of_entry <= entry_tol


def phase_train_kernels():
    """B4 and B5 (f32 and bf16 rows, and B3's sums of them) against their
    twins at mid shapes, then one ``render_plan_train`` with a background
    and the absgrad probe against the same call on CPU copies (the twins)."""
    from tpugs_torch.raster import train as T
    from tpugs_torch.raster.kernels import reduce_rows, reduce_rows_plain
    from tpugs_torch.raster.plan import build_plan
    from tpugs_torch.raster.projection import project
    from tpugs_torch.utils.synthetic import orbit_cameras, random_scene

    W, H = 300, 200
    scene = random_scene(20000, seed=1, extent=0.6, scale_range=(0.01, 0.12), device="cuda")
    cams = orbit_cameras(2, W, H, radius=3.0, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(5)
    seen_exit = seen_empty = False
    for ts, D, view in ((32, 131, 0), (16, 20, 1), (32, 3, 1), (16, 131, 0)):
        vm, Km = cams.viewmats[view], cams.Ks[view]
        proj = project(scene.means, scene.quats, scene.scales, scene.opacities, vm, Km, W, H)
        plan = build_plan(proj, W, H, ts)
        opac = torch.where(proj.valid, proj.opacities, torch.zeros_like(proj.opacities))
        colors = torch.rand((scene.num_gaussians, D), device="cuda", generator=gen)
        geom, cols = T.pack_train(proj.means2d, proj.conics, opac, colors, plan)
        spans = plan.tile_ends - plan.tile_starts
        nb = (spans + 127) // 128

        img_k, alpha_k, done_k = T.train_forward(geom, cols, plan)
        torch.cuda.synchronize()
        img_t, alpha_t, done_t = T.train_forward_plain(geom, cols, plan)
        seen_exit |= bool((done_t < nb).any())
        seen_empty |= bool((spans == 0).any())
        _, r_img = rel_err(img_k, img_t)
        _, r_alpha = rel_err(alpha_k, alpha_t)
        print(f"phase 2 ts={ts} D={D} B4 train_fwd: image rel {r_img:.3e}, alpha rel "
              f"{r_alpha:.3e} (exit blocks differ on {int((done_k != done_t).sum())} tiles)",
              flush=True)
        check(r_img <= 1e-4 and r_alpha <= 1e-4, "B4 within 1e-4 relative of its twin")

        g = torch.randn((H, W, D), device="cuda", generator=gen)
        hterm = torch.randn((H, W), device="cuda", generator=gen) * (1.0 - alpha_k)
        grem0 = (g * img_k).sum(-1)
        args = (geom, cols, g, hterm, grem0, done_k, plan)
        for dtype in (torch.float32, torch.bfloat16):
            rows_k = T.train_rows(*args, dtype)
            sums_k = reduce_rows(rows_k, plan, D + T.GEOM_GRADS)
            torch.cuda.synchronize()
            rows_t, mags = T.train_rows_plain(*args, dtype, magnitudes=True)
            sums_t = reduce_rows_plain(rows_t, plan, D + T.GEOM_GRADS)
            sums_m = reduce_rows_plain(mags, plan, D + T.GEOM_GRADS)
            a, g_rows, e_rows = T.grad_rows_error(rows_k, rows_t, D, mags)
            _, g_sums, e_sums = T.grad_rows_error(sums_k, sums_t, D, sums_m)
            print(f"phase 2 ts={ts} D={D} B5 train_bwd {dtype}: rows max abs {a:.3e}, "
                  f"{g_rows:.3e} of column-group max, {e_rows:.3e} of the entry's magnitude; "
                  f"B3 sums {g_sums:.3e} and {e_sums:.3e}", flush=True)
            check(within_grad_tol(g_rows, e_rows, dtype)
                  and within_grad_tol(g_sums, e_sums, dtype),
                  "B5 rows and their sums within GRAD_ROWS_TOL of the twins")
    check(seen_exit, "a tile that exits early")
    check(seen_empty, "an empty tile")

    # the autograd Function end to end, with a background and the absgrad probe
    ts, D = 16, 20
    vm, Km = cams.viewmats[1], cams.Ks[1]
    proj = project(scene.means, scene.quats, scene.scales, scene.opacities, vm, Km, W, H)
    plan = build_plan(proj, W, H, ts)
    opac = torch.where(proj.valid, proj.opacities, torch.zeros_like(proj.opacities))
    colors = torch.rand((scene.num_gaussians, D), device="cuda", generator=gen)
    bg = torch.rand((D,), device="cuda", generator=gen)
    r = torch.randn((H, W, D), device="cuda", generator=gen)
    s = torch.randn((H, W), device="cuda", generator=gen)

    def grads(device):
        ins = [t.detach().to(device).requires_grad_()
               for t in (proj.means2d, proj.conics, opac, colors, bg)]
        probe = torch.zeros((scene.num_gaussians, 2), device=device, requires_grad=True)
        p = plan if device == "cuda" else _plan_to(plan, device)
        img, alpha = T.render_plan_train(*ins[:4], p, background=ins[4], abs_probe=probe)
        loss = (img * r.to(device)).sum() + (alpha * s.to(device)).sum()
        return [x.cpu() for x in torch.autograd.grad(loss, ins + [probe])]

    got, ref = grads("cuda"), grads("cpu")
    worst = 0.0
    for name, a, b in zip(("means2d", "conics", "opacities", "colors", "background",
                           "absgrad"), got, ref):
        if name not in ("means2d", "conics", "absgrad"):  # one scale for all entries
            a, b = a.reshape(-1, 1), b.reshape(-1, 1)
        scale = b.abs().amax(0).clamp_min(torch.finfo(torch.float32).tiny)
        worst = max(worst, float(((a - b).abs().amax(0) / scale).max()))
    print(f"phase 2 render_plan_train (background, absgrad) on the kernels against the "
          f"twins on the CPU: every gradient column within {worst:.3e} of its max", flush=True)
    check(worst <= 3e-4, "render_plan_train gradients within 3e-4 of each column's max")


def walked_pairs(geom, plan, trans_eps):
    """(pixel-Gaussian pairs walked, those with a nonzero weight, those with
    a nonzero alpha) over every tile, by the twins' walk."""
    from tpugs_torch.raster.kernels import _all_tiles, _walk_blocks

    counts = torch.zeros(2, dtype=torch.int64, device=geom.device)

    def visit(st):
        counts[0] += (st.w != 0).sum()
        counts[1] += (st.terms["alpha"] != 0).sum()

    _, done = _walk_blocks(geom, plan, _all_tiles(plan, geom.device), trans_eps, visit)
    weighted, kept = counts.tolist()
    return int(done.sum()) * 128 * plan.tile_size**2, weighted, kept


def _plan_to(plan, device):
    import dataclasses

    return dataclasses.replace(plan, **{
        f.name: getattr(plan, f.name).to(device) for f in dataclasses.fields(plan)
        if isinstance(getattr(plan, f.name), torch.Tensor)})


def phase_full_width():
    """The canonical shape through the entry point. Returns the kernel
    records for phase 4."""
    from tpugs_torch.encoders.base import LinearRGBEncoder
    from tpugs_torch.lift.batch import STAGES, backproject_views, run_view
    from tpugs_torch.raster import kernels as K
    from tpugs_torch.utils.synthetic import orbit_cameras, random_scene

    scene = random_scene(N_FULL, seed=0, extent=1.0, scale_range=(0.004, 0.02), device="cuda")
    cams = orbit_cameras(VIEWS, W_FULL, H_FULL, radius=3.0, device="cuda")
    enc = LinearRGBEncoder(D_FULL, device="cuda")
    args = (scene, cams.viewmats, cams.Ks, W_FULL, H_FULL, enc)

    # warm-up view (allocator, cuBLAS, library load)
    backproject_views(scene, cams.viewmats[:1], cams.Ks[:1], W_FULL, H_FULL, enc,
                      tile_size=TILE)
    torch.cuda.synchronize()

    events = []

    def on_stage(name):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        events.append((name, ev))

    start = torch.cuda.Event(enable_timing=True)
    torch.cuda.reset_peak_memory_stats()
    K.LAUNCHES.reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    start.record()
    num, den = backproject_views(*args, tile_size=TILE, on_stage=on_stage)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = K.LAUNCHES.snapshot()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    stage_ms = dict.fromkeys(STAGES, 0.0)
    prev = start
    for name, ev in events:
        stage_ms[name] += prev.elapsed_time(ev) / VIEWS
        prev = ev
    check(bool(torch.isfinite(num).all()) and bool(torch.isfinite(den).all()),
          "num and den finite")
    lit = float((den > 0).float().mean())
    check(lit > 0, "some Gaussians have den > 0")
    for name in ("render", "adjoint", "reduce"):
        check(launches[name] >= VIEWS,
              f"{name} kernel launched at least once per view ({launches[name]})")
    stages = " ".join(f"{k}={v:.2f}" for k, v in stage_ms.items())
    print(f"phase 3 full width N={N_FULL} {W_FULL}x{H_FULL} D={D_FULL} tile={TILE} "
          f"views={VIEWS}: {1e3 * wall / VIEWS:.2f} ms/view, {VIEWS / wall:.3f} views/s, "
          f"peak {peak_gb:.2f} GB, den>0 on {100 * lit:.1f}% of Gaussians; "
          f"stage ms/view (CUDA events): {stages}; launches {launches}", flush=True)

    # 64 random tiles of view 0 against the twins
    r = run_view(scene, cams.viewmats[0], cams.Ks[0], W_FULL, H_FULL, enc, TILE)
    torch.cuda.synchronize()
    plan, D = r.plan, D_FULL
    gen = torch.Generator(device="cuda").manual_seed(0)
    tiles = torch.randperm(plan.n_tiles, device="cuda", generator=gen)[:64]
    img_t, _ = K.render_tiles_plain(r.packed, plan, tiles=tiles)
    b1 = rel_err(r.tiles[tiles], img_t)
    rows = span_rows(plan, tiles)
    rows_t = K.adjoint_rows_plain(r.packed, r.feat_tiles, plan, tiles=tiles)
    b2 = K.rows_error(r.rows[rows], rows_t[rows], D)
    gids = gaussians_of(plan, rows)
    red_t = K.reduce_rows_plain(r.rows, plan, D + 1, gaussians=gids)
    b3 = rel_err(r.sums[gids], red_t)
    b3_equal = torch.equal(r.sums[gids], red_t)
    print(f"phase 3 check on 64 tiles ({len(gids)} Gaussians): B1 rel {b1[1]:.3e}, "
          f"B2 bf16 {b2[1]:.3e} of column-group max, {b2[2]:.3e} of row max, "
          f"B3 bit-equal {b3_equal}", flush=True)
    check(b1[1] <= 1e-4, "B1 within 1e-4 on the sampled tiles")
    check(within_rows_tol(b2[1], b2[2], torch.bfloat16),
          "B2 bf16 within ROWS_TOL on the sampled tiles")
    check(b3_equal, "B3 bit-equal on the sampled Gaussians")
    del rows_t

    # times at the main path's shapes, and the bounds of this view's work
    pairs = int(r.blocks_done.sum()) * 128 * TILE * TILE
    n_tiles, T_padded, n_isects = plan.n_tiles, plan.T_padded, plan.n_isects
    tspx = TILE * TILE
    b1_ms = time_cuda(lambda: K.render_tiles(r.packed, plan), 5)
    b1_plain = time_cuda(lambda: K.render_tiles_plain(r.packed, plan), 1)
    b2_ms = time_cuda(lambda: K.adjoint_rows(r.packed, r.feat_tiles, plan), 3)
    b2_plain = time_cuda(lambda: K.adjoint_rows_plain(r.packed, r.feat_tiles, plan), 1)
    b3_ms = time_cuda(lambda: K.reduce_rows(r.rows, plan, D + 1), 5)
    b3_plain = time_cuda(lambda: K.reduce_rows_plain(r.rows, plan, D + 1), 1)
    # B3 as one library call: a CSR 0/1 matrix (Gaussian x padded row, the
    # plan's own lists) times the rows (cuSPARSE SpMM). It has no bf16-in,
    # f32-out form, so it reads the rows converted to f32 beforehand.
    with warnings.catch_warnings():  # "sparse CSR support is in beta"
        warnings.simplefilter("ignore", UserWarning)
        select = torch.sparse_csr_tensor(
            plan.gauss_offsets, plan.gauss_pos,
            torch.ones(n_isects, dtype=torch.float32, device="cuda"),
            size=(N_FULL, T_padded), check_invariants=False)
    rows32 = r.rows[:, : D + 1].float()
    lib_err = rel_err(select @ rows32, r.sums)
    b3_lib = time_cuda(lambda: select @ rows32, 5)
    print(f"phase 3 B3 library call (sparse CSR @ f32 rows): {b3_lib:.3f} ms, "
          f"{lib_err[1]:.3e} of max from the kernel's sums", flush=True)
    check(lib_err[1] <= 1e-5, "the library call computes B3's sums")
    del select, rows32

    block_bytes = int(r.blocks_done.sum()) * 128 * 64  # pack rows the walk reads

    b1_bound = bound(block_bytes + n_tiles * tspx * 5 * 4, PAIR_OPS * pairs, PEAK_F32_FLOPS)
    b2_bound = bound(block_bytes + n_tiles * tspx * D * 2 + T_padded * (D + 1) * 2,
                     2 * pairs * (D + 1), PEAK_BF16_FLOPS)
    b3_bound = bound(n_isects * ((D + 1) * 2 + 4) + N_FULL * ((D + 1) * 4 + 4),
                     n_isects * (D + 1), PEAK_F32_FLOPS)
    print(f"phase 3 work of one view: {n_tiles} tiles, {n_isects} intersections, "
          f"T_padded {T_padded}, {int(r.blocks_done.sum())} blocks walked "
          f"({pairs} pixel-Gaussian pairs)", flush=True)

    return [
        rec("B1", "render", "tpugs_torch/csrc/render.cu",
            "tpugs/raster/pallas_tiled.py:1328", launches["render"], b1, b1_ms,
            b1_plain, b1_bound),
        rec("B2", "adjoint", "tpugs_torch/csrc/adjoint.cu",
            "tpugs/raster/pallas_tiled.py:1573", launches["adjoint"], b2, b2_ms,
            b2_plain, b2_bound),
        rec("B3", "reduce", "tpugs_torch/csrc/reduce.cu",
            "tpugs/raster/pallas_tiled.py:2178", launches["reduce"], b3, b3_ms,
            b3_plain, b3_bound, b3_lib),
    ]


# The garden-scale feature-3DGS train step (scripts/bench_train_step.py's
# configuration): 2^19 Gaussians from seed-0 uniform points, 1296 x 840,
# 8 orbit cameras, feature_dim 128 against a linear:512 teacher in bf16,
# SH 3, strategy none, tile 32, f32 gradient rows, trans_eps 1e-4.
TRAIN_CAMS, TRAIN_WARMUP, TRAIN_STEPS = 8, 3, 10


def phase_train():
    """The train step at full width through ``Trainer.train_chunk``: 3
    warm-up steps (SH degrees 0-2, sh_degree_interval 1), then 10 timed
    steps at degree 3. Returns the kernel records of B4, B5 and B3 on the
    train rows."""
    import dataclasses

    import numpy as np

    from tpugs_torch.encoders import get_encoder
    from tpugs_torch.raster import kernels as K
    from tpugs_torch.raster import train as T
    from tpugs_torch.raster.tiles import image_to_tiles
    from tpugs_torch.train.config import TrainConfig
    from tpugs_torch.train.trainer import STAGES, Trainer, init_scene_from_points
    from tpugs_torch.utils.synthetic import orbit_cameras

    n, w, h = N_FULL, W_FULL, H_FULL
    t0 = time.perf_counter()
    rng = np.random.default_rng(0)
    pts = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    rgbs = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    cams = orbit_cameras(TRAIN_CAMS, w, h, radius=3.0, device="cuda")
    images = torch.from_numpy(
        rng.uniform(0, 1, (TRAIN_CAMS, h, w, 3)).astype(np.float32)).cuda()
    cam_idx = rng.integers(0, TRAIN_CAMS, TRAIN_WARMUP + TRAIN_STEPS + 1)
    cfg = TrainConfig(max_steps=30_000, sh_degree=3, feature_dim=128, feature_out_dim=512,
                      strategy="none", random_bkgd=False, sh_degree_interval=1)
    tr = Trainer(cfg, init_scene_from_points(pts, rgbs, cfg), 1.0,
                 teacher=get_encoder("linear:512"), width=w, height=h, n_cameras=TRAIN_CAMS)
    staged = {"images": images, "viewmats": cams.viewmats, "Ks": cams.Ks}
    initial = {f.name: getattr(tr.scene, f.name).detach().clone()
               for f in dataclasses.fields(tr.scene)}
    print(f"phase 4 train set-up (init_scene_from_points with kNN scales, Trainer): "
          f"{time.perf_counter() - t0:.1f} s; tile {tr.tile_size}, rows "
          f"{cfg.pallas_contrib_dtype}, D = 3 + {cfg.feature_dim}", flush=True)
    warm = tr.train_chunk(staged, TRAIN_WARMUP, cam_idx[:TRAIN_WARMUP])
    torch.cuda.synchronize()

    events = []

    def on_stage(name):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        events.append((name, ev))

    start = torch.cuda.Event(enable_timing=True)
    tr.on_stage = on_stage
    torch.cuda.reset_peak_memory_stats()
    K.LAUNCHES.reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    start.record()
    out = tr.train_chunk(staged, TRAIN_STEPS, cam_idx[TRAIN_WARMUP:-1])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = K.LAUNCHES.snapshot()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    tr.on_stage = None

    stage_ms = dict.fromkeys(STAGES, 0.0)
    prev = start
    for name, ev in events:
        stage_ms[name] += prev.elapsed_time(ev) / TRAIN_STEPS
        prev = ev
    losses = np.concatenate([warm["loss"], out["loss"]])
    check(bool(np.isfinite(losses).all()), "every loss finite")
    for f in dataclasses.fields(tr.scene):
        check(not torch.equal(getattr(tr.scene, f.name).detach(), initial[f.name]),
              f"parameter {f.name} changed")
    for name in ("train_fwd", "train_bwd", "reduce"):
        check(launches[name] >= TRAIN_STEPS,
              f"{name} kernel launched at least once per step ({launches[name]})")
    stages = " ".join(f"{k}={v:.2f}" for k, v in stage_ms.items())
    print(f"phase 4 train N={n} {w}x{h} D=131 (feature 128 -> teacher 512) tile="
          f"{tr.tile_size} steps={TRAIN_STEPS} at SH 3: {1e3 * wall / TRAIN_STEPS:.2f} ms/step, "
          f"{TRAIN_STEPS / wall:.3f} steps/s, peak {peak_gb:.2f} GB; losses "
          f"{' '.join(f'{x:.4f}' for x in losses)}; stage ms/step (CUDA events): {stages}; "
          f"launches {launches}", flush=True)

    # One more step, recorded: the main path's own kernel inputs and
    # outputs for the checks and times below.
    tr.record = seen = {}
    tr.train_chunk(staged, 1, cam_idx[-1:])
    tr.record = None
    torch.cuda.synchronize()
    geom, cols, plan, eps, img, alpha, done, g, hterm, grem0, dtype, rows = (seen[k] for k in (
        "geom", "cols", "plan", "trans_eps", "image", "alpha", "blocks_done", "g_image",
        "hterm", "grem0", "contrib_dtype", "rows"))
    D = cols.shape[1]
    sums = K.reduce_rows(rows, plan, D + T.GEOM_GRADS)

    # 64 random tiles against the twins
    gen = torch.Generator(device="cuda").manual_seed(0)
    tiles = torch.randperm(plan.n_tiles, device="cuda", generator=gen)[:64]
    img_t, alpha_t, done_t = T.train_tiles_plain(geom, cols, plan, eps, tiles)
    inside = image_to_tiles(torch.ones((h, w, 1), device="cuda"), plan.tile_size)[tiles] > 0
    b4 = rel_err(torch.where(inside, image_to_tiles(img, plan.tile_size)[tiles], 0.0),
                 torch.where(inside, img_t, 0.0))
    b4_alpha = rel_err(torch.where(inside[..., 0], image_to_tiles(
        alpha[..., None], plan.tile_size)[tiles][..., 0], 0.0),
        torch.where(inside[..., 0], alpha_t, 0.0))
    span = span_rows(plan, tiles)
    rows_t, mags = T.train_rows_plain(geom, cols, g, hterm, grem0, done, plan, dtype, tiles,
                                      magnitudes=True)
    b5 = T.grad_rows_error(rows[span], rows_t[span], D, mags[span])
    gids = gaussians_of(plan, span)
    red_t = K.reduce_rows_plain(rows, plan, D + 8, gaussians=gids)
    b3 = rel_err(sums[gids], red_t)
    b3_equal = torch.equal(sums[gids], red_t)
    same_exit = torch.equal(done[tiles], done_t)
    print(f"phase 4 check on 64 tiles ({len(gids)} Gaussians): B4 image rel {b4[1]:.3e}, "
          f"alpha rel {b4_alpha[1]:.3e}, exit blocks equal {same_exit}; B5 {dtype} rows "
          f"{b5[1]:.3e} of column-group max, {b5[2]:.3e} of the entry's magnitude; "
          f"B3 bit-equal {b3_equal}", flush=True)
    check(b4[1] <= 1e-4 and b4_alpha[1] <= 1e-4 and same_exit,
          "B4 within 1e-4 of its twin on the sampled tiles")
    check(within_grad_tol(b5[1], b5[2], dtype),
          "B5 rows within GRAD_ROWS_TOL on the sampled tiles")
    check(b3_equal, "B3 bit-equal on the sampled Gaussians")
    del rows_t, mags, img_t

    # times at the main path's shapes, and the bounds of this step's work
    walked = int(done.sum())
    pairs, weighted, kept = walked_pairs(geom, plan, eps)
    check(pairs == walked * 128 * plan.tile_size**2, "the twin's walk takes the kernel's blocks")
    n_isects, t_padded, width = plan.n_isects, plan.T_padded, rows.shape[1]
    b4_ms = time_cuda(lambda: T.train_forward(geom, cols, plan, eps), 5)
    b4_plain = time_cuda(lambda: T.train_forward_plain(geom, cols, plan, eps), 1)
    b5_ms = time_cuda(lambda: T.train_rows(geom, cols, g, hterm, grem0, done, plan, dtype),
                      3)
    b5_plain = time_cuda(
        lambda: T.train_rows_plain(geom, cols, g, hterm, grem0, done, plan, dtype), 1)
    b5_bf16 = time_cuda(lambda: T.train_rows(geom, cols, g, hterm, grem0, done, plan,
                                             torch.bfloat16), 3)
    b3_ms = time_cuda(lambda: K.reduce_rows(rows, plan, D + 8), 5)
    b3_plain = time_cuda(lambda: K.reduce_rows_plain(rows, plan, D + 8), 1)
    with warnings.catch_warnings():  # "sparse CSR support is in beta"
        warnings.simplefilter("ignore", UserWarning)
        select = torch.sparse_csr_tensor(
            plan.gauss_offsets, plan.gauss_pos,
            torch.ones(n_isects, dtype=torch.float32, device="cuda"),
            size=(n, t_padded), check_invariants=False)
    rows_d = rows[:, : D + 8].float().contiguous()
    lib_err = rel_err(select @ rows_d, sums)
    b3_lib = time_cuda(lambda: select @ rows_d, 5)
    check(lib_err[1] <= 1e-5, "the library call computes B3's sums of the train rows")
    del select, rows_d
    walk_bytes = walked * 128 * (8 + D) * 4  # geometry and colour rows the walk reads
    # Every walked pair needs its alpha; only pairs with a nonzero weight
    # (B4) or alpha (B5) need the colour products, and B5's geometry adjoint.
    b4_bound = bound(walk_bytes + h * w * (D + 1) * 4,
                     pairs * PAIR_OPS + weighted * 2 * D, PEAK_F32_FLOPS)
    b5_bound = bound(walk_bytes + h * w * (D + 2) * 4 + 4 * plan.n_tiles
                     + t_padded * width * rows.element_size(),
                     pairs * PAIR_OPS + kept * (4 * D + PAIR_OPS), PEAK_F32_FLOPS)
    b3_bound = bound(n_isects * ((D + 8) * rows.element_size() + 4) + n * ((D + 8) * 4 + 4),
                     n_isects * (D + 8), PEAK_F32_FLOPS)
    print(f"phase 4 work of one step: {plan.n_tiles} tiles, {n_isects} intersections, "
          f"T_padded {t_padded}, {walked} blocks walked ({pairs} pixel-Gaussian pairs, "
          f"{weighted} with a nonzero weight, {kept} with a nonzero alpha); "
          f"B4 {b4_ms:.3f} ms (twin {b4_plain:.1f}), B5 {b5_ms:.3f} ms (twin {b5_plain:.1f}; "
          f"with bf16 rows {b5_bf16:.3f} ms), "
          f"B3 {b3_ms:.3f} ms (twin {b3_plain:.1f}, library {b3_lib:.3f} ms, "
          f"{lib_err[1]:.3e} of max from the kernel)", flush=True)
    return [
        rec("B4", "train_fwd", "tpugs_torch/csrc/train_fwd.cu",
            "tpugs/raster/pallas_train.py:229", launches["train_fwd"], b4, b4_ms, b4_plain,
            b4_bound),
        rec("B5", "train_bwd", "tpugs_torch/csrc/train_bwd.cu",
            "tpugs/raster/pallas_train.py:496", launches["train_bwd"], b5, b5_ms, b5_plain,
            b5_bound),
        rec("B3-train", "reduce (train rows)", "tpugs_torch/csrc/reduce.cu",
            "tpugs/raster/pallas_tiled.py:2178", launches["reduce"], b3, b3_ms,
            b3_plain, b3_bound, b3_lib),
    ]


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; no card", file=sys.stderr)
        return 1
    try:
        import tpugs_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the tpugs_torch package is not beside this script ({e})",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    phase_build()
    phase_kernels()
    phase_train_kernels()
    records = phase_full_width()
    records += phase_train()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    print(smi)
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

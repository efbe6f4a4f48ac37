#!/usr/bin/env python3
"""Drive the PyTorch port (``tpugs_torch``) on one CUDA card and check it.

    python3 chip_smoke.py        # from the repo root; one H100, nvcc on the box

Eleven phases; the first failure ends the run with a nonzero exit:

1. build   — compile ``tpugs_torch/csrc/*.cu`` for sm_90a and load them;
             B1's resident clusters by tile, with and without its cull;
             B2's by cluster size, B4's and B5's by tile and D.
2. kernels — each kernel (B1 render, B2 adjoint in f32 and bf16, B3
             reduce; B6 scatter-write adjoint and B7 stripe sum in f32 and
             bf16, each bit-equal to B2's rows and B3's sums; B4
             train_fwd, B5 train_bwd in f32 and bf16 with B3's sums of its
             rows) against its plain PyTorch twin on CUDA tensors, at mid
             shapes with edge cases: W, H not multiples of the tile, empty
             tiles, tiles that exit early, Gaussians covering many tiles
             (B1's culled walk bit-equal, image and exit blocks, to its
             unculled instantiation, each counting its own launches, and
             two launches bit-equal), D = 3, 20 and 131 (B4 and B5 also at 256, their cluster
             kernels' widest, and 300, their wide kernels; each width's
             launch counters; B4's alpha and exit blocks bit-equal to its
             wide kernel's; two launches bit-equal); S1's
             asynchronous-copy probe returns 19;
             then ``render_plan_train`` with a background and the absgrad
             probe against the same call on the CPU; B2 and B6 at D = 200,
             300, 600, 1100 (B2's clusters of 2, 3, 5, 5 CTAs), tiles 16
             and 32, f32 and bf16 (B2 against its twin, B6 bit-equal); B5's
             geometry-only launch (``train_geom_rows``) at D = 515 and 1030
             against its twin, and its columns 0:6 against the sums of the
             chunked B5 launches' geometry.
3. full width — the canonical back-projection shape (N = 2^19 Gaussians,
             1296 x 840, D = 512, tile 32, linear encoder, 8 orbit views
             after one warm-up view) through ``backproject_views``, with the
             default reduce engine and then with ``reduce_engine="scatter"``
             (``num`` and ``den`` must be equal bit for bit); per-stage
             CUDA-event times, ms/view, views/s, peak memory; 64 random
             tiles of one view held against the twins; each engine's kernels
             must have launched at least once per view; B1 bit-equal to its
             unculled instantiation on every tile of the view, and the
             view's walked, live-rectangle and nonzero-alpha pairs, counted
             by the twin's walk, for B1's two bounds.
   experiments — S1 (``experiments/scatter_write.py``): the six variants
             at 15360 blocks against their twins, with their times and
             ``index_copy_``'s; S2 (``experiments/reduce_tail.py``): the
             reduce's passes on the canonical view's rows, with their times.
4. training — the garden-scale feature-3DGS train step (2^19 Gaussians,
             1296 x 840, 131 rendered channels, a 512-d teacher, SH 3,
             tile 32) through ``Trainer.train_chunk``: 3 warm-up steps, 10
             timed steps at SH 3; ms/step, steps/s, peak memory, per-stage
             CUDA-event times; the loss finite, every parameter moved, B4,
             B5 and B3 launched every step; 64 random tiles of one step held
             against the twins.
5. raster API and eager lift — the canonical lift shape (N = 2^19,
             1296 x 840, D = 512, 8 orbit views) at tile 16 with no early
             exit (the reference's tiled path): ``create_feature_field``
             (B4 renders, B2 with f32 rows and B3 lift; ms/view, peak
             memory, launches), ``prune_by_gradients`` (B2 on one zero
             channel, B3) on the scene plus 10 opaque Gaussians planted
             outside every view, which must be exactly the ones removed,
             then ``verify_pruning_equivalence`` (B4; max pixel error under
             1/510), one ``rasterize`` in RGB+ED with a
             background forward and backward (B4; B5 and B3; ms, peak,
             every gradient finite and nonzero); 64 random tiles hold B4,
             B2 and B3 (view 0) and B5 (the rasterize render) against their
             twins at trans_eps 0; the kernels' times and bounds on this
             path's walked pairs. Then ``render_tiled`` at D = 515 with a
             background and the absgrad probe at view 0, forward and
             backward (ms, peak; B5's geometry-only launch once, rebuilt
             from the render's inputs it gives the probe's gradient bit for
             bit, 64 tiles against the twin, its time against its bound).
6. app     — ``tpugs_torch.apps.backproject.main`` from files on disk: the
             canonical scene plus 10 opaque Gaussians outside every view
             as a gsplat ``.pt``, a COLMAP model of the 8 orbit views whose
             points3D.bin holds the scene's 2^19 points, ``linear:512``, the
             ``pallas`` engine; seconds of load, prune, verify, lift and
             save (each wrapped and timed) and the rest, peak memory, exactly the 10 planted Gaussians pruned with
             max pixel error 0, the saved features bit-equal to
             ``backproject_views`` + ``normalize_field`` on the pruned scene
             and loaded cameras, the native reader used and equal to the
             pure one (both timed), the loaded poses within 1e-5.
7. LSeg lift — the paper's lift at the canonical shape: ``LSegEncoder``
             (ViT-L/16, 24 blocks, width 1024, 901 tokens, + the DPT head,
             512-d) in bf16 with seeded random weights (build time,
             parameters); the encoder alone on view 0's render (median
             pre-resize, network and post times, peak, its bound from the
             FLOPs its layers count, and its bf16 output against the same
             weights in f32: per-pixel cosine and max abs error, held to
             stated bounds); ``backproject_views_split`` in groups of 2 with
             both engines (ms/view, views/s, render / encode / adjoint+reduce,
             peak, launches): ``den`` bit-equal to phase 3's, "scatter"
             bit-equal to "pallas", ``num`` against ``backproject_views``
             with the same encoder; B2 and B3 on the LSeg features held on
             64 tiles with their times and bounds; ``DinoEncoder`` (ViT-L/14
             with registers, 896^2, D = 1024) on 2 views: its times, ``den``
             bit-equal to phase 3's path on those views, B2 and B3 at
             D = 1024 on 64 tiles; the CLIP text tower (width 512, 12
             layers, context 77) on random ids: time, finite (P, 512).
8. queries and edits — on phase 7's LSeg-512 field (normalised) at the
             canonical shape: segmentation with 2 + 1 positive queries (the
             random-weight CLIP tower on seeded ids, one exemplar Gaussian)
             and 3 negative ones, 10 field rows planted on each side that
             must be selected and left out exactly, ``get_mask3d`` against
             float64 on the host outside ties (margin 1e-5, the count
             printed), ``apply_mask3d``, ``render_to_gif`` of the extracted
             (checkerboard) and deleted scenes and ``render_mask_2d_to_gif``
             (B4 at D = 3 and 512; ms/view, peaks, launches), view 0's
             pixel mask against float64, ``segment_by_opacity(~mask)``
             rendering the deleted scene within 1/510; the D = 512 feature
             render (B4-viz) against its twin on 64 tiles, timed, with its
             bound; ``train_codec`` on the card (steps/s, the loss falls);
             the compressed lift (``CompressedEncoder`` over ``linear:512``,
             pallas engine: ms/view, peak, ``den`` against phase 3's, ``num``
             against phase 3's ``num @ encoder`` within its bf16 bound);
             ``render_pca`` in both modes (ms/view, colours in [0, 1]; the
             fit on a 65,536-row subset against numpy's up to sign);
             ``transfer_affordance`` with a 64-exemplar bank (time, labels
             against float64 outside ties, k = 1 keeps each exemplar's
             label), ``colorize_by_labels``, ``render_label_masks`` (B4 at
             D = 8) and ``evaluate_iou``; ``vote_gradient`` with all-ones
             and all-zeros masks on view 0.
9. training loop — the port's train loop (``apps.train.run``) at the
             garden train shape: phase 4's initial scene (2^19 Gaussians,
             1296 x 840, features 128 against ``linear:512`` in bf16, SH 3,
             tile 32), 10 orbit views at radius 3 (8 to train, 2 to
             validate) with targets rendered from the canonical seed-0
             scene. Leg A, chunked, 40 steps: strategy "default"
             (capacity 16384; refines at steps 10 and 20, the opacity
             reset at 20), pose and appearance optimisation, a random
             background, evals with LPIPS (random AlexNet weights) and
             checkpoints at 20 and at the end. After each refine: N is
             the refined count padded to 16384, that count is kept +
             duplicated + 2 x split, no padded row is valid in
             ``project`` in any view, ``GradState`` is zero, the optimizer
             state empty, and the same refine on CPU copies (scene,
             statistics, a copy of the generator) gives the same counts
             and masks, rows within 1e-6; after the reset the opacities'
             state is empty and every logit at most logit(0.01); the step
             after the second refine is recorded and B4, B5 and B3 held on
             64 tiles and timed against their bounds at the grown N;
             ms/step per chunk, each refine's ms (host draws and the
             rest), N before and after, peak memory; a full checkpoint
             saved, loaded into a fresh trainer bit for bit (seconds of
             each) and stepped; each validation image's render, PSNR+SSIM
             and LPIPS ms; ``render_traj`` with no path. Leg B: strategy
             "mcmc" through the per-step path, 21 steps, refines at 10 and
             20 with 4096 planted dead Gaussians: N stays 2^19, the
             relocated count is the dead count, the state empty; ms/step.
10. kernels line — one JSON object per kernel with its launches, errors,
             time, the twin's time, its bound on this card and, where one
             exists, the time of one library call that computes the same
             function (a sparse CSR product for B3, B7 and S2; S1's
             ``index_copy_``); phase 5's four kernels as B4-, B2-, B3- and
             B5-tiled, B5's geometry-only launch as B5-geom, phase 7's
             as B2-lseg, B3-lseg, B2-dino and B3-dino, phase 8's
             feature render as B4-viz, and phase 9's as B4-, B5- and
             B3-refined.

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

import numpy as np
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


def span_rows(plan, tiles: torch.Tensor) -> torch.Tensor:
    """Padded row indices of the spans of ``tiles``."""
    count = (plan.tile_ends[tiles] - plan.tile_starts[tiles]).long()
    length = (count + 127) // 128 * 128
    start = plan.padded_starts[tiles].long()
    owner = torch.repeat_interleave(torch.arange(len(tiles), device=tiles.device), length)
    first = torch.cumsum(length, 0) - length
    return start[owner] + torch.arange(int(length.sum()), device=tiles.device) - first[owner]


def tile_inside(h, w, ts, tiles):
    """(k, ts*ts, 1) True on the pixels of ``tiles`` inside the image."""
    from tpugs_torch.raster.tiles import image_to_tiles

    return image_to_tiles(torch.ones((h, w, 1), device="cuda"), ts)[tiles] > 0


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
    lib = load_library()
    resident = {(ts, cull): lib.tpugs_render_max_clusters(ts, cull)
                for ts in (16, 32) for cull in (1, 0)}
    print(f"phase 1 B1: resident clusters by (tile, cull) (cudaOccupancyMaxActiveClusters; "
          f"clusters of 1 and 4 CTAs): {resident}", flush=True)
    check(all(n > 0 for n in resident.values()), "B1 clusters fit on the card")
    for bf16, name in ((1, "bf16"), (0, "f32")):
        resident = {c: lib.tpugs_adjoint_max_clusters(bf16, c) for c in (1, 2, 3, 5, 6, 8)}
        print(f"phase 1 B2 {name}: resident clusters by cluster size "
              f"(cudaOccupancyMaxActiveClusters): {resident}", flush=True)
        check(all(n > 0 for n in resident.values()), f"B2 {name} clusters fit on the card")
        resident = {(ts, d): lib.tpugs_train_bwd_max_clusters(bf16, ts, d)
                    for ts, d in ((32, 3), (32, 131), (32, 256), (16, 131), (16, 256))}
        print(f"phase 1 B5 {name} rows: resident clusters by (tile, D) "
              f"(cudaOccupancyMaxActiveClusters): {resident}", flush=True)
        check(all(n > 0 for n in resident.values()), f"B5 {name} clusters fit on the card")
    resident = {(ts, d): lib.tpugs_train_fwd_max_clusters(ts, d)
                for ts, d in ((32, 3), (32, 131), (32, 256), (16, 131), (16, 256))}
    print(f"phase 1 B4: resident clusters by (tile, D) (cudaOccupancyMaxActiveClusters): "
          f"{resident}", flush=True)
    check(all(n > 0 for n in resident.values()), "B4 clusters fit on the card")


def phase_kernels():
    """Kernels against twins at mid shapes; returns nothing, raises on a
    disagreement."""
    from tpugs_torch.encoders.base import LinearRGBEncoder
    from tpugs_torch.raster import kernels as K
    from tpugs_torch.raster.colors import prepare_colors
    from tpugs_torch.raster.pack import pack_isect_all
    from tpugs_torch.experiments.scatter_write import async_copy_probe
    from tpugs_torch.raster.plan import build_plan, with_scatter_extras
    from tpugs_torch.raster.projection import project
    from tpugs_torch.utils.synthetic import orbit_cameras, random_scene

    W, H = 300, 200
    scene = random_scene(20000, seed=1, extent=0.6, scale_range=(0.01, 0.12), device="cuda")
    cams = orbit_cameras(2, W, H, radius=3.0, device="cuda")
    got = int(async_copy_probe(torch.arange(64, dtype=torch.int32, device="cuda"), 2))
    print(f"phase 2 S1 probe: cp.async of 8 int32 at a dynamic offset into shared "
          f"memory returns {got}", flush=True)
    check(got == 19, "the S1 probe returns 19")
    for ts, D, view in ((32, 64, 0), (16, 20, 1)):
        vm, Km = cams.viewmats[view], cams.Ks[view]
        proj = project(scene.means, scene.quats, scene.scales, scene.opacities, vm, Km, W, H)
        plan = build_plan(proj, W, H, ts)
        packed = pack_isect_all(
            proj, prepare_colors(scene.means, scene.colors_all, vm, scene.sh_degree), plan)
        spans = plan.tile_ends - plan.tile_starts
        covers = plan.gauss_offsets[1:] - plan.gauss_offsets[:-1]

        K.LAUNCHES.reset()
        img_k, done_k = K.render_tiles(packed, plan)
        img_u, done_u = K.render_tiles_unculled(packed, plan)
        again = K.render_tiles(packed, plan)
        torch.cuda.synchronize()
        counts = (K.LAUNCHES.render, K.LAUNCHES.render_unculled)
        img_t, done_t = K.render_tiles_plain(packed, plan)
        nb = (spans + 127) // 128
        check(bool((spans == 0).any()), "an empty tile")
        check(bool((done_t < nb).any()), "a tile that exits early")
        check(int(covers.max()) >= 6, "a Gaussian covering many tiles")
        a, r = rel_err(img_k, img_t)
        _, r_u = rel_err(img_u, img_t)
        culled = torch.equal(img_k, img_u) and torch.equal(done_k, done_u)
        same = torch.equal(img_k, again[0]) and torch.equal(done_k, again[1])
        # The twin's transmittance is a cumprod, whose order of products the
        # library chooses, and its exp is torch's: a tile whose largest T
        # lies within rounding of trans_eps may exit one block apart.
        print(f"phase 2 ts={ts} B1 render: max abs {a:.3e} rel {r:.3e} (unculled rel "
              f"{r_u:.3e}); culled bit-equal to unculled (image and exit blocks) {culled}, "
              f"two launches bit-equal {same}, launches (render, render_unculled) {counts}; "
              f"exit blocks differ from the twin's on {int((done_k != done_t).sum())} tiles",
              flush=True)
        check(r <= 1e-4 and r_u <= 1e-4, "B1 within 1e-4 relative of its twin")
        check(culled, "B1's culled walk bit-equal to its unculled instantiation")
        check(same, "two B1 launches bit-equal")
        check(counts == (2, 1), "each B1 instantiation counts its own launches")

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

        # B6 and B7 on the same inputs, through the plan's scatter extras
        splan = with_scatter_extras(plan)
        real = splan.gauss_pos.long()
        live = splan.slot_pos.long()[real]
        for f, rows in ((feats, rows32), (fbf, rows_bf)):
            striped = K.adjoint_scatter_rows(packed, f, splan)
            torch.cuda.synchronize()
            striped_t = K.adjoint_scatter_rows_plain(packed, f, splan)
            a, g, r = K.rows_error(striped[live], striped_t[live], D)
            b6_b2 = torch.equal(striped[live], rows[real])
            sums = K.reduce_striped(striped, splan, D + 1)
            cols = K.reduce_striped(striped, splan, D + 1, unpermute=False)
            torch.cuda.synchronize()
            b7_twin = torch.equal(sums, K.reduce_striped_plain(striped, splan, D + 1))
            b7_b3 = torch.equal(sums, K.reduce_rows(rows, plan, D + 1))
            b7_cols = torch.equal(cols, sums[splan.slot_order])
            print(f"phase 2 ts={ts} D={D} B6 adjoint_scatter {f.dtype}: {len(live)} live "
                  f"striped rows of {splan.R_striped + 1}, max abs {a:.3e}, {g:.3e} of "
                  f"column-group max, {r:.3e} of row max, bit-equal to B2's rows {b6_b2}; "
                  f"B7 stripe_sum bit-equal to twin {b7_twin}, to B3 {b7_b3}, "
                  f"column order {b7_cols}", flush=True)
            check(within_rows_tol(g, r, f.dtype), "B6 rows within ROWS_TOL of its twin")
            check(b6_b2, "B6's rows bit-equal to B2's through slot_pos")
            check(b7_twin and b7_b3 and b7_cols,
                  "B7 bit-equal to its twin and to B3 on the same rows")


CLUSTER_D = (200, 300, 600, 1100)  # S = 2, 3, 5, 9 slices: clusters of 2, 3, 5, 5 CTAs


def phase_clusters():
    """B2 and B6 at widths whose channel slices make clusters of 2, 3, 5
    and 5 CTAs (at D = 1100 two clusters per tile, one CTA without
    columns), tiles 16 and 32, f32 and bf16: B2 within ROWS_TOL of its
    twin, B6 bit-equal to B2."""
    from tpugs_torch.encoders.base import LinearRGBEncoder
    from tpugs_torch.raster import kernels as K
    from tpugs_torch.raster.colors import prepare_colors
    from tpugs_torch.raster.pack import pack_isect_all
    from tpugs_torch.raster.plan import build_plan, with_scatter_extras
    from tpugs_torch.raster.projection import project
    from tpugs_torch.utils.synthetic import orbit_cameras, random_scene

    W, H = 300, 200
    scene = random_scene(20000, seed=1, extent=0.6, scale_range=(0.01, 0.12), device="cuda")
    cams = orbit_cameras(1, W, H, radius=3.0, device="cuda")
    vm, Km = cams.viewmats[0], cams.Ks[0]
    proj = project(scene.means, scene.quats, scene.scales, scene.opacities, vm, Km, W, H)
    cols3 = prepare_colors(scene.means, scene.colors_all, vm, scene.sh_degree)
    for ts in (16, 32):
        plan = build_plan(proj, W, H, ts)
        splan = with_scatter_extras(plan)
        packed = pack_isect_all(proj, cols3, plan)
        img, _ = K.render_tiles(packed, plan)
        real = splan.gauss_pos.long()
        live = splan.slot_pos.long()[real]
        for D in CLUSTER_D:
            c, grid_x = K.adjoint_cluster(K.contrib_width(D))
            feats = LinearRGBEncoder(D, seed=3, device="cuda")(img[..., :3]).contiguous()
            for dtype in (torch.float32, torch.bfloat16):
                f = feats.to(dtype)
                rows = K.adjoint_rows(packed, f, plan)
                striped = K.adjoint_scatter_rows(packed, f, splan)
                torch.cuda.synchronize()
                a, g, r = K.rows_error(rows, K.adjoint_rows_plain(packed, f, plan), D)
                same = torch.equal(striped[live], rows[real])
                print(f"phase 2 clusters ts={ts} D={D} (C={c}, grid x {grid_x}) B2 {dtype}: "
                      f"max abs {a:.3e}, {g:.3e} of column-group max, {r:.3e} of row max; "
                      f"B6 bit-equal to B2 {same}", flush=True)
                check(within_rows_tol(g, r, dtype), "B2 rows within ROWS_TOL of the twin")
                check(same, "B6's rows bit-equal to B2's")


def within_grad_tol(of_group: float, of_entry: float, dtype) -> bool:
    from tpugs_torch.raster.train import GRAD_ROWS_TOL

    group_tol, entry_tol = GRAD_ROWS_TOL[dtype]
    return of_group <= group_tol and of_entry <= entry_tol


# (tile, D, view) of phase 2's train kernels: B4's and B5's cluster kernels
# in clusters of 8 (tile 32) and 2 (tile 16) CTAs up to D = 256, their wide
# kernels above (train_fwd_cluster, train_cluster)
TRAIN_KERNEL_SHAPES = ((32, 131, 0), (16, 20, 1), (32, 3, 1), (16, 131, 0), (32, 256, 0),
                       (16, 300, 1), (32, 300, 1))


def phase_train_kernels():
    """B4 and B5 (f32 and bf16 rows, and B3's sums of them) against their
    twins at mid shapes, then one ``render_plan_train`` with a background
    and the absgrad probe against the same call on CPU copies (the twins)."""
    from tpugs_torch.kernels.build import load_library
    from tpugs_torch.raster import kernels as K
    from tpugs_torch.raster import train as T
    from tpugs_torch.raster.kernels import reduce_rows, reduce_rows_plain
    from tpugs_torch.raster.plan import build_plan
    from tpugs_torch.raster.projection import project
    from tpugs_torch.utils.synthetic import orbit_cameras, random_scene

    W, H = 300, 200
    scene = random_scene(20000, seed=1, extent=0.6, scale_range=(0.01, 0.12), device="cuda")
    cams = orbit_cameras(2, W, H, radius=3.0, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(5)
    lib = load_library()
    seen_exit = seen_empty = False
    for ts, D, view in TRAIN_KERNEL_SHAPES:
        vm, Km = cams.viewmats[view], cams.Ks[view]
        proj = project(scene.means, scene.quats, scene.scales, scene.opacities, vm, Km, W, H)
        plan = build_plan(proj, W, H, ts)
        opac = torch.where(proj.valid, proj.opacities, torch.zeros_like(proj.opacities))
        colors = torch.rand((scene.num_gaussians, D), device="cuda", generator=gen)
        geom, cols = T.pack_train(proj.means2d, proj.conics, opac, colors, plan)
        spans = plan.tile_ends - plan.tile_starts
        nb = (spans + 127) // 128

        K.LAUNCHES.reset()
        img_k, alpha_k, done_k = T.train_forward(geom, cols, plan)
        torch.cuda.synchronize()
        fwd_cluster = T.train_fwd_cluster(ts, D)
        launched = (K.LAUNCHES.train_fwd, K.LAUNCHES.train_fwd_wide)
        check(launched == ((0, 1) if fwd_cluster is None else (1, 0)),
              f"B4 at D = {D} launched the kernel its width selects ({launched})")
        again = T.train_forward(geom, cols, plan)
        img_w, alpha_w, done_w = T._launch_train_fwd(lib, geom, cols, plan, K.TRANS_EPS, None)
        torch.cuda.synchronize()
        same = all(torch.equal(a, b) for a, b in zip((img_k, alpha_k, done_k), again))
        as_wide = torch.equal(alpha_k, alpha_w) and torch.equal(done_k, done_w)
        _, r_wide = rel_err(img_k, img_w)
        img_t, alpha_t, done_t = T.train_forward_plain(geom, cols, plan)
        seen_exit |= bool((done_t < nb).any())
        seen_empty |= bool((spans == 0).any())
        _, r_img = rel_err(img_k, img_t)
        _, r_alpha = rel_err(alpha_k, alpha_t)
        kind = "wide kernel" if fwd_cluster is None else "cluster (C, P) = {}".format(fwd_cluster)
        print(f"phase 2 ts={ts} D={D} B4 train_fwd ({kind}): image rel {r_img:.3e}, alpha rel "
              f"{r_alpha:.3e} (exit blocks differ on {int((done_k != done_t).sum())} tiles); "
              f"against the wide kernel: image rel {r_wide:.3e}, alpha and exit blocks "
              f"bit-equal {as_wide}; a second launch bit-equal {same}", flush=True)
        check(r_img <= 1e-4 and r_alpha <= 1e-4, "B4 within 1e-4 relative of its twin")
        check(as_wide and r_wide <= 1e-4, "B4's alpha and exit blocks bit-equal to the wide "
              "kernel's, its image within 1e-4")
        check(same, "two B4 launches give the same outputs")

        g = torch.randn((H, W, D), device="cuda", generator=gen)
        hterm = torch.randn((H, W), device="cuda", generator=gen) * (1.0 - alpha_k)
        grem0 = (g * img_k).sum(-1)
        args = (geom, cols, g, hterm, grem0, done_k, plan)
        layout = T.train_cluster(ts, D)
        for dtype in (torch.float32, torch.bfloat16):
            K.LAUNCHES.reset()
            rows_k = T.train_rows(*args, dtype)
            sums_k = reduce_rows(rows_k, plan, D + T.GEOM_GRADS)
            torch.cuda.synchronize()
            launched = (K.LAUNCHES.train_bwd, K.LAUNCHES.train_bwd_wide)
            check(launched == ((0, 1) if layout is None else (1, 0)),
                  f"B5 at D = {D} launched the kernel its width selects ({launched})")
            same = torch.equal(T.train_rows(*args, dtype), rows_k)
            rows_t, mags = T.train_rows_plain(*args, dtype, magnitudes=True)
            sums_t = reduce_rows_plain(rows_t, plan, D + T.GEOM_GRADS)
            sums_m = reduce_rows_plain(mags, plan, D + T.GEOM_GRADS)
            a, g_rows, e_rows = T.grad_rows_error(rows_k, rows_t, D, mags)
            _, g_sums, e_sums = T.grad_rows_error(sums_k, sums_t, D, sums_m)
            kind = "one-CTA kernel" if layout is None else "cluster (C, P) = {}".format(layout)
            print(f"phase 2 ts={ts} D={D} B5 train_bwd {dtype} ({kind}): rows max abs {a:.3e}, "
                  f"{g_rows:.3e} of column-group max, {e_rows:.3e} of the entry's magnitude; "
                  f"B3 sums {g_sums:.3e} and {e_sums:.3e}; a second launch bit-equal {same}",
                  flush=True)
            check(within_grad_tol(g_rows, e_rows, dtype)
                  and within_grad_tol(g_sums, e_sums, dtype),
                  "B5 rows and their sums within GRAD_ROWS_TOL of the twins")
            check(same, "two B5 launches give the same rows")
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


# (tile, D, view) of phase 2's geometry-only B5: above the colour kernels'
# 512 channels, two and three channel chunks
TRAIN_GEOM_SHAPES = ((16, 515, 0), (32, 1030, 1))


def phase_train_geom():
    """B5's geometry-only launch (``train_geom_rows``, 8 columns, any D)
    against its twin at mid shapes, rows and B3's sums by
    ``grad_rows_error`` against GRAD_ROWS_TOL[float32]; its columns 0:6
    summed per Gaussian against the sums of the chunked ``train_rows``
    launches' geometry (chunks of MAX_CHANNELS, ``hterm`` in the first),
    within the same limits; two launches bit-equal. Only its own launch
    counter is checked."""
    from tpugs_torch.raster import kernels as K
    from tpugs_torch.raster import train as T
    from tpugs_torch.raster.plan import build_plan
    from tpugs_torch.raster.projection import project
    from tpugs_torch.utils.synthetic import orbit_cameras, random_scene

    W, H = 300, 200
    scene = random_scene(20000, seed=1, extent=0.6, scale_range=(0.01, 0.12), device="cuda")
    cams = orbit_cameras(2, W, H, radius=3.0, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(6)
    tol = T.GRAD_ROWS_TOL[torch.float32]
    for ts, D, view in TRAIN_GEOM_SHAPES:
        vm, Km = cams.viewmats[view], cams.Ks[view]
        proj = project(scene.means, scene.quats, scene.scales, scene.opacities, vm, Km, W, H)
        plan = build_plan(proj, W, H, ts)
        opac = torch.where(proj.valid, proj.opacities, torch.zeros_like(proj.opacities))
        colors = torch.rand((scene.num_gaussians, D), device="cuda", generator=gen)
        geom, cols = T.pack_train(proj.means2d, proj.conics, opac, colors, plan)
        img, alpha, done = T.train_forward(geom, cols, plan)
        g = torch.randn((H, W, D), device="cuda", generator=gen)
        hterm = torch.randn((H, W), device="cuda", generator=gen) * (1.0 - alpha)
        args = (geom, cols, g, hterm, (g * img).sum(-1), done, plan)
        K.LAUNCHES.reset()
        rows = T.train_geom_rows(*args)
        torch.cuda.synchronize()
        launched = K.LAUNCHES.train_bwd_geom
        check(launched == 1, f"train_geom_rows launched its kernel once ({launched})")
        same = torch.equal(T.train_geom_rows(*args), rows)
        sums = K.reduce_rows(rows, plan, T.GEOM_GRADS)
        rows_t, mags = T.train_rows_plain(*args, magnitudes=True, geometry_only=True)
        sums_m = K.reduce_rows_plain(mags, plan, T.GEOM_GRADS)
        a, g_rows, e_rows = T.grad_rows_error(rows, rows_t, 0, mags)
        _, g_sums, e_sums = T.grad_rows_error(
            sums, K.reduce_rows_plain(rows_t, plan, T.GEOM_GRADS), 0, sums_m)
        chunked = torch.zeros_like(sums)
        for i, (c0, c1) in enumerate(T.channel_chunks(D)):
            g_c = g[..., c0:c1].contiguous()
            rows_c = T.train_rows(geom, cols[:, c0:c1].contiguous(), g_c,
                                  hterm if i == 0 else torch.zeros_like(hterm),
                                  (g_c * img[..., c0:c1]).sum(-1), done, plan)
            chunked += K.reduce_rows(rows_c, plan, c1 - c0 + T.GEOM_GRADS)[:, c1 - c0:]
        chunked[:, 6:] = sums[:, 6:]  # the absolute columns do not add over chunks
        _, g_chunk, e_chunk = T.grad_rows_error(sums, chunked, 0, sums_m)
        print(f"phase 2 ts={ts} D={D} B5 train_geom_rows f32 ({len(T.channel_chunks(D))} "
              f"channel chunks): rows max abs {a:.3e}, {g_rows:.3e} of column-group max, "
              f"{e_rows:.3e} of the entry's magnitude; B3 sums {g_sums:.3e} and {e_sums:.3e}; "
              f"columns 0:6 against the chunked launches' geometry {g_chunk:.3e} and "
              f"{e_chunk:.3e}; a second launch bit-equal {same}", flush=True)
        check(g_rows <= tol[0] and e_rows <= tol[1] and g_sums <= tol[0] and e_sums <= tol[1],
              "B5's geometry rows and their sums within GRAD_ROWS_TOL of the twins")
        check(g_chunk <= tol[0] and e_chunk <= tol[1],
              "the geometry columns 0:6 equal the chunked launches' sums within GRAD_ROWS_TOL")
        check(same, "two geometry launches give the same rows")


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


def render_pairs(pack, plan):
    """(pixel-Gaussian pairs B1 walks unculled, those B1's culled walk
    evaluates, those with a nonzero alpha) over every tile, by the twin's
    walk with the cull."""
    from tpugs_torch.raster.kernels import TRANS_EPS, _all_tiles, _walk_blocks

    counts = torch.zeros(2, dtype=torch.int64, device=pack.device)

    def visit(st):
        counts[0] += st.terms["live"].sum()
        counts[1] += (st.terms["alpha"] != 0).sum()

    _, done = _walk_blocks(pack, plan, _all_tiles(plan, pack.device), TRANS_EPS, visit,
                           cull=True)
    live, nonzero = counts.tolist()
    return int(done.sum()) * 128 * plan.tile_size**2, live, nonzero


def _plan_to(plan, device):
    import dataclasses

    return dataclasses.replace(plan, **{
        f.name: getattr(plan, f.name).to(device) for f in dataclasses.fields(plan)
        if isinstance(getattr(plan, f.name), torch.Tensor)})


def timed_lift(args, engine: str, lift=None, **kw):
    """The 8 views through ``lift`` (default ``backproject_views``) with
    ``engine`` and keywords ``kw``: (num, den, ms/view, launches, peak GB,
    stage ms/view, peak GB within each stage)."""
    from tpugs_torch.lift.batch import STAGES, backproject_views
    from tpugs_torch.raster import kernels as K

    events = []
    stage_peak = dict.fromkeys(STAGES, 0.0)

    def on_stage(name):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        events.append((name, ev))
        stage_peak[name] = max(stage_peak[name], torch.cuda.max_memory_allocated() / 1e9)
        torch.cuda.reset_peak_memory_stats()

    start = torch.cuda.Event(enable_timing=True)
    torch.cuda.reset_peak_memory_stats()
    K.LAUNCHES.reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    start.record()
    num, den = (lift or backproject_views)(*args, tile_size=TILE, on_stage=on_stage,
                                           reduce_engine=engine, **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = K.LAUNCHES.snapshot()
    peak_gb = max([torch.cuda.max_memory_allocated() / 1e9, *stage_peak.values()])
    stage_ms = dict.fromkeys(STAGES, 0.0)
    prev = start
    for name, ev in events:
        stage_ms[name] += prev.elapsed_time(ev) / VIEWS
        prev = ev
    return num, den, 1e3 * wall / VIEWS, launches, peak_gb, stage_ms, stage_peak


def csr_select(offsets, columns, n_cols):
    """A 0/1 CSR matrix (len(offsets) - 1, n_cols) with ``columns`` listed
    row by row: one library product by it sums the selected rows."""
    with warnings.catch_warnings():  # "sparse CSR support is in beta"
        warnings.simplefilter("ignore", UserWarning)
        return torch.sparse_csr_tensor(
            offsets, columns, torch.ones(columns.shape[0], dtype=torch.float32,
                                         device=columns.device),
            size=(offsets.shape[0] - 1, n_cols), check_invariants=False)


def phase_full_width():
    """The canonical shape through the entry point, with both reduce
    engines. Returns the kernel records for the kernels line, one view's
    result for the experiments phase and the default engine's num and den
    (CPU), ms/view and peak GB for phases 7 and 8."""
    from tpugs_torch.encoders.base import LinearRGBEncoder
    from tpugs_torch.kernels.build import load_library
    from tpugs_torch.lift.batch import backproject_views, run_view
    from tpugs_torch.raster import kernels as K
    from tpugs_torch.utils.synthetic import orbit_cameras, random_scene
    from tpugs_torch.utils.timing import time_cuda

    scene = random_scene(N_FULL, seed=0, extent=1.0, scale_range=(0.004, 0.02), device="cuda")
    cams = orbit_cameras(VIEWS, W_FULL, H_FULL, radius=3.0, device="cuda")
    enc = LinearRGBEncoder(D_FULL, device="cuda")
    args = (scene, cams.viewmats, cams.Ks, W_FULL, H_FULL, enc)

    # warm-up view of each engine (allocator, cuBLAS, library load)
    for engine in ("pallas", "scatter"):
        backproject_views(scene, cams.viewmats[:1], cams.Ks[:1], W_FULL, H_FULL, enc,
                          tile_size=TILE, reduce_engine=engine)
    torch.cuda.synchronize()

    results, stats = {}, {}
    for engine, kernels in (("pallas", ("render", "adjoint", "reduce")),
                            ("scatter", ("render", "adjoint_scatter", "stripe_sum"))):
        num, den, ms_view, launches, peak_gb, stage_ms, stage_peak = timed_lift(args, engine)
        results[engine] = (num.cpu(), den.cpu(), launches)
        stats[engine] = (ms_view, peak_gb)
        check(bool(torch.isfinite(num).all()) and bool(torch.isfinite(den).all()),
              "num and den finite")
        lit = float((den > 0).float().mean())
        check(lit > 0, "some Gaussians have den > 0")
        for name in kernels:
            check(launches[name] >= VIEWS,
                  f"{name} kernel launched at least once per view ({launches[name]})")
        stages = " ".join(f"{k}={v:.2f}" for k, v in stage_ms.items())
        peaks = " ".join(f"{k}={v:.2f}" for k, v in stage_peak.items())
        print(f"phase 3 full width reduce_engine={engine} N={N_FULL} {W_FULL}x{H_FULL} "
              f"D={D_FULL} tile={TILE} views={VIEWS}: {ms_view:.2f} ms/view, "
              f"{1e3 / ms_view:.3f} views/s, peak {peak_gb:.2f} GB, den>0 on "
              f"{100 * lit:.1f}% of Gaussians; stage ms/view (CUDA events): {stages}; "
              f"peak GB within each stage: {peaks}; launches {launches}", flush=True)
        del num, den  # the next engine's peak memory is its own
    (num, den, launches), (num_s, den_s, launches_s) = results["pallas"], results["scatter"]
    ref3 = {"num": num, "den": den, "ms_view": stats["pallas"][0],
            "peak_gb": stats["pallas"][1]}
    same = torch.equal(num_s, num) and torch.equal(den_s, den)
    print(f"phase 3 reduce_engine=scatter num and den bit-equal to the default engine's: "
          f"{same}", flush=True)
    check(same, "the scatter engine's num and den equal the default engine's bit for bit")
    del num, den, num_s, den_s, results

    # 64 random tiles of view 0 against the twins
    r = run_view(scene, cams.viewmats[0], cams.Ks[0], W_FULL, H_FULL, enc, TILE)
    r_s = run_view(scene, cams.viewmats[0], cams.Ks[0], W_FULL, H_FULL, enc, TILE,
                   reduce_engine="scatter")
    torch.cuda.synchronize()
    plan, plan_s, D = r.plan, r_s.plan, D_FULL
    gen = torch.Generator(device="cuda").manual_seed(0)
    tiles = torch.randperm(plan.n_tiles, device="cuda", generator=gen)[:64]
    img_t, _ = K.render_tiles_plain(r.packed, plan, tiles=tiles)
    b1 = rel_err(r.tiles[tiles], img_t)
    rows = span_rows(plan, tiles)
    rows_t = K.adjoint_rows_plain(r.packed, r.feat_tiles, plan, tiles=tiles)
    b2 = K.rows_error(r.rows[rows], rows_t[rows], D)
    del rows_t
    gids = gaussians_of(plan, rows)
    red_t = K.reduce_rows_plain(r.rows, plan, D + 1, gaussians=gids)
    b3 = rel_err(r.sums[gids], red_t)
    b3_equal = torch.equal(r.sums[gids], red_t)
    real = rows[plan.padded_gid[rows] < plan.num_gaussians]  # rows with an intersection
    dest = plan_s.slot_pos.long()[real]
    striped_t = K.adjoint_scatter_rows_plain(r.packed, r.feat_tiles, plan_s, tiles=tiles)
    b6 = K.rows_error(r_s.rows[dest], striped_t[dest], D)
    del striped_t
    b6_b2 = torch.equal(r_s.rows[dest], r.rows[real])
    red7_t = K.reduce_striped_plain(r_s.rows, plan_s, D + 1, gaussians=gids)
    b7 = rel_err(r_s.sums[gids], red7_t)
    b7_equal = torch.equal(r_s.sums[gids], red7_t) and torch.equal(r_s.sums[gids], red_t)
    b7_b3_view = torch.equal(r_s.sums, r.sums)
    print(f"phase 3 check on 64 tiles ({len(gids)} Gaussians): B1 rel {b1[1]:.3e}, "
          f"B2 bf16 {b2[1]:.3e} of column-group max, {b2[2]:.3e} of row max, "
          f"B3 bit-equal {b3_equal}; B6 bf16 {b6[1]:.3e} of column-group max, "
          f"{b6[2]:.3e} of row max, bit-equal to B2 {b6_b2}; B7 bit-equal to its twin and "
          f"B3 {b7_equal}, on the whole view {b7_b3_view}", flush=True)
    check(b1[1] <= 1e-4, "B1 within 1e-4 on the sampled tiles")
    check(within_rows_tol(b2[1], b2[2], torch.bfloat16),
          "B2 bf16 within ROWS_TOL on the sampled tiles")
    check(b3_equal, "B3 bit-equal on the sampled Gaussians")
    check(within_rows_tol(b6[1], b6[2], torch.bfloat16),
          "B6 bf16 within ROWS_TOL on the sampled tiles")
    check(b6_b2, "B6 bit-equal to B2 on the sampled tiles")
    check(b7_equal and b7_b3_view, "B7 bit-equal to its twin and to B3")

    # B1's culled walk against its unculled instantiation on every tile
    img_u, done_u = K.render_tiles_unculled(r.packed, plan)
    torch.cuda.synchronize()
    b1_culled = torch.equal(r.tiles, img_u) and torch.equal(r.blocks_done, done_u)
    del img_u
    walked, live, nonzero = render_pairs(r.packed, plan)
    print(f"phase 3 B1 on every tile of view 0: culled bit-equal to unculled (image and "
          f"exit blocks) {b1_culled}; pairs walked {walked}, with a live 8x4 rectangle "
          f"{live} ({100 * live / walked:.1f}%), with a nonzero alpha {nonzero} "
          f"({100 * nonzero / walked:.1f}%)", flush=True)
    check(b1_culled, "B1's culled walk bit-equal to its unculled instantiation on the view")

    # times at the main path's shapes, and the bounds of this view's work
    pairs = int(r.blocks_done.sum()) * 128 * TILE * TILE
    check(pairs == walked, "the twin's walk takes the kernel's blocks")
    n_tiles, T_padded, n_isects = plan.n_tiles, plan.T_padded, plan.n_isects
    tspx = TILE * TILE
    b1_ms = time_cuda(lambda: K.render_tiles(r.packed, plan), 20)
    b1_unculled = time_cuda(lambda: K.render_tiles_unculled(r.packed, plan), 20)
    b1_plain = time_cuda(lambda: K.render_tiles_plain(r.packed, plan), 1)
    b2_ms = time_cuda(lambda: K.adjoint_rows(r.packed, r.feat_tiles, plan), 3)
    b2_plain = time_cuda(lambda: K.adjoint_rows_plain(r.packed, r.feat_tiles, plan), 1)
    b3_ms = time_cuda(lambda: K.reduce_rows(r.rows, plan, D + 1), 5)
    b3_plain = time_cuda(lambda: K.reduce_rows_plain(r.rows, plan, D + 1), 1)
    b6_ms = time_cuda(lambda: K.adjoint_scatter_rows(r.packed, r.feat_tiles, plan_s), 3)
    b6_plain = time_cuda(
        lambda: K.adjoint_scatter_rows_plain(r.packed, r.feat_tiles, plan_s), 1)
    b7_ms = time_cuda(lambda: K.reduce_striped(r_s.rows, plan_s, D + 1), 5)
    b7_plain = time_cuda(lambda: K.reduce_striped_plain(r_s.rows, plan_s, D + 1), 1)
    # B3 as one library call: a CSR 0/1 matrix (Gaussian x padded row, the
    # plan's own lists) times the rows (cuSPARSE SpMM). It has no bf16-in,
    # f32-out form, so it reads the rows converted to f32 beforehand.
    select = csr_select(plan.gauss_offsets, plan.gauss_pos, T_padded)
    rows32 = r.rows[:, : D + 1].float()
    lib_err = rel_err(select @ rows32, r.sums)
    b3_lib = time_cuda(lambda: select @ rows32, 5)
    del select, rows32
    # B7 likewise, over the striped positions; the rows it never reads are
    # zeroed in the f32 copy (B6 leaves them unwritten).
    live = plan_s.slot_pos.long()[plan_s.gauss_pos.long()]
    select = csr_select(plan_s.gauss_offsets, live.to(torch.int32), plan_s.R_striped + 1)
    striped32 = torch.zeros((plan_s.R_striped + 1, D + 1), device="cuda")
    striped32[live] = r_s.rows[live, : D + 1].float()
    lib7_err = rel_err(select @ striped32, r_s.sums)
    b7_lib = time_cuda(lambda: select @ striped32, 5)
    del select, striped32
    print(f"phase 3 library calls (sparse CSR @ f32 rows): B3 {b3_lib:.3f} ms, "
          f"{lib_err[1]:.3e} of max from the kernel's sums; B7 (striped positions) "
          f"{b7_lib:.3f} ms, {lib7_err[1]:.3e}", flush=True)
    check(lib_err[1] <= 1e-5 and lib7_err[1] <= 1e-5, "the library calls compute the sums")

    block_bytes = int(r.blocks_done.sum()) * 128 * 64  # pack rows the walk reads
    b2_bytes = block_bytes + n_tiles * tspx * D * 2 + T_padded * (D + 1) * 2

    # B1: the least work of any exact design evaluates the pairs with a
    # nonzero alpha; the walked pairs' bound is the old one, printed beside it
    b1_bytes = block_bytes + n_tiles * tspx * 5 * 4
    b1_bound = bound(b1_bytes, PAIR_OPS * nonzero, PEAK_F32_FLOPS)
    b1_walked = bound(b1_bytes, PAIR_OPS * pairs, PEAK_F32_FLOPS)
    b2_bound = bound(b2_bytes, 2 * pairs * (D + 1), PEAK_BF16_FLOPS)
    b3_bound = bound(n_isects * ((D + 1) * 2 + 4) + N_FULL * ((D + 1) * 4 + 4),
                     n_isects * (D + 1), PEAK_F32_FLOPS)
    b6_bound = bound(b2_bytes + T_padded * 4, 2 * pairs * (D + 1), PEAK_BF16_FLOPS)
    b7_bound = bound(n_isects * (D + 1) * 2 + N_FULL * ((D + 1) * 4 + 4 + 8),
                     n_isects * (D + 1), PEAK_F32_FLOPS)
    print(f"phase 3 work of one view: {n_tiles} tiles, {n_isects} intersections, "
          f"T_padded {T_padded}, {int(r.blocks_done.sum())} blocks walked "
          f"({pairs} pixel-Gaussian pairs); scatter layout R_striped {plan_s.R_striped}, "
          f"{plan_s.stripe_base.shape[0]} stripes; B1 {b1_ms:.4f} ms (unculled "
          f"{b1_unculled:.4f}, twin {b1_plain:.1f}; bound {b1_bound[0]:.4f} ms by "
          f"{b1_bound[1]} on the nonzero-alpha pairs, share {b1_bound[0] / b1_ms:.3f}; "
          f"{b1_walked[0]:.4f} ms on the walked pairs, share {b1_walked[0] / b1_ms:.3f}); "
          f"B2 {b2_ms:.3f} ms, B3 {b3_ms:.3f} ms; "
          f"B6 {b6_ms:.3f} ms (twin {b6_plain:.1f}), "
          f"B7 {b7_ms:.3f} ms (twin {b7_plain:.1f})", flush=True)

    b1_rec = rec("B1", "render", "tpugs_torch/csrc/render.cu",
                 "tpugs/raster/pallas_tiled.py:1328", launches["render"], b1, b1_ms,
                 b1_plain, b1_bound)
    b1_rec.update(bound_walked_ms=b1_walked[0], unculled_ms=b1_unculled,
                  resident_clusters=load_library().tpugs_render_max_clusters(TILE, 1))
    records = [
        b1_rec,
        rec("B2", "adjoint", "tpugs_torch/csrc/adjoint.cu",
            "tpugs/raster/pallas_tiled.py:1573", launches["adjoint"], b2, b2_ms,
            b2_plain, b2_bound),
        rec("B3", "reduce", "tpugs_torch/csrc/reduce.cu",
            "tpugs/raster/pallas_tiled.py:2178", launches["reduce"], b3, b3_ms,
            b3_plain, b3_bound, b3_lib),
        rec("B6", "adjoint_scatter", "tpugs_torch/csrc/adjoint.cu",
            "tpugs/raster/pallas_tiled.py:1870", launches_s["adjoint_scatter"], b6, b6_ms,
            b6_plain, b6_bound),
        rec("B7", "stripe_sum", "tpugs_torch/csrc/stripe_sum.cu",
            "tpugs/raster/pallas_tiled.py:1987", launches_s["stripe_sum"], b7, b7_ms,
            b7_plain, b7_bound, b7_lib),
    ]
    return records, r, ref3


S1_ITERS = 5  # timed launches of each S1 variant


def phase_experiments(r):
    """S1's variants at the reference's 15360 blocks and S2's passes on
    the canonical view ``r`` (a default-engine ``ViewResult``). Returns
    their kernel records."""
    from tpugs_torch.experiments import reduce_tail as S2
    from tpugs_torch.experiments import scatter_write as S1
    from tpugs_torch.raster import kernels as K
    from tpugs_torch.raster.plan import with_scatter_extras
    from tpugs_torch.utils.timing import time_cuda

    # S1: every variant against its twin; scatter is contig permuted by pos
    nb = S1.NB_DEFAULT
    n_rows = nb * S1.BLOCK_ROWS
    pos = S1.permutation(n_rows).cuda()
    pos64 = pos.long()
    out_k, out_t, contig = (torch.empty((n_rows, S1.ROW_ELEMS), dtype=torch.bfloat16,
                                        device="cuda") for _ in range(3))
    worst, equal = (0.0, 0.0), True
    for it in S1.COMPUTE_ITERS:
        S1.run_variant(pos, False, it, contig)
        for scatter in (False, True):
            S1.run_variant(pos, scatter, it, out_k)
            torch.cuda.synchronize()
            S1.scatter_write_plain(out_t, pos if scatter else None, it)
            worst = max(worst, rel_err(out_k, out_t), key=lambda e: e[1])
            equal &= torch.equal(out_k, out_t)
        check(torch.equal(out_k[pos64], contig), f"S1 scatter rows land at pos (it={it})")
    print(f"phase 3x S1 {nb} blocks: kernel against twin in all six variants: largest "
          f"error {worst[1]:.3e} of max, bit-equal {equal}", flush=True)
    check(worst[1] <= 2.0**-7, "S1 within one bf16 unit of its twin")
    s1_plain = time_cuda(lambda: S1.scatter_write_plain(out_t, pos, 0), 1)
    src_rows = S1.run_variant(pos, False, 0, contig)
    s1_lib = time_cuda(lambda: out_t.index_copy_(0, pos64, src_rows), S1_ITERS)
    check(torch.equal(out_t, S1.run_variant(pos, True, 0, out_k)),
          "index_copy_ writes the scatter variant's rows")
    del out_k, out_t, contig, src_rows, pos64
    S1.reset_launches()
    variants = S1.measure(nb, iters=S1_ITERS, device="cuda")
    s1_launches = S1.LAUNCHES["scatter_write"]
    for v in variants:
        print(f"phase 3x S1 {v['variant']:8s}[it={v['compute_iters']}] -> {v['ms']:.3f} ms  "
              f"{v['mrows_s']:.1f} M rows/s  {v['gb_s']:.1f} GB/s", flush=True)
    print(f"phase 3x S1 library index_copy_ of the same rows: {s1_lib:.3f} ms", flush=True)
    # Diagnostic: each block's rows contiguous, the blocks in shuffled places
    blocks = S1.permutation(nb, seed=1).cuda().long()
    pos_blk = (blocks[:, None] * S1.BLOCK_ROWS
               + torch.arange(S1.BLOCK_ROWS, device="cuda")).reshape(-1).to(torch.int32)
    out = torch.empty((n_rows, S1.ROW_ELEMS), dtype=torch.bfloat16, device="cuda")
    for it in (0, 48):
        ms = time_cuda(lambda: S1.run_variant(pos_blk, True, it, out), S1_ITERS)
        print(f"phase 3x S1 diagnostic block-shuffled contig [it={it}] -> {ms:.3f} ms",
              flush=True)
    del out, pos_blk, blocks
    src = torch.arange(64, dtype=torch.int32, device="cuda")
    probe_ms = time_cuda(lambda: S1.async_copy_probe(src, 2), 20)
    probe_plain = time_cuda(lambda: S1.async_copy_probe_plain(src, 2), 20)
    probe_launches = S1.LAUNCHES["async_copy_probe"]
    probe_err = rel_err(S1.async_copy_probe(src, 2), S1.async_copy_probe_plain(src, 2))
    check(int(S1.async_copy_probe(src, 2)) == 19, "the S1 probe returns 19")
    s1 = {(v["variant"], v["compute_iters"]): v["ms"] for v in variants}
    s1_bound = bound(S1.row_bytes(n_rows, True), 2 * S1.multiply_adds(nb, 0), PEAK_F32_FLOPS)
    for it in S1.COMPUTE_ITERS:
        for name in ("contig", "scatter"):
            b = bound(S1.row_bytes(n_rows, name == "scatter"),
                      2 * S1.multiply_adds(nb, it), PEAK_F32_FLOPS)
            print(f"phase 3x S1 bound {name}[it={it}]: {b[0]:.3f} ms ({b[1]}); "
                  f"share {b[0] / s1[name, it]:.3f}", flush=True)

    # S2: the reduce's passes on the view's own rows
    D = D_FULL
    plan = with_scatter_extras(r.plan)
    K.LAUNCHES.reset()
    fns = S2.passes(r.rows, plan, D + 1)
    unperm_equal = torch.equal(fns["stripe+unpermute"](), r.sums)
    # index_add_ adds with float atomics, which flush subnormal sums to zero
    acc = fns["scatter-acc"]()
    normal = r.sums.abs() >= torch.finfo(torch.float32).tiny
    acc_equal = torch.equal(acc[normal], r.sums[normal])
    flushed = int((acc[~normal] != r.sums[~normal]).sum())
    acc_equal &= bool((acc[~normal][acc[~normal] != r.sums[~normal]] == 0).all())
    del acc
    print(f"phase 3x S2 stripe+unpermute bit-equal to B3 {unperm_equal}; scatter-acc "
          f"bit-equal to B3 on every normal sum {acc_equal}, {flushed} subnormal sums "
          f"flushed to zero by index_add_", flush=True)
    check(unperm_equal and acc_equal, "S2's unpermuted stripe sums equal B3's")
    s2_ms = {name: time_cuda(fn, 5) for name, fn in fns.items()}
    s2_launches = K.LAUNCHES.stripe_sum
    nbytes = S2.pass_bytes(plan, r.rows.shape[1], D + 1, r.rows.element_size())
    for name, ms in s2_ms.items():
        b = 1e3 * nbytes[name] / PEAK_BYTES_S
        print(f"phase 3x S2 {name:17s} -> {ms:.3f} ms (bound {b:.3f} ms by bytes, share "
              f"{b / ms:.3f})", flush=True)
    for name, why in S2.NOT_APPLICABLE.items():
        print(f"phase 3x S2 {name}: not applicable ({why})", flush=True)
    src2 = S2.stripe_sources(plan)
    s2_plain = time_cuda(lambda: K.reduce_striped_plain(
        r.rows[src2], plan, D + 1, unpermute=False), 1)
    stripe = fns["stripe"]()
    # library: a CSR 0/1 matrix over the plan rows in column order
    counts = plan.culled.long()
    offsets = torch.zeros(plan.num_gaussians + 1, dtype=torch.int64, device="cuda")
    offsets[1:] = torch.cumsum(counts, 0)
    owner = torch.repeat_interleave(torch.arange(plan.num_gaussians, device="cuda"), counts)
    g = plan.slot_order[owner]
    k = plan.gauss_offsets.long()[g] + torch.arange(plan.n_isects, device="cuda") - offsets[owner]
    select = csr_select(offsets.to(torch.int32), plan.gauss_pos[k], plan.T_padded)
    rows32 = r.rows[:, : D + 1].float()
    s2_err = rel_err(select @ rows32, stripe)
    s2_lib = time_cuda(lambda: select @ rows32, 5)
    check(s2_err[1] <= 1e-5, "the library call computes S2's stripe sums")
    del select, rows32
    s2_bound = (1e3 * nbytes["stripe"] / PEAK_BYTES_S, "bytes")
    return [
        rec("S1", "scatter_write (scatter, compute_iters 0)",
            "tpugs_torch/csrc/exp_scatter_write.cu", "scripts/exp_scatter_write.py:120",
            s1_launches, worst, s1["scatter", 0], s1_plain, s1_bound, s1_lib),
        rec("S1-probe", "async_copy_probe", "tpugs_torch/csrc/exp_scatter_write.cu",
            "scripts/exp_scatter_write.py:143", probe_launches, probe_err, probe_ms,
            probe_plain, bound(32 + 4, 0, PEAK_F32_FLOPS)),
        rec("S2", "reduce_tail stripe (gather + stripe_sum in column order)",
            "tpugs_torch/csrc/stripe_sum.cu", "scripts/exp_reduce_tail.py:53",
            s2_launches, s2_err, s2_ms["stripe"], s2_plain, s2_bound, s2_lib),
    ]


# The garden-scale feature-3DGS train step (scripts/bench_train_step.py's
# configuration): 2^19 Gaussians from seed-0 uniform points, 1296 x 840,
# 8 orbit cameras, feature_dim 128 against a linear:512 teacher in bf16,
# SH 3, strategy none, tile 32, f32 gradient rows, trans_eps 1e-4.
TRAIN_CAMS, TRAIN_WARMUP, TRAIN_STEPS = 8, 3, 10


def train_step_records(seen, w, h, launches, tag, ids):
    """The kernels of one recorded train step (``Trainer.record``): B4, B5
    and B3 on 64 random tiles against their twins (phase 4's tolerances),
    then their times, their twins' and B3's library call's, against the
    bounds of this step's work. Returns the three kernel records under
    ``ids``."""
    from tpugs_torch.kernels.build import load_library
    from tpugs_torch.raster import kernels as K
    from tpugs_torch.raster import train as T
    from tpugs_torch.raster.tiles import image_to_tiles
    from tpugs_torch.utils.timing import time_cuda

    geom, cols, plan, eps, img, alpha, done, g, hterm, grem0, dtype, rows = (seen[k] for k in (
        "geom", "cols", "plan", "trans_eps", "image", "alpha", "blocks_done", "g_image",
        "hterm", "grem0", "contrib_dtype", "rows"))
    D = cols.shape[1]
    sums = K.reduce_rows(rows, plan, D + T.GEOM_GRADS)

    # 64 random tiles against the twins
    gen = torch.Generator(device="cuda").manual_seed(0)
    tiles = torch.randperm(plan.n_tiles, device="cuda", generator=gen)[:64]
    img_t, alpha_t, done_t = T.train_tiles_plain(geom, cols, plan, eps, tiles)
    inside = tile_inside(h, w, plan.tile_size, tiles)
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
    print(f"{tag} check on 64 tiles ({len(gids)} Gaussians): B4 image rel {b4[1]:.3e}, "
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
    lib = load_library()
    b4_wide = time_cuda(lambda: T._launch_train_fwd(lib, geom, cols, plan, eps, None), 3)
    b5_ms = time_cuda(lambda: T.train_rows(geom, cols, g, hterm, grem0, done, plan, dtype),
                      3)
    b5_plain = time_cuda(
        lambda: T.train_rows_plain(geom, cols, g, hterm, grem0, done, plan, dtype), 1)
    b5_bf16 = time_cuda(lambda: T.train_rows(geom, cols, g, hterm, grem0, done, plan,
                                             torch.bfloat16), 3)
    b3_ms = time_cuda(lambda: K.reduce_rows(rows, plan, D + 8), 5)
    b3_plain = time_cuda(lambda: K.reduce_rows_plain(rows, plan, D + 8), 1)
    select = csr_select(plan.gauss_offsets, plan.gauss_pos, t_padded)
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
    b3_bound = bound(n_isects * ((D + 8) * rows.element_size() + 4)
                     + plan.num_gaussians * ((D + 8) * 4 + 4),
                     n_isects * (D + 8), PEAK_F32_FLOPS)
    print(f"{tag} work of one step: {plan.n_tiles} tiles, {n_isects} intersections, "
          f"T_padded {t_padded}, {walked} blocks walked ({pairs} pixel-Gaussian pairs, "
          f"{weighted} with a nonzero weight, {kept} with a nonzero alpha); "
          f"B4 {b4_ms:.3f} ms (twin {b4_plain:.1f}; the wide kernel {b4_wide:.3f}), B5 {b5_ms:.3f} ms (twin {b5_plain:.1f}; "
          f"with bf16 rows {b5_bf16:.3f} ms), "
          f"B3 {b3_ms:.3f} ms (twin {b3_plain:.1f}, library {b3_lib:.3f} ms, "
          f"{lib_err[1]:.3e} of max from the kernel)", flush=True)
    return [
        rec(ids[0], "train_fwd", "tpugs_torch/csrc/train_fwd.cu",
            "tpugs/raster/pallas_train.py:229", launches["train_fwd"], b4, b4_ms, b4_plain,
            b4_bound),
        rec(ids[1], "train_bwd", "tpugs_torch/csrc/train_bwd.cu",
            "tpugs/raster/pallas_train.py:496", launches["train_bwd"], b5, b5_ms, b5_plain,
            b5_bound),
        rec(ids[2], "reduce (train rows)", "tpugs_torch/csrc/reduce.cu",
            "tpugs/raster/pallas_tiled.py:2178", launches["reduce"], b3, b3_ms,
            b3_plain, b3_bound, b3_lib),
    ]


def phase_train():
    """The train step at full width through ``Trainer.train_chunk``: 3
    warm-up steps (SH degrees 0-2, sh_degree_interval 1), then 10 timed
    steps at degree 3. Returns the kernel records of B4, B5 and B3 on the
    train rows, and the initial scene on the host (phase 9 starts there)."""
    import dataclasses

    import numpy as np

    from tpugs_torch.encoders import get_encoder
    from tpugs_torch.raster import kernels as K
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
    scene0 = init_scene_from_points(pts, rgbs, cfg)
    tr = Trainer(cfg, scene0, 1.0,
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
    check(launches["train_fwd_wide"] == 0 and launches["train_bwd_wide"] == 0,
          "D = 131 takes the cluster kernels of B4 and B5")
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
    return (train_step_records(seen, w, h, launches, "phase 4", ("B4", "B5", "B3-train")),
            scene0.to("cpu"))


# Phase 5: the raster API and the eager lift at the canonical lift shape,
# tile 16 (the API's TileConfig), with no early exit (trans_eps 0, the
# reference's tiled path): B4 renders, B2 with f32 rows and B3 lift, B5 and
# B3 differentiate ``rasterize``.
EAGER_TILE = 16
PLANTED = 10  # opaque Gaussians outside every view, which pruning must remove


def phase_eager():
    """``create_feature_field``, ``prune_by_gradients`` then
    ``verify_pruning_equivalence``, and one ``rasterize`` forward and
    backward, at N = 2^19, 1296 x 840, D = 512 over the 8 orbit views.
    Returns the kernel records of B4, B2, B3 and B5 on this path."""
    from tpugs_torch import rasterize
    from tpugs_torch.encoders.base import LinearRGBEncoder
    from tpugs_torch.lift.backproject import backproject_view, create_feature_field
    from tpugs_torch.lift.prune import prune_by_gradients, verify_pruning_equivalence
    from tpugs_torch.raster import kernels as K
    from tpugs_torch.raster import train as T
    from tpugs_torch.raster.api import plan_render, rasterize_with_plan
    from tpugs_torch.raster.tiles import image_to_tiles
    from tpugs_torch.utils.synthetic import orbit_cameras, random_scene
    from tpugs_torch.utils.timing import time_cuda

    n, w, h, D, ts = N_FULL, W_FULL, H_FULL, D_FULL, EAGER_TILE
    scene = random_scene(n, seed=0, extent=1.0, scale_range=(0.004, 0.02), device="cuda")
    cams = orbit_cameras(VIEWS, w, h, radius=3.0, device="cuda")
    enc = LinearRGBEncoder(D, device="cuda")
    vm0, K0 = cams.viewmats[0], cams.Ks[0]
    backproject_view(scene, vm0, K0, w, h, enc)  # warm-up view
    torch.cuda.synchronize()

    # 1. the eager lift over the 8 views
    torch.cuda.reset_peak_memory_stats()
    K.LAUNCHES.reset()
    t0 = time.perf_counter()
    field = create_feature_field(scene, cams, enc, verbose=False)
    torch.cuda.synchronize()
    lift_ms = 1e3 * (time.perf_counter() - t0) / VIEWS
    launches = K.LAUNCHES.snapshot()
    lift_peak = torch.cuda.max_memory_allocated() / 1e9
    check(field.shape == (n, D) and bool(torch.isfinite(field).all()), "the field finite")
    lit = float((field.abs().sum(1) > 0).float().mean())
    check(lit > 0, "some Gaussians have a feature")
    for name in ("train_fwd", "adjoint", "reduce"):
        check(launches[name] >= VIEWS, f"{name} launched at least once per view ({launches[name]})")
    check(launches["train_fwd_wide"] == 0, "D = 3 takes B4's cluster kernel")
    print(f"phase 5 create_feature_field N={n} {w}x{h} D={D} tile={ts} views={VIEWS} "
          f"trans_eps=0: {lift_ms:.2f} ms/view, {1e3 / lift_ms:.3f} views/s, peak "
          f"{lift_peak:.2f} GB, {100 * lit:.1f}% of Gaussians with a feature; launches "
          f"{launches}", flush=True)
    del field

    # 64 random tiles of view 0 against the twins, on the path's own inputs
    seen = {}
    backproject_view(scene, vm0, K0, w, h, enc, record=seen)
    torch.cuda.synchronize()
    geom, cols, plan, done = (seen[k] for k in ("geom", "cols", "plan", "blocks_done"))
    packed, feats, aplan, rows, sums = (seen[k] for k in (
        "packed", "feat_tiles", "adjoint_plan", "adjoint_rows", "adjoint_sums"))
    check(seen["trans_eps"] == 0.0, "the render walks every block")
    # At trans_eps 0 a tile stops only once T is exactly 0 at all its pixels
    # (f32 underflow under many opaque Gaussians); alpha = 1 - T is then 1.
    n_blocks = ((plan.tile_ends - plan.tile_starts + 127) // 128).int()
    all_tiles = torch.arange(plan.n_tiles, device="cuda")
    alpha_tiles = image_to_tiles(seen["alpha"][..., None], ts)[..., 0]
    opaque = ((alpha_tiles == 1.0) | ~tile_inside(h, w, ts, all_tiles)[..., 0]).all(1)
    short = done < n_blocks
    print(f"phase 5 view 0: {int(short.sum())} of {plan.n_tiles} tiles stop before their "
          f"last block (T underflowed to 0), {int((n_blocks - done).sum())} of "
          f"{int(n_blocks.sum())} blocks left unwalked", flush=True)
    check(bool(opaque[short].all()), "a tile stops early only where alpha is 1 at every pixel")
    gen = torch.Generator(device="cuda").manual_seed(0)
    tiles = torch.randperm(plan.n_tiles, device="cuda", generator=gen)[:64]
    inside = tile_inside(h, w, ts, tiles)
    img_t, alpha_t, done_t = T.train_tiles_plain(geom, cols, plan, 0.0, tiles)
    b4 = rel_err(torch.where(inside, image_to_tiles(seen["image"], ts)[tiles], 0.0),
                 torch.where(inside, img_t, 0.0))
    b4_alpha = rel_err(torch.where(inside[..., 0], alpha_tiles[tiles], 0.0),
                       torch.where(inside[..., 0], alpha_t, 0.0))
    # the twin's T underflows in another order of products: where the walks
    # end apart, both must have reached alpha 1
    apart = done[tiles] != done_t
    twin_opaque = ((alpha_t == 1.0) | ~inside[..., 0]).all(1)
    span = span_rows(plan, tiles)
    rows_t = K.adjoint_rows_plain(packed, feats, aplan, 0.0, tiles=tiles)
    b2 = K.rows_error(rows[span], rows_t[span], D)
    del rows_t
    gids = gaussians_of(plan, span)
    red_t = K.reduce_rows_plain(rows, plan, D + 1, gaussians=gids)
    b3 = rel_err(sums[gids], red_t)
    b3_equal = torch.equal(sums[gids], red_t)
    print(f"phase 5 check on 64 tiles of view 0 ({len(gids)} Gaussians), trans_eps=0: B4 "
          f"image rel {b4[1]:.3e}, alpha rel {b4_alpha[1]:.3e}, blocks walked differ from "
          f"the twin's on {int(apart.sum())} tiles; B2 f32 {b2[1]:.3e} of column-group max, "
          f"{b2[2]:.3e} of row max; B3 bit-equal {b3_equal}", flush=True)
    check(b4[1] <= 1e-4 and b4_alpha[1] <= 1e-4,
          "B4 within 1e-4 of its twin on the sampled tiles")
    check(bool((opaque[tiles] & twin_opaque)[apart].all()),
          "B4's walk ends apart from its twin's only where both reached alpha 1")
    check(within_rows_tol(b2[1], b2[2], torch.float32), "B2 f32 within ROWS_TOL")
    check(b3_equal, "B3 bit-equal on the sampled Gaussians")

    # 2. pruning and the render-equivalence check. At trans_eps 0 no
    # Gaussian of the canonical scene has zero weight in every view, so
    # PLANTED opaque Gaussians far above the orbit (outside every frustum)
    # join it: exactly those must go, and the renders must agree.
    planted = plant_outside(scene, PLANTED)
    n_p = planted.num_gaussians
    K.LAUNCHES.reset()
    t0 = time.perf_counter()
    pruned = prune_by_gradients(planted, cams, verbose=False)
    torch.cuda.synchronize()
    prune_s = time.perf_counter() - t0
    launches_p = K.LAUNCHES.snapshot()
    check(pruned.num_gaussians == n and all(
        torch.equal(getattr(pruned, f), getattr(scene, f)) for f in (
            "means", "quats", "log_scales", "logit_opacities", "sh0", "shN")),
          f"prune_by_gradients removed exactly the {PLANTED} planted Gaussians "
          f"({n_p - pruned.num_gaussians} removed)")
    K.LAUNCHES.reset()
    t0 = time.perf_counter()
    max_err, total_err = verify_pruning_equivalence(planted, pruned, cams, verbose=False)
    torch.cuda.synchronize()
    verify_s = time.perf_counter() - t0
    launches_v = K.LAUNCHES.snapshot()
    check(launches_p["adjoint"] >= VIEWS and launches_p["reduce"] >= VIEWS,
          f"prune_by_gradients ran B2 and B3 every view ({launches_p})")
    check(launches_v["train_fwd"] >= 2 * VIEWS,
          f"verify_pruning_equivalence rendered both scenes through B4 ({launches_v})")
    share = 100 * (n_p - pruned.num_gaussians) / n_p
    print(f"phase 5 prune_by_gradients on N={n_p} ({n} + {PLANTED} planted outside every "
          f"view): {prune_s:.3f} s for {VIEWS} views, {share:.4f}% pruned ({n_p - pruned.num_gaussians} "
          f"of {n_p}, exactly the planted ones); verify_pruning_equivalence: "
          f"{verify_s:.3f} s, max pixel error {max_err:.3e} (< 1/510), total "
          f"{total_err:.3e}; launches {launches_p} then {launches_v}", flush=True)
    del pruned, planted

    # 3. rasterize RGB+ED forward and backward
    leaves = [t.detach().clone().requires_grad_() for t in (
        scene.means, scene.quats, scene.scales, scene.opacities, scene.colors_all)]
    bg = torch.rand((3,), device="cuda", generator=gen)
    g = torch.randn((1, h, w, 4), device="cuda", generator=gen)

    def forward():
        return rasterize(*leaves, vm0[None], K0[None], w, h, sh_degree=scene.sh_degree,
                         render_mode="RGB+ED", backgrounds=bg)

    imgs, alphas, _ = forward()  # warm-up
    torch.autograd.grad((imgs * g).sum(), leaves)
    torch.cuda.synchronize()
    del imgs, alphas
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    torch.cuda.reset_peak_memory_stats()
    K.LAUNCHES.reset()
    ev[0].record()
    imgs, alphas, meta = forward()
    ev[1].record()
    grads = torch.autograd.grad((imgs * g).sum(), leaves)
    ev[2].record()
    torch.cuda.synchronize()
    fwd_ms, bwd_ms = ev[0].elapsed_time(ev[1]), ev[1].elapsed_time(ev[2])
    rast_peak = torch.cuda.max_memory_allocated() / 1e9
    launches_r = K.LAUNCHES.snapshot()
    check(imgs.shape == (1, h, w, 4) and bool(torch.isfinite(imgs).all()), "images finite")
    names = ("means", "quats", "scales", "opacities", "colors")
    for name, gr in zip(names, grads):
        check(bool(torch.isfinite(gr).all()) and bool((gr != 0).any()),
              f"the gradient of {name} finite and nonzero")
    for name in ("train_fwd", "train_bwd", "reduce"):
        check(launches_r[name] >= 1, f"rasterize launched {name} ({launches_r})")
    print(f"phase 5 rasterize RGB+ED with a background, one camera: forward {fwd_ms:.2f} ms, "
          f"backward {bwd_ms:.2f} ms (CUDA events), peak {rast_peak:.2f} GB; gradients finite "
          f"and nonzero: {', '.join(names)}; launches {launches_r}", flush=True)
    del grads

    # the same render through rasterize_with_plan, recorded: B5 on 64 tiles
    seen5 = {}
    plan5 = plan_render(*leaves[:4], vm0, K0, w, h)
    img5, _ = rasterize_with_plan(*leaves, vm0, K0, plan5, scene.sh_degree, "RGB+ED", bg,
                                  record=seen5)
    torch.autograd.grad((img5 * g[0]).sum(), leaves)
    torch.cuda.synchronize()
    check(torch.equal(img5, imgs[0]), "the recorded render equals rasterize's bit for bit")
    del imgs, alphas, meta, img5
    g5, cols5, plan5, done5 = (seen5[k] for k in ("geom", "cols", "plan", "blocks_done"))
    d5 = cols5.shape[1]
    args5 = (g5, cols5, seen5["g_image"], seen5["hterm"], seen5["grem0"], done5, plan5)
    tiles5 = torch.randperm(plan5.n_tiles, device="cuda", generator=gen)[:64]
    span5 = span_rows(plan5, tiles5)
    rows5_t, mags5 = T.train_rows_plain(*args5, torch.float32, tiles5, magnitudes=True)
    b5 = T.grad_rows_error(seen5["rows"][span5], rows5_t[span5], d5, mags5[span5])
    print(f"phase 5 check on 64 tiles of the rasterize render (D={d5}, trans_eps=0): B5 f32 "
          f"rows {b5[1]:.3e} of column-group max, {b5[2]:.3e} of the entry's magnitude",
          flush=True)
    check(within_grad_tol(b5[1], b5[2], torch.float32), "B5 within GRAD_ROWS_TOL")
    del rows5_t, mags5

    # 4. times at the path's shapes and the bounds of its work at trans_eps 0
    d4 = cols.shape[1]
    b4_ms = time_cuda(lambda: T.train_forward(geom, cols, plan, 0.0), 5)
    b4_plain = time_cuda(lambda: T.train_forward_plain(geom, cols, plan, 0.0), 1)
    b2_ms = time_cuda(lambda: K.adjoint_rows(packed, feats, aplan, 0.0), 3)
    b2_plain = time_cuda(lambda: K.adjoint_rows_plain(packed, feats, aplan, 0.0), 1)
    b3_ms = time_cuda(lambda: K.reduce_rows(rows, plan, D + 1), 5)
    b3_plain = time_cuda(lambda: K.reduce_rows_plain(rows, plan, D + 1), 1)
    select = csr_select(plan.gauss_offsets, plan.gauss_pos, plan.T_padded)
    rows32 = rows[:, : D + 1].contiguous()
    lib_err = rel_err(select @ rows32, sums)
    b3_lib = time_cuda(lambda: select @ rows32, 5)
    check(lib_err[1] <= 1e-5, "the library call computes B3's sums")
    del select, rows32
    b5_ms = time_cuda(lambda: T.train_rows(*args5, torch.float32), 5)
    b5_plain = time_cuda(lambda: T.train_rows_plain(*args5, torch.float32), 1)

    walked = int(done.sum())
    pairs, weighted, kept = walked_pairs(geom, plan, 0.0)
    check(pairs == walked * 128 * ts * ts, "the twin's walk takes the kernel's blocks")
    tspx = ts * ts
    b4_bound = bound(walked * 128 * (8 + d4) * 4 + h * w * (d4 + 1) * 4,
                     pairs * PAIR_OPS + weighted * 2 * d4, PEAK_F32_FLOPS)
    b4_walked = bound(walked * 128 * (8 + d4) * 4 + h * w * (d4 + 1) * 4,
                      pairs * (PAIR_OPS + 2 * d4), PEAK_F32_FLOPS)
    # B2 walks its own pack over whole tiles: every walked pair needs its
    # alpha, only those with a nonzero weight need the (D + 1)-column product
    pairs2, weighted2, _ = walked_pairs(packed, aplan, 0.0)
    b2_bytes = (pairs2 // tspx) * 64 + plan.n_tiles * tspx * D * 4 + plan.T_padded * (D + 1) * 4
    b2_bound = bound(b2_bytes, pairs2 * PAIR_OPS + weighted2 * 2 * (D + 1), PEAK_F32_FLOPS)
    b2_walked = bound(b2_bytes, pairs2 * (PAIR_OPS + 2 * (D + 1)), PEAK_F32_FLOPS)
    b3_bound = bound(plan.n_isects * ((D + 1) * 4 + 4) + n * ((D + 1) * 4 + 4),
                     plan.n_isects * (D + 1), PEAK_F32_FLOPS)
    # rasterize rendered view 0 of the same scene: B5 replays B4's walk
    check(torch.equal(done5, done), "rasterize's render walked view 0's blocks")
    b5_bound = bound(walked * 128 * (8 + d5) * 4 + h * w * (d5 + 2) * 4 + 4 * plan5.n_tiles
                     + plan5.T_padded * T.grad_row_width(d5) * 4,
                     pairs * PAIR_OPS + kept * (4 * d5 + PAIR_OPS), PEAK_F32_FLOPS)
    print(f"phase 5 work of view 0 at tile {ts}, trans_eps=0: {plan.n_tiles} tiles, "
          f"{plan.n_isects} intersections, T_padded {plan.T_padded}, {walked} blocks walked "
          f"({pairs} pixel-Gaussian pairs, {weighted} with a nonzero weight, {kept} with a "
          f"nonzero alpha); B4 D={d4} {b4_ms:.3f} ms (twin {b4_plain:.1f}; bound "
          f"{b4_bound[0]:.4f} ms by {b4_bound[1]}, {b4_walked[0]:.4f} on the walked pairs' "
          f"products); B2 f32 D={D} {b2_ms:.3f} ms (twin {b2_plain:.1f}; {pairs2} pairs "
          f"walked, {weighted2} with a nonzero weight; bound {b2_bound[0]:.4f} ms by "
          f"{b2_bound[1]}, share {b2_bound[0] / b2_ms:.3f}; {b2_walked[0]:.4f} on the walked "
          f"pairs' products, share {b2_walked[0] / b2_ms:.3f}); B3 {b3_ms:.3f} ms "
          f"(twin {b3_plain:.1f}, library {b3_lib:.3f}, {lib_err[1]:.3e} of max from the "
          f"kernel); B5 D={d5} {b5_ms:.3f} ms (twin {b5_plain:.1f}; bound {b5_bound[0]:.4f} "
          f"ms by {b5_bound[1]})", flush=True)
    b4_rec = rec("B4-tiled", "train_fwd (render_tiled, trans_eps 0)",
                 "tpugs_torch/csrc/train_fwd.cu", "tpugs/raster/pallas_train.py:250",
                 launches["train_fwd"], b4, b4_ms, b4_plain, b4_bound)
    b4_rec.update(bound_walked_ms=b4_walked[0])
    b2_rec = rec("B2-tiled", "adjoint (backproject_tiled, f32, trans_eps 0)",
                 "tpugs_torch/csrc/adjoint.cu", "tpugs/raster/pallas_tiled.py:1623",
                 launches["adjoint"], b2, b2_ms, b2_plain, b2_bound)
    b2_rec.update(bound_walked_ms=b2_walked[0])
    return [
        b4_rec,
        b2_rec,
        rec("B3-tiled", "reduce (backproject_tiled rows)", "tpugs_torch/csrc/reduce.cu",
            "tpugs/raster/pallas_tiled.py:2233", launches["reduce"], b3, b3_ms, b3_plain,
            b3_bound, b3_lib),
        rec("B5-tiled", "train_bwd (rasterize backward, trans_eps 0)",
            "tpugs_torch/csrc/train_bwd.cu", "tpugs/raster/pallas_train.py:557",
            launches_r["train_bwd"], b5, b5_ms, b5_plain, b5_bound),
    ]


ABS_D = 515  # above B5's 512-channel rows: two channel chunks and the geometry-only launch


def phase_absgrad():
    """``render_tiled`` (tile 16, trans_eps 0) at the canonical view with
    D = 515 random colours, a background and the absgrad probe, forward and
    backward: ms, peak memory, the geometry-only B5 launch's time against
    its bound; the launch rebuilt from the render's own inputs reproduces
    the probe's gradient, and 64 random tiles of its rows hold against the
    twin. Returns B5-geom's kernel record."""
    from tpugs_torch.raster import kernels as K
    from tpugs_torch.raster import train as T
    from tpugs_torch.raster.plan import build_plan
    from tpugs_torch.raster.projection import project
    from tpugs_torch.raster.tiled import TileConfig, render_tiled
    from tpugs_torch.utils.synthetic import orbit_cameras, random_scene
    from tpugs_torch.utils.timing import time_cuda

    n, w, h, D, ts = N_FULL, W_FULL, H_FULL, ABS_D, EAGER_TILE
    scene = random_scene(n, seed=0, extent=1.0, scale_range=(0.004, 0.02), device="cuda")
    cams = orbit_cameras(VIEWS, w, h, radius=3.0, device="cuda")
    with torch.no_grad():
        proj = project(scene.means, scene.quats, scene.scales, scene.opacities,
                       cams.viewmats[0], cams.Ks[0], w, h)
        plan = build_plan(proj, w, h, ts)
    del scene
    gen = torch.Generator(device="cuda").manual_seed(15)
    opac = torch.where(proj.valid, proj.opacities, torch.zeros_like(proj.opacities))
    colors = torch.rand((n, D), device="cuda", generator=gen)
    bg = torch.rand((D,), device="cuda", generator=gen)
    g = torch.randn((h, w, D), device="cuda", generator=gen)
    inputs = (proj.means2d, proj.conics, opac, colors, bg)

    def step():
        leaves = [t.detach().requires_grad_() for t in inputs]
        probe = torch.zeros((n, 2), device="cuda", requires_grad=True)
        ev[0].record()
        img, _ = render_tiled(*leaves[:4], plan, TileConfig(ts), background=leaves[4],
                              abs_probe=probe)
        ev[1].record()
        grads = torch.autograd.grad((img * g).sum(), leaves + [probe])
        ev[2].record()
        return img.detach(), grads

    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    step()  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    K.LAUNCHES.reset()
    image, grads = step()
    torch.cuda.synchronize()
    fwd_ms, bwd_ms = ev[0].elapsed_time(ev[1]), ev[1].elapsed_time(ev[2])
    peak = torch.cuda.max_memory_allocated() / 1e9
    launches = K.LAUNCHES.snapshot()
    check(launches["train_bwd_geom"] == 1,
          f"the backward launched the geometry-only B5 once ({launches})")
    d_abs = grads[5]
    check(all(bool(torch.isfinite(x).all()) for x in grads) and bool((d_abs != 0).any()),
          "every gradient finite, the absgrad probe's nonzero")
    print(f"phase 5 absgrad render_tiled N={n} {w}x{h} D={D} tile={ts} trans_eps=0, a "
          f"background and the absgrad probe: forward {fwd_ms:.2f} ms, backward {bwd_ms:.2f} "
          f"ms (CUDA events), peak {peak:.2f} GB; launches {launches}", flush=True)
    del grads

    # the geometry launch again, from the render's own inputs (RenderTrain.backward)
    geom, cols = T.pack_train(*inputs[:4], plan)
    alpha, done = T.train_forward(geom, cols[:, :T.MAX_CHANNELS].contiguous(), plan, 0.0)[1:]
    transs = 1.0 - alpha
    hterm = ((g @ bg) * transs).contiguous()
    grem0 = (g * (image - transs[..., None] * bg)).sum(-1).contiguous()
    args = (geom, cols, g, hterm, grem0, done, plan)
    rows = T.train_geom_rows(*args)
    same = torch.equal(K.reduce_rows(rows, plan, T.GEOM_GRADS)[:, 6:8], d_abs)
    tiles = torch.randperm(plan.n_tiles, device="cuda", generator=gen)[:64]
    span = span_rows(plan, tiles)
    rows_t, mags = T.train_rows_plain(*args, tiles=tiles, magnitudes=True, geometry_only=True)
    err = T.grad_rows_error(rows[span], rows_t[span], 0, mags[span])
    del rows_t, mags, rows
    print(f"phase 5 absgrad check: the geometry launch rebuilt from the render's inputs gives "
          f"the probe's gradient bit for bit {same}; 64 tiles: rows max abs {err[0]:.3e}, "
          f"{err[1]:.3e} of column-group max, {err[2]:.3e} of the entry's magnitude",
          flush=True)
    check(same, "the rebuilt geometry launch reproduces the absgrad gradient")
    check(within_grad_tol(err[1], err[2], torch.float32), "B5-geom within GRAD_ROWS_TOL")

    ms = time_cuda(lambda: T.train_geom_rows(*args), 3)
    plain = time_cuda(lambda: T.train_rows_plain(*args, geometry_only=True), 1, warmup=0)
    walked = int(done.sum())
    pairs, _, kept = walked_pairs(geom, plan, 0.0)
    check(pairs == walked * 128 * ts * ts, "the twin's walk takes the kernel's blocks")
    # the least work: the walked blocks' geometry and colour rows, g, hterm
    # and grem0 read once per image (as the other B5 bounds count them),
    # blocks_done, the 8-column rows written
    ops = pairs * PAIR_OPS + kept * (2 * D + PAIR_OPS)
    b = bound(walked * 128 * (8 + D) * 4 + h * w * (D + 2) * 4 + 4 * plan.n_tiles
              + plan.T_padded * T.GEOM_GRADS * 4, ops, PEAK_F32_FLOPS)
    # a diagnostic beside it: the kernel stages g once per walked block
    restaged = bound(walked * 128 * (8 + D) * 4 + walked * ts * ts * D * 4 + h * w * 2 * 4
                     + 4 * plan.n_tiles + plan.T_padded * T.GEOM_GRADS * 4, ops,
                     PEAK_F32_FLOPS)
    print(f"phase 5 absgrad B5 train_geom_rows D={D}: {ms:.3f} ms (twin {plain:.1f}); "
          f"{walked} blocks walked, {pairs} pairs, {kept} with a nonzero alpha; bound "
          f"{b[0]:.4f} ms by {b[1]}, share {b[0] / ms:.3f}; with g read once per walked "
          f"block (bound_restaged) {restaged[0]:.4f} ms by {restaged[1]}", flush=True)
    return [rec("B5-geom", "train_bwd geometry-only (render_tiled absgrad, D=515, trans_eps 0)",
                "tpugs_torch/csrc/train_bwd.cu", "tpugs/raster/pallas_train.py:557",
                launches["train_bwd_geom"], err, ms, plain, b)]


APP_FEATURE = "linear:512"


def plant_outside(scene, count: int):
    """``scene`` with ``count`` opaque Gaussians appended far above the
    orbit, outside every view."""
    dev = scene.means.device
    return scene.replace(**{
        name: torch.cat([getattr(scene, name), extra]) for name, extra in dict(
            means=torch.tensor([[0.0, 100.0, 0.0]], device=dev).expand(count, 3),
            quats=torch.tensor([[1.0, 0.0, 0.0, 0.0]], device=dev).expand(count, 4),
            log_scales=torch.full((count, 3), -3.0, device=dev),
            logit_opacities=torch.full((count,), 2.0, device=dev),
            sh0=torch.ones((count, 1, 3), device=dev),
            shN=torch.zeros((count, *scene.shN.shape[1:]), device=dev),
        ).items()})


def phase_app():
    """The back-projection app from files on disk at full width: the
    canonical scene plus PLANTED Gaussians outside every view, saved as a
    gsplat ``.pt`` beside a COLMAP model of the 8 orbit cameras whose
    points3D.bin holds the scene's 2^19 means and colours; then
    ``tpugs_torch.apps.backproject.main`` with ``linear:512`` and the
    ``pallas`` engine. Stage times, peak memory, exactly the planted
    Gaussians pruned with max pixel error 0, the saved features bit-equal
    to ``backproject_views`` + ``normalize_field`` on the pruned scene and
    the loaded cameras, the native reader used and equal to the pure one,
    the loaded poses within 1e-5 of the orbit's."""
    import contextlib
    import io
    import os
    import re
    import tempfile

    import numpy as np

    import tpugs_torch.native as native
    from tpugs_torch.apps import backproject as app
    from tpugs_torch.encoders import get_encoder
    from tpugs_torch.io import checkpoints, colmap
    from tpugs_torch.lift import batch, prune
    from tpugs_torch.raster import kernels as K
    from tpugs_torch.utils.synthetic import orbit_cameras, random_scene, write_synthetic_colmap

    n, w, h = N_FULL, W_FULL, H_FULL
    scene = random_scene(n, seed=0, extent=1.0, scale_range=(0.004, 0.02), device="cuda")
    cams = orbit_cameras(VIEWS, w, h, radius=3.0, device="cuda")
    planted = plant_outside(scene, PLANTED)
    xyz = scene.means.cpu().numpy()
    rgb = (255 * (0.5 + 0.28209479177387814 * scene.sh0[:, 0]).clamp(0, 1)).byte().cpu().numpy()
    del scene
    times, results = {}, {}
    originals = {}

    def timed(module, name, stage):
        fn = getattr(module, name)
        originals[(module, name)] = fn

        def wrapper(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            times[stage] = times.get(stage, 0.0) + time.perf_counter() - t0
            results[stage] = out
            return out

        setattr(module, name, wrapper)

    with tempfile.TemporaryDirectory() as tmp:
        data, res = os.path.join(tmp, "data"), os.path.join(tmp, "results")
        ckpt = os.path.join(data, "ckpt.pt")
        t0 = time.perf_counter()
        write_synthetic_colmap(data, cams, points=xyz, point_rgbs=rgb)
        checkpoints.save_scene_pt(planted, ckpt)
        write_s = time.perf_counter() - t0
        pts_path = os.path.join(data, "sparse/0/points3D.bin")
        for module, name, stage in ((checkpoints, "load_checkpoint", "load"),
                                    (prune, "prune_by_gradients", "prune"),
                                    (prune, "verify_pruning_equivalence", "verify"),
                                    (batch, "backproject_views", "lift"),
                                    (batch, "normalize_field", "lift"),
                                    (app, "save_features", "save")):
            timed(module, name, stage)
        out = io.StringIO()
        try:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            K.LAUNCHES.reset()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(out):
                features = app.main(data_dir=data, checkpoint=ckpt, results_dir=res,
                                    data_factor=1, feature=APP_FEATURE, engine="pallas",
                                    device="cuda")
            total_s = time.perf_counter() - t0
        finally:
            for (module, name), fn in originals.items():
                setattr(module, name, fn)
        launches = K.LAUNCHES.snapshot()
        peak = torch.cuda.max_memory_allocated() / 1e9
        log = out.getvalue()
        print("\n".join(f"phase 6 app | {line}" for line in log.strip().splitlines()), flush=True)
        saved = np.load(os.path.join(res, f"features_{APP_FEATURE}.npz"))["features"]
        t0 = time.perf_counter()
        cols_native = colmap.read_points3d_bin_columnar(pts_path)
        native_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        pure = colmap.read_points3d_bin_plain(pts_path)
        pure_s = time.perf_counter() - t0

    times["rest"] = total_s - sum(times.values())  # the encoder, the app's own steps
    loaded, lcams, manager = results["load"]
    pruned = results["prune"]
    max_err, _ = results["verify"]
    n_pruned = planted.num_gaussians - pruned.num_gaussians
    m = re.search(r"Pruned (\d+) splats", log)
    check(m is not None and int(m.group(1)) == PLANTED and n_pruned == PLANTED,
          f"the app pruned exactly the {PLANTED} planted Gaussians ({n_pruned})")
    check(max_err == 0.0 and "max pixel error = 0.0," in log, f"max pixel error 0 ({max_err})")
    for name in ("render", "adjoint", "reduce", "train_fwd"):
        check(launches[name] >= VIEWS, f"the app launched {name} every view ({launches})")
    stages = " ".join(f"{k}={v:.3f}" for k, v in times.items())
    print(f"phase 6 app N={planted.num_gaussians} ({n} + {PLANTED} planted) {w}x{h} "
          f"feature={APP_FEATURE} engine=pallas views={VIEWS}: {total_s:.3f} s in all, stages "
          f"(s) {stages}; peak {peak:.2f} GB; pruned {n_pruned}, max pixel error {max_err}; "
          f"writing the files {write_s:.3f} s; launches {launches}", flush=True)

    check(all(torch.equal(getattr(loaded, f), getattr(planted, f)) for f in (
        "means", "quats", "log_scales", "logit_opacities", "sh0", "shN")),
          "the loaded scene equals the saved one")
    vm_err = float((lcams.viewmats - cams.viewmats).abs().max())
    check(vm_err <= 1e-5 and (lcams.width, lcams.height) == (w, h)
          and torch.equal(lcams.Ks, cams.Ks), "the loaded cameras are the orbit's")
    check(native.available() and manager._pts_cols is not None,
          "load_checkpoint parsed points3D.bin with the native reader")
    ids = np.sort(np.fromiter(pure.keys(), np.int64, len(pure)))
    same_pts = (np.array_equal(cols_native["pid"], ids) and all(
        np.array_equal(cols_native[k], np.stack([getattr(pure[int(i)], f) for i in ids]))
        for k, f in (("xyz", "xyz"), ("rgb", "rgb"))) and np.array_equal(
        cols_native["err"], np.array([pure[int(i)].error for i in ids])))
    check(same_pts and len(ids) == n, "the native parse of points3D.bin equals the pure reader's")
    print(f"phase 6 points3D.bin of {len(ids)} points: native parse {native_s:.3f} s, pure "
          f"reader {pure_s:.3f} s, equal {same_pts}; loaded viewmats within {vm_err:.2e} of "
          f"the orbit cameras", flush=True)

    enc = get_encoder(APP_FEATURE, device="cuda")
    num, den = batch.backproject_views(pruned, lcams.viewmats, lcams.Ks, lcams.width,
                                       lcams.height, enc, device="cuda")
    direct = batch.normalize_field(num, den).cpu().numpy()
    equal = np.array_equal(saved, direct) and np.array_equal(saved, np.asarray(features))
    print(f"phase 6 saved features {saved.shape} bit-equal to backproject_views + "
          f"normalize_field on the pruned scene and the loaded cameras: {equal}", flush=True)
    check(saved.shape == (n, 512) and bool(np.isfinite(saved).all()), "the features finite")
    check(equal, "the app's features equal the direct lift's bit for bit")


# Phase 7: the paper's lift. LSeg (ViT-L/16 + the DPT head, 512-d) in bf16
# with seeded random weights, as bench.py's ``--encoder lseg-random``,
# through the split-encoder lift at the canonical shape; DINOv2 ViT-L/14
# (1024-d) on 2 views; the CLIP text tower.
LSEG_GROUP = 2
DINO_VIEWS = 2
TEXT_PROMPTS = 8
# bf16 network against the same weights in f32, per pixel of the unit-norm
# features: the least cosine and the largest absolute error allowed
LSEG_BF16_MIN_COS, LSEG_BF16_MAX_ABS = 0.99, 0.05


def median_ms(fn, iters: int) -> float:
    """Median over ``iters`` calls of ``fn``, each between its own CUDA
    events, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        torch.cuda.synchronize()
        times.append(e0.elapsed_time(e1))
    return sorted(times)[len(times) // 2]


def network_flops(net, x) -> int:
    """Multiply-add FLOPs (2 per MAC) of one forward of ``net`` on ``x``,
    from the shapes its layers see: every Linear, Conv2d and
    ConvTranspose2d, and both attention products. Elementwise work,
    norms and softmax are not counted."""
    import torch.nn as nn

    from tpugs_torch.encoders.vit import Attention

    total = [0]

    def hook(m, inp, out):
        x = inp[0]
        if isinstance(m, nn.Linear):
            total[0] += 2 * (x.numel() // x.shape[-1]) * m.in_features * m.out_features
        elif isinstance(m, nn.ConvTranspose2d):
            total[0] += 2 * x.numel() * m.out_channels * m.kernel_size[0] * m.kernel_size[1]
        elif isinstance(m, nn.Conv2d):
            total[0] += (2 * out.numel() * m.in_channels * m.kernel_size[0]
                         * m.kernel_size[1] // m.groups)
        elif isinstance(m, Attention):
            B, T, C = x.shape
            total[0] += 2 * 2 * B * T * T * C

    handles = [m.register_forward_hook(hook) for m in net.modules()
               if isinstance(m, (nn.Linear, nn.Conv2d, nn.ConvTranspose2d, Attention))]
    try:
        with torch.no_grad():
            net(x)
    finally:
        for h in handles:
            h.remove()
    return total[0]


def lift_records(tag, r, D, launches, replaces_b2, replaces_b3):
    """64 random tiles of one view (``run_view``'s result ``r``) against
    the twins; B2's and B3's times at this view's shapes, their twins',
    B3's library call, and their bounds. Returns (records, B2's errors)."""
    from tpugs_torch.raster import kernels as K
    from tpugs_torch.utils.timing import time_cuda

    plan = r.plan
    gen = torch.Generator(device="cuda").manual_seed(7)
    tiles = torch.randperm(plan.n_tiles, device="cuda", generator=gen)[:64]
    rows = span_rows(plan, tiles)
    rows_t = K.adjoint_rows_plain(r.packed, r.feat_tiles, plan, tiles=tiles)
    b2 = K.rows_error(r.rows[rows], rows_t[rows], D)
    del rows_t
    gids = gaussians_of(plan, rows)
    b3_equal = torch.equal(r.sums[gids], K.reduce_rows_plain(r.rows, plan, D + 1,
                                                             gaussians=gids))
    b3 = rel_err(r.sums[gids], K.reduce_rows_plain(r.rows, plan, D + 1, gaussians=gids))
    b2_ms = time_cuda(lambda: K.adjoint_rows(r.packed, r.feat_tiles, plan), 3)
    b2_plain = time_cuda(lambda: K.adjoint_rows_plain(r.packed, r.feat_tiles, plan), 1)
    b3_ms = time_cuda(lambda: K.reduce_rows(r.rows, plan, D + 1), 5)
    b3_plain = time_cuda(lambda: K.reduce_rows_plain(r.rows, plan, D + 1), 1)
    select = csr_select(plan.gauss_offsets, plan.gauss_pos, plan.T_padded)
    rows32 = r.rows[:, : D + 1].float()
    lib_err = rel_err(select @ rows32, r.sums)
    b3_lib = time_cuda(lambda: select @ rows32, 5)
    del select, rows32
    walked, weighted, _ = walked_pairs(r.packed, plan, K.TRANS_EPS)
    tspx = plan.tile_size**2
    block_bytes = int(r.blocks_done.sum()) * 128 * 64
    b2_bound = bound(block_bytes + plan.n_tiles * tspx * D * 2 + plan.T_padded * (D + 1) * 2,
                     2 * weighted * (D + 1), PEAK_BF16_FLOPS)
    n = plan.num_gaussians
    b3_bound = bound(plan.n_isects * ((D + 1) * 2 + 4) + n * ((D + 1) * 4 + 4),
                     plan.n_isects * (D + 1), PEAK_F32_FLOPS)
    print(f"phase 7 {tag} D={D}: check on 64 tiles ({len(gids)} Gaussians): B2 bf16 "
          f"{b2[1]:.3e} of column-group max, {b2[2]:.3e} of row max; B3 bit-equal {b3_equal}; "
          f"{walked} pairs walked, {weighted} with a nonzero weight; B2 {b2_ms:.3f} ms (twin "
          f"{b2_plain:.1f}; bound {b2_bound[0]:.4f} ms by {b2_bound[1]}, share "
          f"{b2_bound[0] / b2_ms:.3f}); B3 {b3_ms:.3f} ms (twin {b3_plain:.1f}; bound "
          f"{b3_bound[0]:.4f} ms by {b3_bound[1]}, share {b3_bound[0] / b3_ms:.3f}; sparse "
          f"CSR @ f32 rows {b3_lib:.3f} ms, {lib_err[1]:.3e} of max)", flush=True)
    check(within_rows_tol(b2[1], b2[2], torch.bfloat16),
          f"B2 on the {tag} features within ROWS_TOL on the sampled tiles")
    check(b3_equal, f"B3 bit-equal on the {tag} rows of the sampled Gaussians")
    check(lib_err[1] <= 1e-5, "the library call computes the sums")
    return [
        rec(f"B2-{tag}", "adjoint", "tpugs_torch/csrc/adjoint.cu", replaces_b2,
            launches["adjoint"], b2, b2_ms, b2_plain, b2_bound),
        rec(f"B3-{tag}", "reduce", "tpugs_torch/csrc/reduce.cu", replaces_b3,
            launches["reduce"], b3, b3_ms, b3_plain, b3_bound, b3_lib),
    ]


@torch.no_grad()
def phase_lseg(den3):
    """LSeg in bf16 at full width through ``backproject_views_split`` (group
    2, both engines), the encoder alone against its bound and against
    itself in f32, DINO on 2 views, the CLIP text tower. ``den3`` is phase
    3's weight sums (CPU), which the split lift must reproduce bit for bit.
    Returns the kernel records and the LSeg-512 field (CPU) of the default
    engine's lift, normalised, for phase 8."""
    from tpugs_torch.encoders.base import LinearRGBEncoder
    from tpugs_torch.encoders.clip_text import CLIPTextTower
    from tpugs_torch.encoders.dino import DinoEncoder
    from tpugs_torch.encoders.lseg import LSegEncoder
    from tpugs_torch.encoders.vit import init_flax_like_, parameter_count
    from tpugs_torch.lift.batch import (
        backproject_views,
        backproject_views_split,
        normalize_field,
        render_and_pack,
        run_view,
    )
    from tpugs_torch.raster import kernels as K
    from tpugs_torch.raster.tiles import tiles_to_image
    from tpugs_torch.utils.synthetic import orbit_cameras, random_scene

    w, h = W_FULL, H_FULL
    scene = random_scene(N_FULL, seed=0, extent=1.0, scale_range=(0.004, 0.02), device="cuda")
    cams = orbit_cameras(VIEWS, w, h, radius=3.0, device="cuda")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)  # "RANDOM weights": seeded, on purpose
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        enc = LSegEncoder(dtype=torch.bfloat16, device="cuda")
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        enc32 = LSegEncoder(dtype=None, device="cuda")
    n_params = parameter_count(enc.net)
    print(f"phase 7 LSegEncoder(dtype=bf16): ViT-L/16 (24 blocks, width 1024, 16 heads, "
          f"{(enc.crop_size // 16) ** 2 + 1} tokens at the {enc.crop_size}^2 crop) + DPT head "
          f"(256 features, {enc.feature_dim} out), seeded random weights: built in "
          f"{build_s:.2f} s, {n_params} parameters", flush=True)

    # the encoder alone, on view 0's render
    r0 = render_and_pack(scene, cams.viewmats[0], cams.Ks[0], w, h, TILE)
    rgb = tiles_to_image(r0.tiles, w, h, TILE)[..., :3][None].contiguous()
    del r0
    x = enc.pre(rgb)
    feats = enc.network(x)
    pre_ms = median_ms(lambda: enc.pre(rgb), 10)
    net_ms = median_ms(lambda: enc.network(x), 10)
    host = []  # the host's time to enqueue the network, from an idle card
    for _ in range(10):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        enc.network(x)
        host.append(1e3 * (time.perf_counter() - t0))
    host_ms = sorted(host)[len(host) // 2]
    post_ms = median_ms(lambda: enc.post(feats, (h, w), torch.bfloat16), 10)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base_gb = torch.cuda.memory_allocated() / 1e9
    enc.staged_apply(rgb)
    torch.cuda.synchronize()
    enc_peak = torch.cuda.max_memory_allocated() / 1e9
    flops = network_flops(enc.net, x)
    cs, d = enc.crop_size, enc.feature_dim
    net_bound = bound(2 * n_params + x.numel() * 2 + feats.numel() * 2, flops, PEAK_BF16_FLOPS)
    pre_bound = bound(rgb.numel() * 4 + x.numel() * 2, 0, PEAK_F32_FLOPS)
    post_bound = bound(feats.numel() * 2 + h * w * d * 2, 0, PEAK_F32_FLOPS)
    enc_bound = net_bound[0] + pre_bound[0] + post_bound[0]
    enc_ms = pre_ms + net_ms + post_ms
    f16 = enc(rgb[0])
    f32 = enc32(rgb[0])
    cos = torch.nn.functional.cosine_similarity(f16, f32, dim=-1)
    max_abs = float((f16 - f32).abs().max())
    print(f"phase 7 LSeg encoder alone on view 0's render ({w}x{h} -> {cs}^2 -> "
          f"{cs // 2}^2 x {d} -> {w}x{h}), median of 10 by CUDA events: pre-resize "
          f"{pre_ms:.3f} ms, network {net_ms:.3f} ms, post (norm + resize back, bf16) "
          f"{post_ms:.3f} ms, total {enc_ms:.3f} ms (the host enqueues the network in "
          f"{host_ms:.3f} ms); peak {enc_peak:.2f} GB ({base_gb:.2f} "
          f"before); network {flops / 1e12:.4f} TFLOP (linear, conv and attention products), "
          f"bound {net_bound[0]:.4f} ms by {net_bound[1]} (share {net_bound[0] / net_ms:.3f}); "
          f"pre bound {pre_bound[0]:.4f} ms, post bound {post_bound[0]:.4f} ms by bytes; "
          f"encoder bound {enc_bound:.4f} ms, share {enc_bound / enc_ms:.3f}; bf16 against "
          f"f32 (same weights): per-pixel cosine min {float(cos.min()):.6f} mean "
          f"{float(cos.mean()):.6f}, max abs error {max_abs:.3e} (bounds: cosine >= "
          f"{LSEG_BF16_MIN_COS}, max abs <= {LSEG_BF16_MAX_ABS})", flush=True)
    check(f16.shape == (h, w, d) and bool(torch.isfinite(f16).all()), "LSeg features finite")
    check(float(cos.min()) >= LSEG_BF16_MIN_COS and max_abs <= LSEG_BF16_MAX_ABS,
          "the bf16 encoder within its bounds of the f32 encoder")
    del enc32, f16, f32, cos, feats, x

    # the split lift, group 2, after one warm-up group
    args = (scene, cams.viewmats, cams.Ks, w, h, enc)
    backproject_views_split(scene, cams.viewmats[:LSEG_GROUP], cams.Ks[:LSEG_GROUP], w, h,
                            enc, group_size=LSEG_GROUP, tile_size=TILE)
    results = {}
    for engine, kernels in (("pallas", ("render", "adjoint", "reduce")),
                            ("scatter", ("render", "adjoint_scatter", "stripe_sum"))):
        num, den, ms_view, launches, peak_gb, stage_ms, _ = timed_lift(
            args, engine, backproject_views_split, group_size=LSEG_GROUP)
        results[engine] = (num.cpu(), den.cpu(), launches)
        del num, den
        for name in kernels:
            check(launches[name] >= VIEWS,
                  f"{name} kernel launched at least once per view ({launches[name]})")
        render = sum(stage_ms[k] for k in ("project+sh", "plan", "pack", "render"))
        stages = " ".join(f"{k}={v:.2f}" for k, v in stage_ms.items())
        print(f"phase 7 backproject_views_split LSeg bf16 group={LSEG_GROUP} "
              f"reduce_engine={engine} N={N_FULL} {w}x{h} D={d} tile={TILE} views={VIEWS}: "
              f"{ms_view:.2f} ms/view, {1e3 / ms_view:.3f} views/s, peak {peak_gb:.2f} GB; "
              f"ms/view: render {render:.2f}, encode {stage_ms['encode']:.2f}, adjoint+reduce "
              f"{stage_ms['adjoint'] + stage_ms['reduce']:.2f} (CUDA events: {stages}); "
              f"launches {launches}", flush=True)
    (num, den, launches), (num_s, den_s, _) = results["pallas"], results["scatter"]
    check(bool(torch.isfinite(num).all()) and bool((den > 0).any()), "num finite, den > 0")
    den_equal = torch.equal(den, den3)
    scatter_equal = torch.equal(num_s, num) and torch.equal(den_s, den)
    num_1, den_1 = backproject_views(*args, tile_size=TILE)
    num_1, den_1 = num_1.cpu(), den_1.cpu()
    one_equal = torch.equal(num_1, num) and torch.equal(den_1, den)
    one_err = rel_err(num, num_1)
    # where the two differ, the features must: staged (batched) against per image
    views2 = [render_and_pack(scene, cams.viewmats[c], cams.Ks[c], w, h, TILE) for c in (0, 1)]
    rgbs = torch.stack([tiles_to_image(v.tiles, w, h, TILE)[..., :3] for v in views2])
    del views2
    staged = enc.staged_apply(rgbs)
    feats_equal = all(torch.equal(staged[i], enc(rgbs[i]).to(torch.bfloat16)) for i in (0, 1))
    del staged, rgbs
    print(f"phase 7 split lift: den bit-equal to phase 3's (the ones-channel never sees the "
          f"features) {den_equal}; reduce_engine=scatter num and den bit-equal to pallas "
          f"{scatter_equal}; against backproject_views with the same encoder: num and den "
          f"bit-equal {one_equal} (num {one_err[1]:.3e} of max); staged_apply's features "
          f"bit-equal to the per-image call's on views 0-1 {feats_equal}", flush=True)
    check(den_equal, "the split lift's den equals phase 3's bit for bit")
    check(scatter_equal, "the scatter engine's num and den equal pallas' bit for bit")
    check(torch.equal(den_1, den), "the one-pass lift's den equals the split lift's")
    check(one_equal or (not feats_equal and one_err[1] <= 1e-2),
          "num bit-equal to backproject_views', or differing only through the features")
    field = normalize_field(num.cuda(), den.cuda()).cpu()
    del num, den, num_s, den_s, num_1, den_1, results

    r = run_view(scene, cams.viewmats[0], cams.Ks[0], w, h, enc, TILE)
    records = lift_records("lseg", r, d, launches, "tpugs/raster/pallas_tiled.py:1623",
                           "tpugs/raster/pallas_tiled.py:2233")
    del r, enc, args

    # DINO: 2 views at D = 1024
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        t0 = time.perf_counter()
        dino = DinoEncoder(dtype=torch.bfloat16, device="cuda")
        torch.cuda.synchronize()
        dino_build = time.perf_counter() - t0
    img = rgb[0]
    dino_ms = median_ms(lambda: dino(img), 5)
    xd = torch.zeros((1, 3, dino.image_size, dino.image_size), device="cuda",
                     dtype=torch.bfloat16)
    dino_net = median_ms(lambda: dino.vit(xd), 5)
    dino_flops = network_flops(dino.vit, xd)
    vms, ks = cams.viewmats[:DINO_VIEWS], cams.Ks[:DINO_VIEWS]
    K.LAUNCHES.reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    num_d, den_d = backproject_views_split(scene, vms, ks, w, h, dino, group_size=LSEG_GROUP,
                                           tile_size=TILE)
    torch.cuda.synchronize()
    dino_lift = 1e3 * (time.perf_counter() - t0) / DINO_VIEWS
    launches_d = K.LAUNCHES.snapshot()
    for name in ("render", "adjoint", "reduce"):
        check(launches_d[name] >= DINO_VIEWS, f"{name} launched on every DINO view")
    _, den_lin = backproject_views(scene, vms, ks, w, h, LinearRGBEncoder(D_FULL),
                                   tile_size=TILE)
    dino_den_equal = torch.equal(den_d, den_lin)
    print(f"phase 7 DinoEncoder(dtype=bf16): ViT-L/14 with 4 registers at "
          f"{dino.image_size}^2 ({(dino.image_size // 14) ** 2 + 5} tokens), built in "
          f"{dino_build:.2f} s, {parameter_count(dino.vit)} parameters; encoder {dino_ms:.2f} ms "
          f"per image (network {dino_net:.2f} ms, {dino_flops / 1e12:.4f} TFLOP, bound "
          f"{1e3 * dino_flops / PEAK_BF16_FLOPS:.4f} ms by operations); split lift of "
          f"{DINO_VIEWS} views at D={dino.feature_dim}: {dino_lift:.2f} ms/view; den bit-equal "
          f"to phase 3's path on those views {dino_den_equal}; launches {launches_d}", flush=True)
    check(bool(torch.isfinite(num_d).all()) and num_d.shape[1] == 1024, "DINO num finite")
    check(dino_den_equal, "DINO's den equals phase 3's path's bit for bit on its views")
    del num_d, den_d, den_lin
    r = run_view(scene, cams.viewmats[0], cams.Ks[0], w, h, dino, TILE)
    records += lift_records("dino", r, dino.feature_dim, launches_d,
                            "tpugs/raster/pallas_tiled.py:1623",
                            "tpugs/raster/pallas_tiled.py:2233")
    del r, dino

    # the CLIP text tower (ViT-B/32's: width 512, 12 layers, context 77)
    tower = init_flax_like_(CLIPTextTower(device="cuda"), seed=0).eval()
    gen = torch.Generator(device="cuda").manual_seed(0)
    tokens = torch.randint(1, 49406, (TEXT_PROMPTS, 77), device="cuda", generator=gen)
    tokens[:, 20] = 49407  # EOT
    with torch.no_grad():
        emb = tower(tokens)
        text_ms = median_ms(lambda: tower(tokens), 10)
    print(f"phase 7 CLIPTextTower (width 512, 12 layers, context 77, random weights): "
          f"{TEXT_PROMPTS} prompts of random ids in {text_ms:.3f} ms, output "
          f"{tuple(emb.shape)} finite {bool(torch.isfinite(emb).all())}", flush=True)
    check(emb.shape == (TEXT_PROMPTS, 512) and bool(torch.isfinite(emb).all()),
          "text embeddings finite, (P, 512)")
    return records, field


# Phase 8: queries and edits on phase 7's LSeg-512 field at the canonical
# shape (N = 2^19, 1296 x 840, 8 orbit views): segmentation and its edits,
# the compressed lift, PCA and affordance transfer, each through the
# functions the apps call (files are written only by the apps, with
# imageio, which the card's machine lacks: output_path None here).
TEXT_POS, TEXT_NEG = 2, 3  # CLIP-tower query rows; one --pos-idx row joins the positives
PLANTED_ROWS = 10  # field rows set to the positive query, and as many to the negative
TIE_MARGIN = 1e-5  # decisions this close to a tie are left out of the float64 checks
CODEC_ROWS, CODEC_LAT, CODEC_STEPS = 150, 16, 2000
BANK_ROWS, BANK_NOISE, KNN = 64, 1e-4, 5
PCA_SUBSET = 65536
U_BF16 = 2.0**-8  # unit roundoff of bfloat16
# |num - num3 @ E| per Gaussian g and latent column j, over U_BF16 * den_g *
# ||E[:, j]||: four bf16 roundings of unit-norm features and of rows (two
# on each side), second-order terms and the f32 sums
NUM_BOUND = 4.1


def _timed(fn):
    """(fn(), seconds, peak GB) on the card, synchronised on both sides."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0, torch.cuda.max_memory_allocated() / 1e9


def mask_f64(feats, queries, p):
    """get_mask3d in float64 on the host: (mask, |max positive - max
    negative score|) of (M, D) ``feats`` against (P, D) ``queries``, the
    first ``p`` positive."""
    f = feats.double().numpy()
    q = queries.double().numpy()
    f = f / (np.linalg.norm(f, axis=1, keepdims=True) + 1e-12)
    q = q / (np.linalg.norm(q, axis=1, keepdims=True) + 1e-12)
    s = f @ q.T
    a, b = s[:, :p].max(1), s[:, p:].max(1)
    return a > b, np.abs(a - b)


def labels_f64(field, bank, k, n_classes):
    """transfer_affordance in float64 on the host, with jax.lax.top_k's tie
    rule (stable order): (labels, gap between the k-th and (k+1)-th score)."""
    f = field.double().numpy()
    f = f / (np.linalg.norm(f, axis=1, keepdims=True) + 1e-8)
    b = bank.features.astype(np.float64)
    b = b / (np.linalg.norm(b, axis=1, keepdims=True) + 1e-8)
    s = f @ b.T
    order = np.argsort(-s, axis=1, kind="stable")
    ranked = np.take_along_axis(s, order, 1)
    gap = ranked[:, k - 1] - ranked[:, k] if k < s.shape[1] else np.full(len(s), np.inf)
    votes = bank.labels[order[:, :k]]
    counts = (votes[..., None] == np.arange(n_classes)).sum(1)
    return counts.argmax(1), gap


def phase_queries(field_cpu, ref3):
    """Segmentation (queries from the random-weight CLIP tower and one
    exemplar Gaussian, planted rows, masks against float64, the edits and
    their renders), the compressed lift through a codec trained on the
    card (``den`` against phase 3's, ``num`` against phase 3's ``num``
    times the codec's encoder), PCA in both modes, and affordance transfer
    with its label renders, evaluation and votes, on ``field_cpu`` (phase
    7's normalised LSeg-512 field) at the canonical shape. ``ref3`` holds
    phase 3's num, den (CPU), ms/view and peak. Returns the B4-viz record."""
    from tpugs_torch.apps.backproject_compressed import CompressedEncoder
    from tpugs_torch.codec.linear import LinearCodec, codec_loss, train_codec
    from tpugs_torch.encoders.base import LinearRGBEncoder
    from tpugs_torch.encoders.clip_text import CLIPTextTower
    from tpugs_torch.encoders.vit import init_flax_like_
    from tpugs_torch.lift.batch import backproject_views
    from tpugs_torch.lift.ops import accumulate_view
    from tpugs_torch.query.affordance import (
        AFFORDANCE_CLASSES,
        ExemplarBank,
        colorize_by_labels,
        evaluate_iou,
        render_label_masks,
        transfer_affordance,
        vote_gradient,
    )
    from tpugs_torch.query.masks import apply_mask3d, segment_by_opacity
    from tpugs_torch.query.text import get_mask2d, get_mask3d, highest_precision
    from tpugs_torch.raster import kernels as K
    from tpugs_torch.raster import train as T
    from tpugs_torch.raster.api import rasterize_with_plan
    from tpugs_torch.raster.projection import project
    from tpugs_torch.raster.tiles import image_to_tiles
    from tpugs_torch.utils.synthetic import orbit_cameras, random_scene
    from tpugs_torch.utils.timing import time_cuda
    from tpugs_torch.viz.common import uint8_image
    from tpugs_torch.viz.gif import (
        overlay_mask_red,
        render_colors,
        render_mask_2d_to_gif,
        render_to_gif,
        view_plan,
    )
    from tpugs_torch.viz.pca import feature_pca, pca_colors, render_pca

    w, h, n, d = W_FULL, H_FULL, N_FULL, field_cpu.shape[1]
    scene = random_scene(n, seed=0, extent=1.0, scale_range=(0.004, 0.02), device="cuda")
    cams = orbit_cameras(VIEWS, w, h, radius=3.0, device="cuda")
    field = field_cpu.cuda()
    lit = torch.nonzero(field_cpu.abs().sum(1) > 0).flatten()
    gen = torch.Generator().manual_seed(13)
    pick = lit[torch.randperm(len(lit), generator=gen)[:2 * PLANTED_ROWS + 1 + BANK_ROWS]]
    plant_pos, plant_neg = pick[:PLANTED_ROWS], pick[PLANTED_ROWS:2 * PLANTED_ROWS]
    pos_idx, bank_rows = int(pick[2 * PLANTED_ROWS]), pick[2 * PLANTED_ROWS + 1:]
    print(f"phase 8 field: phase 7's LSeg-512 lift, normalised, N={n}, {len(lit)} Gaussians "
          f"with a feature", flush=True)

    # (a) segment: 2 + 1 positive and 3 negative queries; plant 10 rows on
    # each side, which must be selected and left out exactly
    tower = init_flax_like_(CLIPTextTower(device="cuda"), seed=0).eval()
    tgen = torch.Generator(device="cuda").manual_seed(1)
    tokens = torch.randint(1, 49406, (TEXT_POS + TEXT_NEG, 77), device="cuda", generator=tgen)
    tokens[:, 20] = 49407  # EOT
    with torch.no_grad():
        emb = tower(tokens).float()
    del tower
    pos_q = torch.cat([emb[:TEXT_POS], field[pos_idx][None]])
    neg_q = emb[TEXT_POS:]
    planted = field.clone()
    planted[plant_pos.cuda()] = pos_q[0] / torch.linalg.vector_norm(pos_q[0])
    planted[plant_neg.cuda()] = neg_q[0] / torch.linalg.vector_norm(neg_q[0])
    queries = torch.cat([pos_q, neg_q]).cpu()
    p = pos_q.shape[0]
    (mask, inv), mask_s, _ = _timed(lambda: get_mask3d(planted, pos_q, neg_q))
    got = mask.cpu().numpy()
    ref, margin = mask_f64(planted.cpu(), queries, p)
    featureless = (planted.abs().sum(1) == 0).cpu().numpy()  # every score 0: never selected
    clear = (margin > TIE_MARGIN) | featureless
    mask_equal = bool((got[clear] == ref[clear]).all()) and not bool(got[featureless].any())
    plants_ok = bool(got[plant_pos.numpy()].all()) and not bool(got[plant_neg.numpy()].any())
    extracted, deleted, _ = apply_mask3d(scene, mask, inv)
    sel = int(mask.sum())
    print(f"phase 8 get_mask3d on N={n} x D={d} against {p} positive ({TEXT_POS} CLIP-tower rows "
          f"+ Gaussian {pos_idx}) and {TEXT_NEG} negative queries: {mask_s * 1e3:.3f} ms, "
          f"{sel} selected; the {PLANTED_ROWS} rows planted on the positive query selected and "
          f"the {PLANTED_ROWS} on the negative not: {plants_ok}; equal to float64 on the host "
          f"{mask_equal} outside {int((~clear).sum())} Gaussians within {TIE_MARGIN} of a tie "
          f"({int(featureless.sum())} without a feature, none selected; smallest margin of "
          f"the rest {margin[~featureless].min():.3e}); apply_mask3d: extracted "
          f"{extracted.num_gaussians} + deleted {deleted.num_gaussians}", flush=True)
    check(plants_ok, "the planted rows selected and left out exactly")
    check(mask_equal, "get_mask3d on the card equals float64 outside the ties")
    check(extracted.num_gaussians == sel and extracted.num_gaussians + deleted.num_gaussians == n,
          "extracted + deleted = N")

    K.LAUNCHES.reset()
    frames_e, ext_s, ext_peak = _timed(lambda: render_to_gif(
        None, extracted, cams, use_checkerboard_background=True))
    launches_e = K.LAUNCHES.snapshot()
    K.LAUNCHES.reset()
    frames_d, del_s, del_peak = _timed(lambda: render_to_gif(None, deleted, cams))
    launches_d = K.LAUNCHES.snapshot()
    K.LAUNCHES.reset()
    frames_m, m2d_s, m2d_peak = _timed(lambda: render_mask_2d_to_gif(
        scene, planted, pos_q, neg_q, cams, None))
    launches_m = K.LAUNCHES.snapshot()
    for name, frames, launches in (("extracted", frames_e, launches_e),
                                   ("deleted", frames_d, launches_d),
                                   ("mask2d", frames_m, launches_m)):
        check(len(frames) == VIEWS and all(f.shape == (h, w, 3) and f.dtype == np.uint8
                                           for f in frames), f"{name}: {VIEWS} uint8 frames")
        check(launches["train_fwd"] >= VIEWS, f"{name}: B4 at D = 3 on every view ({launches})")
    check(launches_e["train_fwd_wide"] == 0 and launches_d["train_fwd_wide"] == 0,
          "the RGB frames take B4's cluster kernel")
    check(launches_m["train_fwd_wide"] >= VIEWS,
          f"mask2d: B4's wide kernel at D = {d} on every view ({launches_m})")

    # view 0's mask: the feature image again (B4 is deterministic), scored
    # on the card and in float64; the function's frame from the same mask
    # (and the time of each piece of that view: the host clock, synchronised)
    seen = {}
    with torch.inference_mode():
        plan0, plan_s, _ = _timed(lambda: view_plan(scene, cams, 0))
        (img0, _), rgb_s, _ = _timed(lambda: render_colors(scene, cams, 0, plan0))
        (feat0, _), feat_s, _ = _timed(lambda: rasterize_with_plan(
            scene.means, scene.quats, scene.scales, scene.opacities, planted, cams.viewmats[0],
            cams.Ks[0], plan0, record=seen))
        m2d, score_s, _ = _timed(lambda: get_mask2d(feat0, pos_q, neg_q))
        frame0, over_s, _ = _timed(lambda: overlay_mask_red(uint8_image(img0), m2d))
    m2d = m2d.cpu().numpy()
    feat0_cpu = feat0.reshape(-1, d).cpu()
    ref2d, margin2d = mask_f64(feat0_cpu, queries, p)
    empty = (feat0_cpu.abs().sum(1) == 0).numpy()  # every score 0 on both sides: not masked
    clear2d = (margin2d > TIE_MARGIN) | empty
    mask2d_equal = bool((m2d.reshape(-1)[clear2d] == ref2d[clear2d]).all())
    empty_out = not bool(m2d.reshape(-1)[empty].any())
    frame0_equal = np.array_equal(frames_m[0], frame0)
    del feat0, feat0_cpu
    print(f"phase 8 view 0 mask: {int(m2d.sum())} of {h * w} pixels; equal to float64 on the "
          f"host {mask2d_equal} outside {int((~clear2d).sum())} pixels within {TIE_MARGIN} of "
          f"a tie ({int(empty.sum())} pixels without a feature, none masked: {empty_out}); "
          f"render_mask_2d_to_gif's frame 0 is this mask overlaid: {frame0_equal}; view 0's "
          f"pieces: plan {1e3 * plan_s:.2f} ms, RGB render {1e3 * rgb_s:.2f} ms, D={d} "
          f"feature render {1e3 * feat_s:.2f} ms, get_mask2d {1e3 * score_s:.2f} ms, "
          f"overlay_mask_red (float64 on the card) + the frame to the host "
          f"{1e3 * over_s:.2f} ms", flush=True)
    check(mask2d_equal and empty_out, "view 0's mask equals float64 outside the ties")
    check(frame0_equal, "render_mask_2d_to_gif overlays get_mask2d's mask")

    # the same edit by a second route: opacity logit -30 outside ~mask
    hidden = segment_by_opacity(scene, inv)
    K.LAUNCHES.reset()
    frames_h, hid_s, _ = _timed(lambda: render_to_gif(None, hidden, cams))
    launches_h = K.LAUNCHES.snapshot()
    check(launches_h["train_fwd"] >= VIEWS, "the opacity-hidden renders ran B4")
    worst = 0.0
    with torch.inference_mode():
        for c in range(VIEWS):
            a, _ = render_colors(deleted, cams, c, view_plan(deleted, cams, c))
            b, _ = render_colors(hidden, cams, c, view_plan(hidden, cams, c))
            worst = max(worst, float((a - b).abs().max()))
    frames_close = max(int(np.abs(x.astype(int) - y.astype(int)).max())
                       for x, y in zip(frames_h, frames_d))
    seg_ms = {k: 1e3 * v / VIEWS for k, v in (("extracted", ext_s), ("deleted", del_s),
                                              ("mask2d", m2d_s), ("opacity", hid_s))}
    print(f"phase 8 renders, ms/view (host clock, synchronised; uint8 frames on the host): "
          f"extracted + checkerboard {seg_ms['extracted']:.2f} (peak {ext_peak:.2f} GB), "
          f"deleted {seg_ms['deleted']:.2f} (peak {del_peak:.2f} GB), render_mask_2d_to_gif "
          f"(RGB + D={d} feature image + per-pixel mask) {seg_ms['mask2d']:.2f} (peak "
          f"{m2d_peak:.2f} GB), opacity-hidden {seg_ms['opacity']:.2f}; B4 launches: D=3 "
          f"{launches_e['train_fwd']} + {launches_d['train_fwd']} + {launches_m['train_fwd']}, "
          f"D={d} {launches_m['train_fwd_wide']}; segment_by_opacity(~mask) against the deleted "
          f"scene: max abs {worst:.3e} per pixel (bound 1/510), frames within {frames_close}",
          flush=True)
    check(worst <= 1 / 510, "the opacity-hidden render equals the deleted scene's within 1/510")

    # B4-viz: the D = 512 feature render of view 0 against its twin, its
    # time and its bound on the pairs with a nonzero weight
    geom, cols, plan, done = (seen[k] for k in ("geom", "cols", "plan", "blocks_done"))
    ts = plan.tile_size
    vgen = torch.Generator(device="cuda").manual_seed(8)
    tiles = torch.randperm(plan.n_tiles, device="cuda", generator=vgen)[:64]
    inside = tile_inside(h, w, ts, tiles)
    img_t, alpha_t, _ = T.train_tiles_plain(geom, cols, plan, 0.0, tiles)
    b4v = rel_err(torch.where(inside, image_to_tiles(seen["image"], ts)[tiles], 0.0),
                  torch.where(inside, img_t, 0.0))
    alpha_tiles = image_to_tiles(seen["alpha"][..., None], ts)[..., 0]
    b4v_alpha = rel_err(torch.where(inside[..., 0], alpha_tiles[tiles], 0.0),
                        torch.where(inside[..., 0], alpha_t, 0.0))
    del img_t, alpha_t
    b4v_ms = time_cuda(lambda: T.train_forward(geom, cols, plan, 0.0), 3)
    b4v_plain = time_cuda(lambda: T.train_forward_plain(geom, cols, plan, 0.0), 1)
    pairs, weighted, _ = walked_pairs(geom, plan, 0.0)
    walked = int(done.sum())
    b4v_bound = bound(walked * 128 * (8 + d) * 4 + h * w * (d + 1) * 4,
                      pairs * PAIR_OPS + weighted * 2 * d, PEAK_F32_FLOPS)
    b4v_walked = bound(walked * 128 * (8 + d) * 4 + h * w * (d + 1) * 4,
                       pairs * (PAIR_OPS + 2 * d), PEAK_F32_FLOPS)
    print(f"phase 8 B4-viz (wide kernel, D={d}, tile {ts}, trans_eps=0) on view 0's feature "
          f"image: 64 tiles against the twin, image rel {b4v[1]:.3e}, alpha rel "
          f"{b4v_alpha[1]:.3e}; {b4v_ms:.3f} ms (twin {b4v_plain:.1f}); {pairs} pairs walked, "
          f"{weighted} with a nonzero weight; bound {b4v_bound[0]:.4f} ms by {b4v_bound[1]}, "
          f"share {b4v_bound[0] / b4v_ms:.3f} ({b4v_walked[0]:.4f} on the walked pairs' "
          f"products)", flush=True)
    check(b4v[1] <= 1e-4 and b4v_alpha[1] <= 1e-4, "B4 at D = 512 within 1e-4 of its twin")
    b4v_rec = rec("B4-viz", "train_fwd_wide (feature image, trans_eps 0)",
                  "tpugs_torch/csrc/train_fwd.cu", "tpugs/raster/pallas_train.py:250",
                  launches_m["train_fwd_wide"], b4v, b4v_ms, b4v_plain, b4v_bound)
    b4v_rec.update(bound_walked_ms=b4v_walked[0])
    del seen, geom, cols, plan, done, frames_e, frames_d, frames_m, frames_h, hidden
    del extracted, deleted, planted

    # (b) the codec, trained on the card, then the compressed lift
    emb512 = torch.from_numpy(np.random.default_rng(0).normal(
        size=(CODEC_ROWS, 512)).astype(np.float32))
    init = LinearCodec.init(512, CODEC_LAT, torch.Generator().manual_seed(0), "cuda")
    x = emb512.cuda()
    x = x / (torch.linalg.vector_norm(x, dim=-1, keepdim=True) + 1e-12)
    loss0 = float(codec_loss(init, x))  # train_codec's start: the same seed-0 draw
    (codec, loss), codec_s, _ = _timed(lambda: train_codec(
        emb512, d_lat=CODEC_LAT, steps=CODEC_STEPS, seed=0, device="cuda"))
    print(f"phase 8 train_codec ({CODEC_ROWS} seeded 512-d embeddings, d_lat {CODEC_LAT}, "
          f"Adam lr 1e-4, {CODEC_STEPS} steps): {codec_s:.3f} s, {CODEC_STEPS / codec_s:.1f} "
          f"steps/s; loss {loss0:.6f} at the init, {loss:.6f} at the last step", flush=True)
    check(np.isfinite(loss) and loss < loss0, "the codec's loss falls")

    enc = CompressedEncoder(LinearRGBEncoder(D_FULL, device="cuda"), codec)
    check(enc.pixelwise, "CompressedEncoder keeps the linear encoder's tile layout")
    backproject_views(scene, cams.viewmats[:1], cams.Ks[:1], w, h, enc, tile_size=TILE)
    num_c, den_c, ms_c, launches_c, peak_c, stage_c, _ = timed_lift(
        (scene, cams.viewmats, cams.Ks, w, h, enc), "pallas")
    for name in ("render", "adjoint", "reduce"):
        check(launches_c[name] >= VIEWS, f"compressed lift: {name} on every view ({launches_c})")
    den3 = ref3["den"]
    den_c = den_c.cpu()
    den_equal = torch.equal(den_c, den3)
    den_rel = float(((den_c - den3).abs() / den3.clamp(min=1e-30)).max())
    E = codec.encoder
    with highest_precision():
        ref_num = ref3["num"].cuda() @ E
    scale = U_BF16 * den3.cuda()[:, None] * torch.linalg.vector_norm(E, dim=0)[None, :]
    err = (num_c - ref_num).abs()
    num_ratio = float(torch.where(scale > 0, err / scale.clamp(min=1e-30), err * 1e30).max())
    stages = " ".join(f"{k}={v:.2f}" for k, v in stage_c.items())
    print(f"phase 8 compressed lift (CompressedEncoder(linear:512, codec 512->{CODEC_LAT}), "
          f"pallas, tile {TILE}, {VIEWS} views): {ms_c:.2f} ms/view, {1e3 / ms_c:.3f} views/s, "
          f"peak {peak_c:.2f} GB (phase 3's linear:512 lift {ref3['ms_view']:.2f} ms/view, peak "
          f"{ref3['peak_gb']:.2f} GB); stages {stages}; launches {launches_c}; den bit-equal to "
          f"phase 3's {den_equal} (largest relative difference {den_rel:.3e}); |num - num3 @ E| "
          f"at most {num_ratio:.3f} x 2^-8 den ||E[:, j]|| (bound {NUM_BOUND})", flush=True)
    check(den_equal, "den bit-equal to phase 3's")
    check(num_ratio <= NUM_BOUND, "num within its bf16 bound of phase 3's num @ E")
    del num_c, ref_num, scale, err, enc

    # (c) PCA in both modes
    K.LAUNCHES.reset()
    frames_g, g_s, g_peak = _timed(lambda: render_pca(scene, field, cams, None, "gaussian"))
    launches_g = K.LAUNCHES.snapshot()
    K.LAUNCHES.reset()
    frames_f, f_s, f_peak = _timed(lambda: render_pca(scene, field, cams, None, "frame"))
    launches_f = K.LAUNCHES.snapshot()
    check(launches_g["train_fwd"] >= VIEWS, "PCA gaussian mode renders through B4")
    check(launches_f["train_fwd_wide"] >= VIEWS, "PCA frame mode renders D = 512 through B4")
    mean, comps = feature_pca(field)
    colors, _, _ = pca_colors(field, mean, comps)
    colors_ok = bool(torch.isfinite(colors).all()) and float(colors.min()) >= 0 and float(
        colors.max()) <= 1
    varied = all(len(np.unique(f)) > 1 for f in frames_g + frames_f)
    sub = torch.randperm(n, generator=torch.Generator().manual_seed(5))[:PCA_SUBSET]
    _, comps_sub = feature_pca(field[sub.cuda()])
    x = field_cpu[sub].double().numpy()
    xc = x - x.mean(axis=0)
    _, vecs = np.linalg.eigh(xc.T @ xc / (len(x) - 1))
    comps_np = vecs[:, ::-1][:, :3]
    comps_sub = comps_sub.cpu().numpy()
    signs = np.sign(np.sum(comps_sub * comps_np, axis=0))
    pca_err = float(np.abs(comps_sub * signs - comps_np).max())
    del colors, x, xc
    print(f"phase 8 render_pca: gaussian mode {1e3 * g_s / VIEWS:.2f} ms/view (peak "
          f"{g_peak:.2f} GB), frame mode (D={d} feature image per view, float64 projections) "
          f"{1e3 * f_s / VIEWS:.2f} ms/view (peak {f_peak:.2f} GB); colours finite in [0, 1] "
          f"{colors_ok}, frames not constant {varied}; components of a {PCA_SUBSET}-row subset "
          f"against numpy's float64 fit, up to sign: max abs {pca_err:.3e} (bound 1e-6)",
          flush=True)
    check(colors_ok and varied, "PCA colours in [0, 1], frames not constant")
    check(pca_err <= 1e-6, "PCA components equal numpy's up to sign")
    del frames_g, frames_f, mean, comps

    # (d) affordance: 64 exemplars from seeded rows plus noise, labels 1-7
    rng = np.random.default_rng(2)
    bank_feats = field_cpu[bank_rows].numpy() + BANK_NOISE * rng.normal(size=(BANK_ROWS, d))
    bank = ExemplarBank(bank_feats.astype(np.float32),
                        (1 + np.arange(BANK_ROWS) % 7).astype(np.int64))
    labels, knn_s, knn_peak = _timed(lambda: transfer_affordance(field, bank, k=KNN))
    ref_labels, gap = labels_f64(field_cpu, bank, KNN, len(AFFORDANCE_CLASSES))
    featureless = (field_cpu.abs().sum(1) == 0).numpy()  # ties with the whole bank, both sides
    clear = (gap > TIE_MARGIN) | featureless
    labels_equal = bool((labels[clear] == ref_labels[clear]).all())
    own = transfer_affordance(field, bank, k=1)[bank_rows.numpy()]
    own_ok = bool((own == bank.labels).all())
    print(f"phase 8 transfer_affordance (N={n}, bank {BANK_ROWS} x {d}, k={KNN}): "
          f"{1e3 * knn_s:.3f} ms (peak {knn_peak:.2f} GB); labels equal to float64 on the host "
          f"{labels_equal} outside {int((~clear).sum())} Gaussians whose {KNN}th and "
          f"{KNN + 1}th scores are within {TIE_MARGIN} (the {int(featureless.sum())} without "
          f"a feature tie with the whole bank and are compared: bank rows 0-{KNN - 1} vote "
          f"on both sides); class counts "
          f"{np.bincount(labels, minlength=8).tolist()}; with k=1 each exemplar's source "
          f"Gaussian keeps its label: {own_ok}", flush=True)
    check(labels_equal, "kNN labels equal float64 outside the ties")
    check(own_ok, "k = 1 gives each exemplar's source Gaussian its label")

    colored = colorize_by_labels(scene, labels)
    K.LAUNCHES.reset()
    frames_a, col_s, _ = _timed(lambda: render_to_gif(None, colored, cams))
    check(K.LAUNCHES.snapshot()["train_fwd"] >= VIEWS, "the labelled scene renders through B4")
    K.LAUNCHES.reset()
    preds, lab_s, lab_peak = _timed(lambda: [render_label_masks(
        scene, labels, cams.viewmats[c], cams.Ks[c], w, h) for c in range(VIEWS)])
    launches_l = K.LAUNCHES.snapshot()
    check(launches_l["train_fwd"] >= VIEWS and launches_l["train_fwd_wide"] == 0,
          f"label masks: B4 at D = 8 on every view ({launches_l})")
    # view 0's label map against B4's twin: the one-hot render of the same
    # labels (the kernel's inputs recorded), argmax and alpha >= 0.5 on 64
    # tiles that hold labels, pixels within TIE_MARGIN of a tie left out
    seen = {}
    onehot = torch.eye(len(AFFORDANCE_CLASSES), device="cuda")[torch.from_numpy(labels).cuda()]
    with torch.inference_mode():
        rasterize_with_plan(scene.means, scene.quats, scene.scales, scene.opacities, onehot,
                            cams.viewmats[0], cams.Ks[0], view_plan(scene, cams, 0),
                            record=seen)
    geom, cols, plan = (seen[k] for k in ("geom", "cols", "plan"))
    ts = plan.tile_size
    pred_tiles = image_to_tiles(torch.from_numpy(preds[0]).cuda()[..., None], ts)[..., 0]
    busy = torch.nonzero((pred_tiles > 0).any(1)).flatten()
    lgen = torch.Generator(device="cuda").manual_seed(9)
    tiles = busy[torch.randperm(len(busy), device="cuda", generator=lgen)[:64]]
    img_t, alpha_t, _ = T.train_tiles_plain(geom, cols, plan, 0.0, tiles)
    top2 = img_t.topk(2, dim=-1).values
    twin = torch.where(alpha_t < 0.5, 0, img_t.argmax(-1))
    inside = tile_inside(h, w, ts, tiles)[..., 0]
    decided = (inside & ((alpha_t - 0.5).abs() > TIE_MARGIN)
               & ((alpha_t < 0.5) | ((top2[..., 0] - top2[..., 1]) > TIE_MARGIN)))
    map_ties = int((inside & ~decided).sum())
    got_t = pred_tiles[tiles]
    map_equal = bool((got_t[decided] == twin[decided]).all())
    map_labelled = int((twin[decided] > 0).sum())
    del seen, geom, cols, plan, onehot, img_t, alpha_t, top2, twin, inside, decided, got_t
    del pred_tiles

    # evaluate_iou against a plain confusion-matrix IoU, on the predicted
    # maps and copies with a seeded 5% of their pixels relabelled
    prng = np.random.default_rng(4)
    gts = []
    for pred in preds:
        gt = pred.copy()
        hit = prng.random(gt.shape) < 0.05
        gt[hit] = prng.integers(0, len(AFFORDANCE_CLASSES), int(hit.sum()))
        gts.append(gt)
    metrics = evaluate_iou(preds, gts)
    c = len(AFFORDANCE_CLASSES)
    conf = sum(np.bincount((g * c + q).ravel(), minlength=c * c) for g, q in zip(gts, preds))
    conf = conf.reshape(c, c).astype(np.float64)  # rows: ground truth, columns: prediction
    diag = np.diag(conf)
    union = conf.sum(0) + conf.sum(1) - diag
    cls = [k for k in range(1, c) if union[k] > 0]
    gt_count = conf.sum(1)
    plain = {AFFORDANCE_CLASSES[k]: (diag[k] / union[k],
                                     diag[k] / gt_count[k] if gt_count[k] else 0.0)
             for k in cls}
    plain["mean"] = tuple(np.mean([v[i] for v in plain.values()]) for i in (0, 1))
    iou_err = max(abs(metrics[name]["iou"] - v[0]) + abs(metrics[name]["recall"] - v[1])
                  for name, v in plain.items() if name in metrics)
    iou_ok = set(metrics) == set(plain) and iou_err <= 1e-12
    print(f"phase 8 affordance renders: colorize_by_labels + render_to_gif "
          f"{1e3 * col_s / VIEWS:.2f} ms/view; render_label_masks {1e3 * lab_s / VIEWS:.2f} "
          f"ms/view (peak {lab_peak:.2f} GB), launches {launches_l}; view 0's map equal to the "
          f"twin's D=8 render on 64 labelled tiles {map_equal} ({map_labelled} labelled "
          f"pixels compared, {map_ties} within {TIE_MARGIN} of a tie left out); evaluate_iou against a plain confusion-matrix IoU with 5% of the "
          f"pixels relabelled: mean IoU {metrics['mean']['iou']:.6f}, recall "
          f"{metrics['mean']['recall']:.6f} over {len(metrics) - 1} classes, largest "
          f"difference {iou_err:.3e}", flush=True)
    check(map_equal and map_labelled > 0, "render_label_masks equals B4's twin on view 0")
    check(iou_ok and metrics["mean"]["iou"] < 1.0, "evaluate_iou equals the plain IoU")
    del frames_a, preds, gts, colored

    # vote_gradient on view 0: an all-ones mask votes num / den = 1 wherever
    # the weight lies inside the image, an all-zeros mask 0
    vm0, K0 = cams.viewmats[0], cams.Ks[0]
    K.LAUNCHES.reset()
    ones_vote, vote_s, _ = _timed(lambda: vote_gradient(scene, vm0, K0, w, h,
                                                        np.ones((h, w), bool)))
    launches_v = K.LAUNCHES.snapshot()
    check(launches_v["adjoint"] >= 1 and launches_v["reduce"] >= 1,
          f"vote_gradient ran B2 and B3 ({launches_v})")
    zero_vote = vote_gradient(scene, vm0, K0, w, h, np.zeros((h, w), bool))
    num1, den1 = accumulate_view(scene, vm0, K0, w, h,
                                 feat_image=torch.ones((h, w, 1), device="cuda"))
    with torch.no_grad():
        proj = project(scene.means, scene.quats, scene.scales, scene.opacities, vm0, K0, w, h)
    # the eager adjoint counts an edge tile's pixels below H in den (tpugs'
    # tiled semantics, ROADMAP C.2): only Gaussians above the last tile row
    # have num = den
    last_row = (h // plan0.tile_size) * plan0.tile_size
    above = ((proj.means2d[:, 1] + proj.radii) < last_row).cpu().numpy()
    den1 = den1.cpu().numpy()
    num_eq_den = bool((num1[:, 0].cpu().numpy() == den1)[above].all())
    strong = above & (den1 > 1e-4)
    ones_ok = bool((ones_vote[strong] == 1.0).all()) and bool((ones_vote <= 1.0).all())
    zero_ok = bool((zero_vote == 0).all()) and bool((ones_vote[den1 == 0] == 0).all())
    print(f"phase 8 vote_gradient on view 0: {1e3 * vote_s:.2f} ms; {int((den1 > 0).sum())} "
          f"Gaussians with weight, {int(above.sum())} above the last tile row: num = den bit "
          f"for bit {num_eq_den}, vote 1 where den > 1e-4 ({int(strong.sum())}) and at most 1 "
          f"everywhere {ones_ok}; all-zeros mask votes 0 {zero_ok}; launches {launches_v}",
          flush=True)
    check(num_eq_den and ones_ok, "an all-ones mask votes 1 where num = den")
    check(zero_ok, "an all-zeros mask votes 0")
    return [b4v_rec]


# Phase 9: the port's train loop at the garden train shape (phase 4's scene,
# 10 orbit views: 8 to train, 2 to validate, targets rendered from the
# canonical seed-0 scene), through ``apps.train.run``.
LOOP_CAMS, LOOP_VAL, LOOP_CAPACITY, LOOP_DEAD = 10, 2, 16384, 4096


class TimedRng:
    """A numpy Generator whose method calls add their host seconds to
    ``seconds`` (the refine's draws)."""

    def __init__(self, rng):
        self.rng, self.seconds = rng, 0.0

    def __getattr__(self, name):
        fn = getattr(self.rng, name)

        def timed(*args, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kw)
            finally:
                self.seconds += time.perf_counter() - t0

        return timed


def state_tensors(tr) -> dict:
    """Every tensor of a trainer's state by name, on the host."""
    import dataclasses

    out = {f"scene.{f.name}": getattr(tr.scene, f.name).detach().cpu()
           for f in dataclasses.fields(tr.scene) if getattr(tr.scene, f.name) is not None}
    for name, opt in (("opt", tr.optimizer), ("pose_opt", tr.pose_optimizer),
                      ("app_opt", tr.app_optimizer)):
        if opt is not None:
            for idx, st in opt.state_dict()["state"].items():
                out.update({f"{name}.{idx}.{k}": torch.as_tensor(v).detach().cpu()
                            for k, v in st.items()})
    if tr.pose_params is not None:
        out["pose"] = tr.pose_params.detach().cpu()
    if tr.app_module is not None:
        out.update({f"app.{k}": v.cpu() for k, v in tr.app_module.state_dict().items()})
    return out


def synced_ms(fn):
    """(result, ms) of ``fn()`` on the host clock, the card synchronised."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, 1e3 * (time.perf_counter() - t0)


def phase_training_loop(scene0):
    """Leg A: ``apps.train.run(chunked=True)`` for 40 steps with strategy
    "default" (refines at steps 10 and 20, capacity 16384, the opacity
    reset at 20), pose and appearance optimisation, a random background,
    evaluation with LPIPS at step 20 and at the end, checkpoints at 20 and
    at the end; each refine checked (counts, padding, state, the same
    refine on the CPU), the first step after the second refine recorded
    and its kernels held and timed (B4-, B5-, B3-refined); a full
    checkpoint round trip; ``render_traj``. Leg B: strategy "mcmc" through
    the per-step path, 21 steps, refines at 10 and 20, with 4096 planted
    dead Gaussians. Returns the three kernel records."""
    import copy
    import dataclasses
    import os
    import tempfile

    from tpugs_torch.apps.train import run
    from tpugs_torch.core.scene import pad_count
    from tpugs_torch.encoders import get_encoder
    from tpugs_torch.raster import kernels as K
    from tpugs_torch.raster.projection import project
    from tpugs_torch.raster.train import render_scene
    from tpugs_torch.train.config import TrainConfig
    from tpugs_torch.train.lpips import lpips_distance, random_lpips_params
    from tpugs_torch.train.metrics import psnr, ssim
    from tpugs_torch.train.strategy import PER_GAUSSIAN, DefaultStrategy, GradState
    from tpugs_torch.train.trainer import Trainer
    from tpugs_torch.utils.synthetic import orbit_cameras, random_scene

    w, h = W_FULL, H_FULL
    t_phase = t0 = time.perf_counter()
    cams = orbit_cameras(LOOP_CAMS, w, h, radius=3.0, device="cuda")
    target = random_scene(N_FULL, seed=0, extent=1.0, scale_range=(0.004, 0.02), device="cuda")
    views = [{"image": render_scene(target, cams.viewmats[c], cams.Ks[c], w, h,
                                    tile_size=TILE)[0],
              "viewmat": cams.viewmats[c], "K": cams.Ks[c], "image_id": c}
             for c in range(LOOP_CAMS)]
    del target
    trainset, valset = views[:LOOP_CAMS - LOOP_VAL], views[LOOP_CAMS - LOOP_VAL:]
    teacher = get_encoder("linear:512")
    cfg = TrainConfig(max_steps=40, sh_degree=3, feature_dim=128, feature_out_dim=512,
                      strategy="default", capacity_multiple=LOOP_CAPACITY, pose_opt=True,
                      app_opt=True, random_bkgd=True, sh_degree_interval=10,
                      refine_start_iter=10, refine_every=10, refine_stop_iter=30,
                      reset_every=20)

    def trainer(c, scene):
        return Trainer(c, scene, 1.0, teacher=teacher, width=w, height=h, n_cameras=LOOP_CAMS,
                       lpips_params=random_lpips_params("alex", 0))

    tr = trainer(cfg, scene0.to("cuda"))
    print(f"phase 9 set-up (targets rendered from the seed-0 scene, Trainer with pose and "
          f"appearance): {time.perf_counter() - t0:.1f} s", flush=True)

    rng = tr.strategy.rng = TimedRng(tr.strategy.rng)
    refines, resets, chunks, losses, records = [], [], [], [], []
    held = {"check_ms": 0.0, "armed": False, "peak": 0}
    orig = {k: getattr(tr, k) for k in ("refine", "reset_opacities", "_step_on", "train_chunk")}
    logit_cap = float(np.log(0.01 / 0.99))

    def refine():
        n_before = tr.scene.num_gaussians
        cpu_scene = tr._detached().to("cpu")
        cpu_state = GradState(tr.grad_state.grad2d_sum.cpu(), tr.grad_state.count.cpu())
        cpu_strategy = DefaultStrategy(cfg, tr.scene_scale)
        cpu_strategy.rng = copy.deepcopy(rng.rng)
        masks = {k: v.cpu() for k, v in tr.strategy.masks(tr._detached(), tr.grad_state).items()}
        drawn = rng.seconds
        info, ms = synced_ms(orig["refine"])
        draw_ms = 1e3 * (rng.seconds - drawn)
        alive, n = info["alive"], tr.scene.num_gaussians
        kept = int(masks["keep"].sum())
        check(n == pad_count(alive, LOOP_CAPACITY), f"N {n} is alive {alive} padded to 16384")
        check(alive == kept + info["duplicated"] + 2 * info["split"],
              "alive = kept + duplicated + 2 x split")
        s = tr._detached()
        for c in range(LOOP_CAMS):
            proj = project(s.means, s.quats, s.scales, s.opacities, cams.viewmats[c],
                           cams.Ks[c], w, h)
            check(not bool(proj.valid[alive:].any()), f"no padded row valid in view {c}")
        check(tr.grad_state.count.shape == (n,) and not bool(tr.grad_state.count.any())
              and not bool(tr.grad_state.grad2d_sum.any()), "GradState zero")
        check(len(tr.optimizer.state) == 0, "every optimizer state empty after a refine")
        new_cpu, _, info_cpu = cpu_strategy.refine(cpu_scene, cpu_state)
        masks_cpu = cpu_strategy.masks(cpu_scene, cpu_state)
        check(info_cpu == {k: info[k] for k in info_cpu}, f"CPU refine counts {info_cpu}")
        check(all(torch.equal(masks[k], masks_cpu[k]) for k in masks), "CPU refine masks")
        row_err = max(float((getattr(s, f)[:alive].cpu() - getattr(new_cpu, f)).abs().max())
                      for f in PER_GAUSSIAN)
        check(row_err <= 1e-6, f"CPU refine rows within 1e-6 ({row_err:.3e})")
        refines.append(dict(info, step=tr.step, n_before=n_before, n=n, ms=ms, draw_ms=draw_ms,
                            cpu_row_err=row_err))
        held["armed"] = len(refines) == 2
        return info

    def reset_opacities():
        orig["reset_opacities"]()
        group = next(g for g in tr.optimizer.param_groups if g["name"] == "opacities")
        check(not tr.optimizer.state.get(group["params"][0]), "opacities' state empty")
        check(float(tr.scene.logit_opacities.detach().max()) <= logit_cap + 1e-6,
              "every logit at most logit(0.01) after the reset")
        resets.append(tr.step)

    def step_on(*args, **kw):
        if not held["armed"]:
            return orig["_step_on"](*args, **kw)
        held["armed"] = False
        tr.record = seen = {}
        out = orig["_step_on"](*args, **kw)
        tr.record = None
        torch.cuda.synchronize()
        held["peak"] = max(held["peak"], torch.cuda.max_memory_allocated())
        saved = K.LAUNCHES.snapshot()
        t = time.perf_counter()
        records.extend(train_step_records(seen, w, h, saved, "phase 9 after the second refine",
                                          ("B4-refined", "B5-refined", "B3-refined")))
        del seen
        torch.cuda.synchronize()
        held["check_ms"] += 1e3 * (time.perf_counter() - t)
        for k, v in saved.items():
            setattr(K.LAUNCHES, k, v)
        torch.cuda.reset_peak_memory_stats()
        return out

    def train_chunk(staged, n_steps, cam_idx=None):
        step0, before = tr.step, held["check_ms"]
        out, ms = synced_ms(lambda: orig["train_chunk"](staged, n_steps, cam_idx))
        chunks.append((step0, tr.step, tr.scene.num_gaussians,
                       (ms - (held["check_ms"] - before)) / n_steps))
        losses.extend(out["loss"].tolist())
        return out

    tr.refine, tr.reset_opacities, tr._step_on, tr.train_chunk = (
        refine, reset_opacities, step_on, train_chunk)
    with tempfile.TemporaryDirectory() as out_dir:
        torch.cuda.reset_peak_memory_stats()
        K.LAUNCHES.reset()
        metrics, wall_ms = synced_ms(lambda: run(
            tr, trainset, valset, out_dir, eval_every=20, save_every=20, chunked=True,
            seed=cfg.seed, encoder=teacher))
        launches = K.LAUNCHES.snapshot()
        peak_gb = max(held["peak"], torch.cuda.max_memory_allocated()) / 1e9
        files = {os.path.relpath(os.path.join(d, f), out_dir)
                 for d, _, fs in os.walk(out_dir) for f in fs}
        check({"ckpts/ckpt_20.npz", "ckpts/full_20.npz", "ckpts/ckpt_39.npz",
               "ckpts/full_39.npz", "stats/val_step20.json", "stats/val_final.json"} <= files,
              f"the app's files {sorted(files)}")
        check(len(refines) == 2 and [r["step"] for r in refines] == [10, 20] and resets == [20],
              f"refines at 10 and 20, the reset at 20 ({refines}, {resets})")
        check(len(records) == 3, "the step after the second refine was recorded")
        check(len(losses) == cfg.max_steps and bool(np.isfinite(losses).all()),
              "every loss finite")
        for k in ("train_fwd", "train_bwd", "reduce"):
            check(launches[k] >= cfg.max_steps, f"{k} launched every step ({launches[k]})")
        for r, k in zip(records, ("train_fwd", "train_bwd", "reduce")):
            r["launches"] = launches[k]
        for k in ("psnr", "ssim", "lpips"):
            check(bool(np.isfinite(metrics[k])), f"final {k} finite")
        print(f"phase 9 leg A: run(chunked) {cfg.max_steps} steps in {wall_ms / 1e3:.1f} s "
              f"(with evals, checkpoints and checks); peak {peak_gb:.2f} GB; ms/step by chunk "
              f"[steps) N: " + ", ".join(f"[{a},{b}) {n} {ms:.2f}" for a, b, n, ms in chunks)
              + f"; losses {' '.join(f'{x:.4f}' for x in losses)}; launches {launches}",
              flush=True)
        for r in refines:
            print(f"phase 9 refine @ {r['step']}: N {r['n_before']} -> alive {r['alive']} "
                  f"(duplicated {r['duplicated']}, split {r['split']}, pruned {r['pruned']}) "
                  f"-> N {r['n']}; {r['ms']:.1f} ms ({r['draw_ms']:.1f} ms host draws, "
                  f"{r['ms'] - r['draw_ms']:.1f} ms the rest: the card's masks, gathers and "
                  f"concatenations and the host's syncs); the CPU refine: same counts and "
                  f"masks, rows within {r['cpu_row_err']:.3e}", flush=True)

        # the full checkpoint: save, load into a fresh trainer, bit for bit
        path = os.path.join(out_dir, "full_round_trip.npz")
        _, save_ms = synced_ms(lambda: tr.save_checkpoint_full(path))
        size_gb = os.path.getsize(path) / 1e9
        fresh = trainer(cfg, scene0.to("cuda"))
        _, load_ms = synced_ms(lambda: fresh.load_checkpoint_full(path))
        want, got = state_tensors(tr), state_tensors(fresh)
        check(fresh.step == tr.step == cfg.max_steps, "the step restored")
        check(set(got) == set(want) and all(torch.equal(got[k], want[k]) for k in want),
              "every tensor restored bit for bit")
        out = fresh.train_chunk(fresh.stage_dataset(trainset), 1)
        check(bool(np.isfinite(out["loss"]).all()), "the restored trainer takes a finite step")
        del fresh, want, got

    # evaluation, piece by piece, on the validation views
    parts = {"render": [], "psnr+ssim": [], "lpips": []}
    for v in valset:
        img, ms = synced_ms(lambda: tr.render_eval(v["viewmat"], v["K"])[0].clamp(0, 1))
        parts["render"].append(ms)
        parts["psnr+ssim"].append(synced_ms(lambda: (psnr(img, v["image"]),
                                                     ssim(img, v["image"])))[1])
        parts["lpips"].append(synced_ms(lambda: lpips_distance(tr.lpips_params, img, v["image"],
                                                               "cuda"))[1])
    frames = tr.render_traj(cams.Ks[0], "", n_frames=8)
    check(len(frames) == 8 and all(f.shape == (h, w, 3) and f.dtype == np.uint8 for f in frames),
          "render_traj: 8 uint8 frames")
    print(f"phase 9 eval (2 views, N {tr.scene.num_gaussians}): PSNR {metrics['psnr']:.3f}, "
          f"SSIM {metrics['ssim']:.4f}, LPIPS {metrics['lpips']:.4f} (random alex weights); "
          f"ms per image: " + ", ".join(f"{k} {np.mean(v):.2f}" for k, v in parts.items())
          + f"; full checkpoint {size_gb:.2f} GB: save {save_ms / 1e3:.2f} s, load "
          f"{load_ms / 1e3:.2f} s, restored bit for bit; render_traj 8 frames, "
          f"{sum(int(f.any()) for f in frames)} not black", flush=True)
    del tr

    # Leg B: MCMC through the per-step path, with planted dead Gaussians
    cfg_b = dataclasses.replace(cfg, strategy="mcmc", max_steps=21, pose_opt=False,
                                app_opt=False, reset_every=0)
    s0 = scene0.to("cuda")
    logits = s0.logit_opacities.clone()
    logits[:LOOP_DEAD] = -10.0
    trb = trainer(cfg_b, s0.replace(logit_opacities=logits))
    del s0, logits
    relocations, step_ms = [], []
    orig_b = {k: getattr(trb, k) for k in ("refine", "train_step")}

    def refine_b():
        dead = int((torch.sigmoid(trb.scene.logit_opacities) < cfg_b.prune_opa).sum())
        info, ms = synced_ms(orig_b["refine"])
        check(trb.scene.num_gaussians == N_FULL, "MCMC keeps N")
        check(info["relocated"] == dead, f"relocated {info['relocated']} = dead {dead}")
        check(len(trb.optimizer.state) == 0, "every optimizer state empty after a refine")
        relocations.append((trb.step, dead, ms))
        return info

    def train_step_b(batch, teacher_feats=None):
        n_refines = len(relocations)
        out, ms = synced_ms(lambda: orig_b["train_step"](batch, teacher_feats))
        if len(relocations) == n_refines:
            step_ms.append(ms)
        check(bool(np.isfinite(out["loss"])), "every loss finite")
        return out

    trb.refine, trb.train_step = refine_b, train_step_b
    with tempfile.TemporaryDirectory() as out_dir:
        run(trb, trainset, valset, out_dir, eval_every=0, save_every=0, seed=cfg.seed,
            encoder=teacher)
    check([r[0] for r in relocations] == [10, 20] and relocations[0][1] >= LOOP_DEAD,
          f"MCMC refines at 10 and 20, the planted dead relocated ({relocations})")
    print(f"phase 9 leg B (mcmc, per step): {np.mean(step_ms):.2f} ms/step over the "
          f"{len(step_ms)} steps without a refine (the teacher per step); refines " + ", ".join(
              f"@ {s}: {d} dead relocated, N {N_FULL}, {ms:.1f} ms" for s, d, ms in relocations),
          flush=True)
    print(f"phase 9 total: {time.perf_counter() - t_phase:.1f} s", flush=True)
    return records


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
    phase_clusters()
    phase_train_kernels()
    phase_train_geom()
    records, view, ref3 = phase_full_width()
    records += phase_experiments(view)
    del view
    train_records, scene0 = phase_train()
    records += train_records
    records += phase_eager()
    records += phase_absgrad()
    phase_app()
    lseg_records, field = phase_lseg(ref3["den"])
    records += lseg_records
    records += phase_queries(field, ref3)
    del field, ref3
    records += phase_training_loop(scene0)
    del scene0
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

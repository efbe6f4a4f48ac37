#!/usr/bin/env python3
"""Drive the PyTorch port (``tpugs_torch``) on one CUDA card and check it.

    python3 chip_smoke.py        # from the repo root; one H100, nvcc on the box

Seventeen phases; the first failure ends the run with a nonzero exit:

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
             kernels' widest, 300 and 512: B4's cluster kernel in two
             channel slices, B5's one-CTA kernel; B4 also at 600, in three
             slices, where B5 refuses the width; each width's launch
             counters; B4's alpha and exit blocks bit-equal to its wide
             kernel's; two launches bit-equal); S1's
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
             backward (ms, peak; B4's cluster kernel for both channel
             chunks, no wide-kernel launch; B5's geometry-only launch once, rebuilt
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
             render (B4-viz: the cluster kernel in two channel slices)
             against its twin on 64 tiles, its alpha and exit blocks
             bit-equal to the wide kernel's, timed beside the wide kernel,
             with its bound; the segment app's three GIFs and two scenes'
             per-frame PNGs written to a temporary directory and read back
             with cv2 (each GIF frame its encoder's palette of the frame,
             100-ms delays, endless loop; each PNG the frame), the
             compression round trip of the canonical scene on the card
             bit-equal to the CPU copies', the viewer's PNG of a frame and
             ``apply_float_colormap`` against its table; ``train_codec`` on
             the card (steps/s, the loss falls);
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
10. profiling — ``experiments/profile_stages.py`` at the canonical lift
             shape (view 0 of the 4-view rig, tile 32, 3 iterations, the
             plan's sub-stages, a ``torch.profiler`` trace of the full view):
             its stages' CUDA-event and host times, the roofline table at
             the H100's peaks and ``sol_estimate``; the full view's num and
             den bit-equal to phase 3's view 0, the write-back and gather
             unpermutes bit-equal to the XLA reduce, which is within f32
             rounding of B3; B1, B2 and B3 found in the trace by name, each
             within 10% of phase 3's CUDA-event time on the same inputs
             (B1-prof, B2-prof, B3-prof: phase 3's records with this
             phase's launches). The device idle share
             (``device_idle_share`` of a trace) of 2 lift views after a
             warm-up and of 2 train steps at phase 4's shape; the eager
             lift's stage split (``eager_lift_split``, 2 views, each stage
             synchronised), its field bit-equal to ``create_feature_field``'s;
             ``device_memory_stats`` after each.
11. interactive — on phase 7's LSeg-512 field: the viewer (``apps/viewer.py``)
             over the canonical scene for 8 scripted frames (w, d, 1, 2, 3,
             a drag of (40, -20) px, g for anaglyph, the axes overlay)
             through B4 with early exit: ms per frame, frames/s, B4's
             launches per frame, each frame within 1 LSB of the same frame
             through ``plan_render`` + ``rasterize_with_plan``, the 8 frames' idle share from a trace, the first
             frame's stage split (project, plan, SH+pack, B4, the uint8
             frame to the host; composed of ``render_scene``'s calls and
             bit-equal to ``render_frame``'s frame), B4-frame against its
             twin; a click session (``apps/click_and_segment.py``)
             on the scene plus 256 planted Gaussians whose field rows are a
             direction no scene row shares: the RGB+ED render (D = 4) and
             the 512-wide field render (B4's cluster kernel in channel
             slices) on the card, a
             positive click on the cluster and a negative one on the scene,
             ``mask3d`` equal to float64 outside ties with all 256 planted
             selected, the extracted pane black outside the cluster's
             footprint, ``remove_nearest`` removing the negative prompt, ms
             per piece and the peak (< 30 GB); the scene editor
             (``apps/viewer_llm.py``): three phrases parsed, then segment,
             change_color (256 each), the two resets (tensors restored bit
             for bit) and exit through an exemplar lookup; the tiny random
             GPT-2 backend where ``transformers`` imports.
12. dist    — the distribution (``tpugs_torch/dist``) on a world-size-1
             NCCL group started in this process (``file://`` store) and
             destroyed at the phase's end; a CPU mesh over it is refused.
             ``backproject_views_sharded`` on the (1, 1) mesh at phase 3's
             shape (its ``num`` and ``den`` bit-equal to phase 3's; ms/view
             beside phase 3's, the collectives' CUDA-event ms, the peak,
             the kernels launched every view); the sharded train step at
             phase 4's shape and batch 1 with the trainer's Adam against
             ``Trainer._step_on`` from the same initial scene (loss within
             1e-6, each leaf within 2e-5 of its max and ``feature_proj``
             within 1e-7, bit-equal leaves listed, vis equal to the view's
             valid rows), then 10 steps through
             ``make_trainer_chunk_sharded`` on 2 staged cameras (ms/step
             beside phase 4's, peak, launches every step); the exchange cap
             at view 0's survivor count (bit-equal to the uncapped step) and
             at half of it (``xover`` = survivors - cap exactly); one
             ``refine_sharded`` against ``Trainer.refine`` on the same state
             (phase 4's scene after one step, strategy "default", capacity
             16384: N, info and leaves equal); the dry run
             (``dist/dryrun.py``) and ``experiments/sharded_singlechip.py``
             at its defaults; ``torch.cuda.nccl.version()``.
13. at-scale training from disk — ``apps/make_atscale_dataset.main`` at
             the garden shape (2^19 ground-truth Gaussians, 185 orbit views
             at 1296 x 840, 100,000 SfM points) in a temporary directory:
             the seconds of the scene, the COLMAP model, the renders, the
             JPEGs (``cv2``) and ``ckpt.pt``; every decoded JPEG at a
             PSNR of at least 20 dB against its rendered frame and nearer
             it than to the frame with R and B swapped, a planted red and
             blue image kept.
             Then ``apps/train.main`` on it, chunked, 1100 steps, main's
             other defaults (features 128 against ``linear:512``, SH 3,
             strategy "default" at capacity 16384, SfM init, 161 train and
             24 validation views), its trainer wrapped on the class: parse,
             image reads and staging timed; the SfM init exactly 100,000
             Gaussians; ms/step and N per chunk; every refine (500, 600,
             ..., 1100) checked as phase 9's (the first replayed on the
             CPU), with its counts and the mean accumulated grad2d against
             ``grow_grad2d``; no opacity reset; the losses finite, the last
             chunk's mean below the first's; B4, B5 and B3 launched every
             step and held on 64 tiles of the first step after the refine
             at 1000 (B4-, B5-, B3-atscale, timed against their bounds);
             the final eval's ms per image, PSNR and SSIM; the final
             checkpoints' seconds and sizes; the peak; main's trajectory
             GIF (30 frames, read back with cv2; a failed write fails the
             phase), and ``render_traj`` with no path.
14. gather locality — ``experiments/gather_locality.main([])``: the pack-
             and reduce-shaped gathers by uniform-random, sorted and the
             two plans' indices (the default scene and its Morton order),
             the lift's stages per view on both scenes and both engines,
             the Morton lift against the default lift in scene order
             (equal to f32 rounding for the Gaussians neither moved in a
             span, which only a depth tie may explain, the plan ordering
             ties by index, nor in a tile that renders differently; a
             weight sum beyond rounding only where moved; the rest within
             the module's stated limits), each kernel launched every
             view; the Morton
             scene's lift alone with the counts set to 0, and its view 0
             held against the twins and timed as phase 3's (B1-, B2-, B3-,
             B6-, B7-morton, with that lift's counts).
15. weight conversion — ``apps/convert_weights.main`` on the card on
             seeded random LSeg-512 (lang-seg's layout, the dropped
             families planted) and DINOv2 ViT-L/14-reg checkpoints and a
             small BPE file: each self-check's output bit-equal to its
             module's own forward, the report's counts the modules', a
             planted unknown key raising.
16. kernels line — one JSON object per kernel with its launches, errors,
             time, the twin's time, its bound on this card and, where one
             exists, the time of one library call that computes the same
             function (a sparse CSR product for B3, B7 and S2; S1's
             ``index_copy_``); phase 5's four kernels as B4-, B2-, B3- and
             B5-tiled, B5's geometry-only launch as B5-geom, phase 7's
             as B2-lseg, B3-lseg, B2-dino and B3-dino, phase 8's
             feature render as B4-viz, phase 9's as B4-, B5- and
             B3-refined, phase 10's as B1-, B2- and B3-prof, phase 11's
             viewer frame as B4-frame, phase 13's as B4-, B5- and
             B3-atscale and phase 14's as B1-, B2-, B3-, B6- and B7-morton.

The last line is ``{"ok": true, "device": {...}}``. Without a CUDA card,
or without the package beside this file, it exits nonzero and prints no
result. Nothing here imports JAX or the ``tpugs`` package.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
import warnings

import numpy as np
import torch

try:  # the package beside this script; main() stops with a message without it
    from tpugs_torch.utils.profiling import PEAKS_H100
except ImportError:
    PEAKS_H100 = None
else:  # published H100 SXM peaks (NVIDIA data sheet, dense): the bounds below
    PEAK_BYTES_S = PEAKS_H100["hbm_gbps"] * 1e9
    PEAK_BF16_FLOPS = PEAKS_H100["tflops_bf16"] * 1e12
    PEAK_F32_FLOPS = PEAKS_H100["tflops_f32"] * 1e12
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
# in clusters of 8 (tile 32) and 2 (tile 16) CTAs up to D = 256; above it
# B4's cluster kernel in 2 (300, 512) or 3 (600) channel slices and B5's
# one-CTA kernel up to its 512 channels (train_fwd_cluster, train_cluster)
TRAIN_KERNEL_SHAPES = ((32, 131, 0), (16, 20, 1), (32, 3, 1), (16, 131, 0), (32, 256, 0),
                       (16, 300, 1), (32, 300, 1), (16, 512, 0), (32, 512, 1), (16, 600, 1),
                       (32, 600, 0))


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
        check(launched == (1, 0) and fwd_cluster[2] == -(-D // T.SLICE_CHANNELS),
              f"B4 at D = {D} launched its cluster kernel in {fwd_cluster[2]} channel slices "
              f"({launched})")
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
        kind = "cluster (C, P, S, Ns) = {}".format(fwd_cluster)
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
        if D > T.MAX_CHANNELS:  # RenderTrain renders such widths in chunks of B5's widest
            try:
                T.train_rows(*args)
            except ValueError:
                print(f"phase 2 ts={ts} D={D} B5 refuses the width (MAX_CHANNELS "
                      f"{T.MAX_CHANNELS})", flush=True)
            else:
                check(False, f"B5 refuses D = {D}")
            continue
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


def timed_lift(args, engine: str, lift=None, extra_stages=(), **kw):
    """The 8 views through ``lift`` (default ``backproject_views``) with
    ``engine`` and keywords ``kw``: (num, den, ms/view, launches, peak GB,
    stage ms/view, peak GB within each stage). ``extra_stages`` names the
    stages that ``lift`` reports beyond the per-view ones."""
    from tpugs_torch.lift.batch import STAGES, backproject_views
    from tpugs_torch.raster import kernels as K

    STAGES = STAGES + tuple(extra_stages)
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


def lift_view_records(scene, cams, enc, launches, launches_s, tag, suffix=""):
    """View 0 of ``cams`` through ``run_view`` with both engines: 64 random
    tiles against the twins (B1, B2, B3, B6, B7), B1's culled walk against
    its unculled instantiation on every tile, the kernels' and twins' times,
    the library calls' and the bounds of the view's work. ``launches`` and
    ``launches_s`` are each engine's counts from the caller's run. Returns
    the kernel records (ids with ``suffix``) and the default engine's
    ``ViewResult``."""
    from tpugs_torch.kernels.build import load_library
    from tpugs_torch.lift.batch import run_view
    from tpugs_torch.raster import kernels as K
    from tpugs_torch.utils.timing import time_cuda

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
    print(f"{tag} check on 64 tiles ({len(gids)} Gaussians): B1 rel {b1[1]:.3e}, "
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
    print(f"{tag} B1 on every tile of view 0: culled bit-equal to unculled (image and "
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
    print(f"{tag} library calls (sparse CSR @ f32 rows): B3 {b3_lib:.3f} ms, "
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
    print(f"{tag} work of one view: {n_tiles} tiles, {n_isects} intersections, "
          f"T_padded {T_padded}, {int(r.blocks_done.sum())} blocks walked "
          f"({pairs} pixel-Gaussian pairs); scatter layout R_striped {plan_s.R_striped}, "
          f"{plan_s.stripe_base.shape[0]} stripes; B1 {b1_ms:.4f} ms (unculled "
          f"{b1_unculled:.4f}, twin {b1_plain:.1f}; bound {b1_bound[0]:.4f} ms by "
          f"{b1_bound[1]} on the nonzero-alpha pairs, share {b1_bound[0] / b1_ms:.3f}; "
          f"{b1_walked[0]:.4f} ms on the walked pairs, share {b1_walked[0] / b1_ms:.3f}); "
          f"B2 {b2_ms:.3f} ms, B3 {b3_ms:.3f} ms; "
          f"B6 {b6_ms:.3f} ms (twin {b6_plain:.1f}), "
          f"B7 {b7_ms:.3f} ms (twin {b7_plain:.1f})", flush=True)

    b1_rec = rec("B1" + suffix, "render", "tpugs_torch/csrc/render.cu",
                 "tpugs/raster/pallas_tiled.py:1370", launches["render"], b1, b1_ms,
                 b1_plain, b1_bound)
    b1_rec.update(bound_walked_ms=b1_walked[0], unculled_ms=b1_unculled,
                  resident_clusters=load_library().tpugs_render_max_clusters(TILE, 1))
    records = [
        b1_rec,
        rec("B2" + suffix, "adjoint", "tpugs_torch/csrc/adjoint.cu",
            "tpugs/raster/pallas_tiled.py:1623", launches["adjoint"], b2, b2_ms,
            b2_plain, b2_bound),
        rec("B3" + suffix, "reduce", "tpugs_torch/csrc/reduce.cu",
            "tpugs/raster/pallas_tiled.py:2233", launches["reduce"], b3, b3_ms,
            b3_plain, b3_bound, b3_lib),
        rec("B6" + suffix, "adjoint_scatter", "tpugs_torch/csrc/adjoint.cu",
            "tpugs/raster/pallas_tiled.py:1927", launches_s["adjoint_scatter"], b6, b6_ms,
            b6_plain, b6_bound),
        rec("B7" + suffix, "stripe_sum", "tpugs_torch/csrc/stripe_sum.cu",
            "tpugs/raster/pallas_tiled.py:2007", launches_s["stripe_sum"], b7, b7_ms,
            b7_plain, b7_bound, b7_lib),
    ]
    return records, r


def phase_full_width():
    """The canonical shape through the entry point, with both reduce
    engines. Returns the kernel records for the kernels line, one view's
    result for the experiments phase and the default engine's num and den
    (CPU), ms/view and peak GB for phases 7 and 8."""
    from tpugs_torch.encoders.base import LinearRGBEncoder
    from tpugs_torch.lift.batch import backproject_views
    from tpugs_torch.utils.synthetic import orbit_cameras, random_scene

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

    records, r = lift_view_records(scene, cams, enc, launches, launches_s, "phase 3")
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
            "tpugs_torch/csrc/exp_scatter_write.cu", "scripts/exp_scatter_write.py:124",
            s1_launches, worst, s1["scatter", 0], s1_plain, s1_bound, s1_lib),
        rec("S1-probe", "async_copy_probe", "tpugs_torch/csrc/exp_scatter_write.cu",
            "scripts/exp_scatter_write.py:158", probe_launches, probe_err, probe_ms,
            probe_plain, bound(32 + 4, 0, PEAK_F32_FLOPS)),
        rec("S2", "reduce_tail stripe (gather + stripe_sum in column order)",
            "tpugs_torch/csrc/stripe_sum.cu", "scripts/exp_reduce_tail.py:85",
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
            "tpugs/raster/pallas_train.py:250", launches["train_fwd"], b4, b4_ms, b4_plain,
            b4_bound),
        rec(ids[1], "train_bwd", "tpugs_torch/csrc/train_bwd.cu",
            "tpugs/raster/pallas_train.py:557", launches["train_bwd"], b5, b5_ms, b5_plain,
            b5_bound),
        rec(ids[2], "reduce (train rows)", "tpugs_torch/csrc/reduce.cu",
            "tpugs/raster/pallas_tiled.py:2233", launches["reduce"], b3, b3_ms,
            b3_plain, b3_bound, b3_lib),
    ]


def phase_train():
    """The train step at full width through ``Trainer.train_chunk``: 3
    warm-up steps (SH degrees 0-2, sh_degree_interval 1), then 10 timed
    steps at degree 3. Returns the kernel records of B4, B5 and B3 on the
    train rows, the initial scene on the host (phases 9 and 12 start there) and
    the timed steps' ms/step and peak GB (phase 12 compares)."""
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
            scene0.to("cpu"), {"ms_step": 1e3 * wall / TRAIN_STEPS, "peak_gb": peak_gb})


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
    check(launches["train_fwd"] == 2 and launches["train_fwd_wide"] == 0,
          f"the forward rendered both channel chunks (512 in 2 slices, 3) through B4's "
          f"cluster kernel ({launches})")
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


def lift_records(tag, r, D, launches, replaces_b2, replaces_b3, phase="phase 7"):
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
    print(f"{phase} {tag} D={D}: check on 64 tiles ({len(gids)} Gaussians): B2 bf16 "
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
# functions the apps call (timed with no output path; the segment app's
# files are then written and read back by ``write_checks``).
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


def read_gif_cv2(path):
    """(frames RGB, durations ms, loop) of a GIF, decoded by cv2."""
    import cv2

    ok, anim = cv2.imreadanimation(path)
    check(bool(ok), f"cv2 decodes {os.path.basename(path)}")
    return ([np.ascontiguousarray(f[..., 2::-1]) for f in anim.frames],
            [int(x) for x in anim.durations], int(anim.loop_count))


def gif_holds(path, frames) -> str:
    """Checks the GIF at ``path`` against ``frames``: each decoded frame
    equal to its encoder's palette of the frame, 100-ms delays, endless
    loop; returns a summary (the decoded frames' mean error)."""
    from tpugs_torch.io.images import gif_palette

    got, durations, loop = read_gif_cv2(path)
    check(len(got) == len(frames) and durations == [100] * len(frames) and loop == 0,
          f"{os.path.basename(path)}: {len(frames)} frames of 100 ms, endless loop "
          f"({len(got)}, {durations[:3]}, {loop})")
    errs = []
    for g, f in zip(got, frames):
        palette, idx = gif_palette(f)
        check(np.array_equal(g, palette[idx]), f"{os.path.basename(path)}: a frame decodes "
              f"to its palette")
        errs.append(float(np.abs(g.astype(int) - f.astype(int)).mean()))
    return (f"{os.path.basename(path)} {len(got)} frames ({os.path.getsize(path) / 1e6:.2f} MB, "
            f"mean error {np.mean(errs):.3f})")


def write_checks(scene, planted, pos_q, neg_q, cams, extracted, deleted, w, h):
    """The segment app's three GIFs and the extracted and deleted scenes'
    per-frame PNGs, written as the app writes them into a temporary
    directory and read back with cv2; the compression round trip of the
    scene on the card against the same round trip of CPU copies, bit for
    bit; the viewer's PNG of one frame; ``apply_float_colormap`` against a
    lookup in its table. Prints one line per piece."""
    import tempfile

    import cv2

    from tpugs_torch.convert import scene_to_numpy
    from tpugs_torch.core.scene import GaussianScene
    from tpugs_torch.io.compression import compress_scene, compressed_size_bytes, decompress_scene
    from tpugs_torch.io.images import read_image
    from tpugs_torch.train.colormaps import TURBO
    from tpugs_torch.train.modules import apply_float_colormap
    from tpugs_torch.train.viewer import encode_png
    from tpugs_torch.viz.gif import render_mask_2d_to_gif, render_to_gif

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        paths = {k: os.path.join(tmp, f"{k}.gif") for k in ("mask2d", "extracted", "deleted")}
        frames = {"mask2d": render_mask_2d_to_gif(scene, planted, pos_q, neg_q, cams,
                                                  paths["mask2d"]),
                  "extracted": render_to_gif(paths["extracted"], extracted, cams,
                                             use_checkerboard_background=True),
                  "deleted": render_to_gif(paths["deleted"], deleted, cams)}
        write_s = time.perf_counter() - t0
        lines = [gif_holds(paths[k], frames[k]) for k in paths]
        n_png = 0
        for k in ("extracted", "deleted"):
            for c, f in enumerate(frames[k]):
                got = read_image(f"{paths[k]}.images/frame_{c:04d}.png")
                check(np.array_equal(got, f), f"{k} frame {c}'s PNG decodes to the frame")
                n_png += 1
        print(f"phase 8 segment files (render_mask_2d_to_gif, render_to_gif with paths, "
              f"{write_s:.1f} s with their renders): " + "; ".join(lines)
              + f"; {n_png} per-frame PNGs equal to their frames", flush=True)

        # compression: the scene on the card and its CPU copy, round trips equal
        t0 = time.perf_counter()
        compress_scene(scene, os.path.join(tmp, "card"))
        back = decompress_scene(os.path.join(tmp, "card"), device="cuda")
        comp_s = time.perf_counter() - t0
        cpu = GaussianScene(**{k: v.cpu() for k, v in vars(scene).items()
                               if isinstance(v, torch.Tensor)})
        compress_scene(cpu, os.path.join(tmp, "cpu"))
        back_cpu = decompress_scene(os.path.join(tmp, "cpu"), device="cpu")
        a, b = scene_to_numpy(back), scene_to_numpy(back_cpu)
        same = all(np.array_equal(a[k], b[k]) for k in a)
        files_same = all(
            np.array_equal(read_image(os.path.join(tmp, "card", f)),
                           read_image(os.path.join(tmp, "cpu", f)))
            for f in os.listdir(os.path.join(tmp, "card")) if f.endswith(".png"))
        print(f"phase 8 compression of the canonical scene (N={scene.num_gaussians}): "
              f"{compressed_size_bytes(os.path.join(tmp, 'card')) / 1e6:.3f} MB in "
              f"{len(os.listdir(os.path.join(tmp, 'card')))} files, round trip {comp_s:.2f} s; "
              f"the card's round trip equals the CPU copy's bit for bit {same}, PNGs equal "
              f"{files_same}", flush=True)
        check(same and files_same, "the compression round trip on the card equals the CPU's")
        del back, back_cpu, cpu

    # the viewer's PNG of a frame; the colormap against its table
    frame = frames["mask2d"][0]
    png = encode_png(frame)
    dec = cv2.imdecode(np.frombuffer(png, np.uint8), cv2.IMREAD_UNCHANGED)[..., ::-1]
    check(np.array_equal(dec, frame), "the viewer's PNG decodes to the frame")
    x = np.concatenate([np.random.default_rng(3).uniform(-0.2, 1.2, 100_000),
                        [0.0, 1.0, np.nan, np.inf, -np.inf, 255 / 256]])
    idx = np.clip(np.floor(np.nan_to_num(np.clip(x, 0, 1), nan=0.0) * 256), 0, 255).astype(int)
    want = (TURBO[idx] * 255).astype(np.uint8)
    want[np.isnan(x)] = 0
    cmap_ok = np.array_equal(apply_float_colormap(x), want)
    print(f"phase 8 viewer PNG of a {w}x{h} frame: {len(png) / 1e6:.3f} MB, decodes to the "
          f"frame; apply_float_colormap on {len(x)} values (0, 1, NaN, infinities, out of "
          f"range) equals the turbo table's lookup {cmap_ok}", flush=True)
    check(cmap_ok, "apply_float_colormap equals its table's lookup")


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
    check(launches_m["train_fwd"] >= 2 * VIEWS and launches_m["train_fwd_wide"] == 0,
          f"mask2d: B4's cluster kernel at D = 3 and, in channel slices, at D = {d} on every "
          f"view ({launches_m})")

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
          f"{m2d_peak:.2f} GB), opacity-hidden {seg_ms['opacity']:.2f}; B4 launches: "
          f"extracted {launches_e['train_fwd']}, deleted {launches_d['train_fwd']}, mask2d "
          f"{launches_m['train_fwd']} (D=3 and D={d} on each view), the wide kernel "
          f"{launches_m['train_fwd_wide']}; segment_by_opacity(~mask) against the deleted "
          f"scene: max abs {worst:.3e} per pixel (bound 1/510), frames within {frames_close}",
          flush=True)
    check(worst <= 1 / 510, "the opacity-hidden render equals the deleted scene's within 1/510")

    # B4-viz: the D = 512 feature render of view 0 (B4's cluster kernel in
    # channel slices) against its twin, its alpha and exit blocks against the
    # wide kernel's, its time beside the wide kernel's, and its bound on the
    # pairs with a nonzero weight
    from tpugs_torch.kernels.build import load_library

    geom, cols, plan, done = (seen[k] for k in ("geom", "cols", "plan", "blocks_done"))
    ts = plan.tile_size
    layout = T.train_fwd_cluster(ts, d)
    vgen = torch.Generator(device="cuda").manual_seed(8)
    tiles = torch.randperm(plan.n_tiles, device="cuda", generator=vgen)[:64]
    inside = tile_inside(h, w, ts, tiles)
    img_t, alpha_t, done_t = T.train_tiles_plain(geom, cols, plan, 0.0, tiles)
    b4v = rel_err(torch.where(inside, image_to_tiles(seen["image"], ts)[tiles], 0.0),
                  torch.where(inside, img_t, 0.0))
    alpha_tiles = image_to_tiles(seen["alpha"][..., None], ts)[..., 0]
    b4v_alpha = rel_err(torch.where(inside[..., 0], alpha_tiles[tiles], 0.0),
                        torch.where(inside[..., 0], alpha_t, 0.0))
    done_twin = torch.equal(done[tiles], done_t)
    del img_t, alpha_t
    wide = lambda: T._launch_train_fwd(load_library(), geom, cols, plan, 0.0, None)  # noqa: E731
    img_w, alpha_w, done_w = wide()
    as_wide = torch.equal(seen["alpha"], alpha_w) and torch.equal(done, done_w)
    _, b4v_wide_rel = rel_err(seen["image"], img_w)
    del img_w, alpha_w, done_w
    b4v_ms = time_cuda(lambda: T.train_forward(geom, cols, plan, 0.0), 3)
    b4v_wide_ms = time_cuda(wide, 3)
    b4v_plain = time_cuda(lambda: T.train_forward_plain(geom, cols, plan, 0.0), 1)
    pairs, weighted, _ = walked_pairs(geom, plan, 0.0)
    walked = int(done.sum())
    b4v_bound = bound(walked * 128 * (8 + d) * 4 + h * w * (d + 1) * 4,
                      pairs * PAIR_OPS + weighted * 2 * d, PEAK_F32_FLOPS)
    b4v_walked = bound(walked * 128 * (8 + d) * 4 + h * w * (d + 1) * 4,
                       pairs * (PAIR_OPS + 2 * d), PEAK_F32_FLOPS)
    print(f"phase 8 B4-viz (cluster kernel, (C, P, S, Ns) = {layout}, D={d}, tile {ts}, "
          f"trans_eps=0) on view 0's feature image: 64 tiles against the twin, image rel "
          f"{b4v[1]:.3e}, alpha rel {b4v_alpha[1]:.3e}, exit blocks equal {done_twin}; against "
          f"the wide kernel: image rel {b4v_wide_rel:.3e}, alpha and exit blocks bit-equal "
          f"{as_wide}; {b4v_ms:.3f} ms, the wide kernel {b4v_wide_ms:.3f} ms in the same call "
          f"(twin {b4v_plain:.1f}); {pairs} pairs walked, {weighted} with a nonzero weight; "
          f"bound {b4v_bound[0]:.4f} ms by {b4v_bound[1]}, share {b4v_bound[0] / b4v_ms:.3f} "
          f"(the wide kernel's {b4v_bound[0] / b4v_wide_ms:.3f}; {b4v_walked[0]:.4f} on the "
          f"walked pairs' products)", flush=True)
    check(b4v[1] <= 1e-4 and b4v_alpha[1] <= 1e-4 and done_twin,
          "B4 at D = 512 within 1e-4 of its twin, its exit blocks equal")
    check(as_wide and b4v_wide_rel <= 1e-4, "B4 at D = 512: alpha and exit blocks bit-equal to "
          "the wide kernel's, the image within 1e-4")
    b4v_rec = rec("B4-viz", "train_fwd (feature image in channel slices, trans_eps 0)",
                  "tpugs_torch/csrc/train_fwd.cu", "tpugs/raster/pallas_train.py:250",
                  launches_m["train_fwd"] - VIEWS, b4v, b4v_ms, b4v_plain, b4v_bound)
    b4v_rec.update(bound_walked_ms=b4v_walked[0], wide_ms=b4v_wide_ms)
    del seen, geom, cols, plan, done, frames_e, frames_d, frames_m, frames_h, hidden

    # the segment app's files, as it writes them (output paths given), read
    # back with cv2 alone: each GIF's frames equal to its encoder's palette
    # of the returned frame, its delays and loop; each per-frame PNG equal
    # to the frame; then the compressed scene, the viewer's PNG and the
    # colormap
    write_checks(scene, planted, pos_q, neg_q, cams, extracted, deleted, w, h)
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
    check(launches_f["train_fwd"] >= VIEWS and launches_f["train_fwd_wide"] == 0,
          "PCA frame mode renders D = 512 through B4's cluster kernel in channel slices")
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


def refine_checked(tr, orig_refine, rng, views, w, h, capacity, replay_cpu=True):
    """One "default" refine of ``tr`` through ``orig_refine``, checked: N is
    the refined count padded to ``capacity``, that count is kept +
    duplicated + 2 x split, no padded row is valid in ``project`` in any of
    ``views`` ((viewmat, K) pairs), ``GradState`` is zero and the optimizer
    state empty; with ``replay_cpu``, the same refine on CPU copies (scene,
    statistics, a copy of the generator ``rng``, a ``TimedRng``) gives the
    same counts and masks, rows within 1e-6. Returns (info, the record: info
    with the step, N before and after, ms, host draw ms, the CPU rows'
    error or None, the mean accumulated grad2d of the visible Gaussians and
    their share above ``grow_grad2d``)."""
    import copy

    from tpugs_torch.core.scene import pad_count
    from tpugs_torch.raster.projection import project
    from tpugs_torch.train.strategy import PER_GAUSSIAN, DefaultStrategy, GradState

    cfg = tr.cfg
    n_before = tr.scene.num_gaussians
    seen = tr.grad_state.count > 0
    avg = tr.grad_state.grad2d_sum[seen] / tr.grad_state.count[seen]
    grad_mean = float(avg.mean()) if avg.numel() else 0.0
    grad_high = float((avg > cfg.grow_grad2d).float().mean()) if avg.numel() else 0.0
    if replay_cpu:
        cpu_scene = tr._detached().to("cpu")
        cpu_state = GradState(tr.grad_state.grad2d_sum.cpu(), tr.grad_state.count.cpu())
        cpu_strategy = DefaultStrategy(cfg, tr.scene_scale)
        cpu_strategy.rng = copy.deepcopy(rng.rng)
    masks = {k: v.cpu() for k, v in tr.strategy.masks(tr._detached(), tr.grad_state).items()}
    drawn = rng.seconds
    info, ms = synced_ms(orig_refine)
    draw_ms = 1e3 * (rng.seconds - drawn)
    alive, n = info["alive"], tr.scene.num_gaussians
    kept = int(masks["keep"].sum())
    check(n == pad_count(alive, capacity), f"N {n} is alive {alive} padded to {capacity}")
    check(alive == kept + info["duplicated"] + 2 * info["split"],
          "alive = kept + duplicated + 2 x split")
    s = tr._detached()
    for c, (vm, K) in enumerate(views):
        proj = project(s.means, s.quats, s.scales, s.opacities, vm, K, w, h)
        check(not bool(proj.valid[alive:].any()), f"no padded row valid in view {c}")
    check(tr.grad_state.count.shape == (n,) and not bool(tr.grad_state.count.any())
          and not bool(tr.grad_state.grad2d_sum.any()), "GradState zero")
    check(len(tr.optimizer.state) == 0, "every optimizer state empty after a refine")
    row_err = None
    if replay_cpu:
        new_cpu, _, info_cpu = cpu_strategy.refine(cpu_scene, cpu_state)
        masks_cpu = cpu_strategy.masks(cpu_scene, cpu_state)
        check(info_cpu == {k: info[k] for k in info_cpu}, f"CPU refine counts {info_cpu}")
        check(all(torch.equal(masks[k], masks_cpu[k]) for k in masks), "CPU refine masks")
        row_err = max(float((getattr(s, f)[:alive].cpu() - getattr(new_cpu, f)).abs().max())
                      for f in PER_GAUSSIAN)
        check(row_err <= 1e-6, f"CPU refine rows within 1e-6 ({row_err:.3e})")
    return info, dict(info, step=tr.step, n_before=n_before, n=n, ms=ms, draw_ms=draw_ms,
                      cpu_row_err=row_err, kept=kept, grad_mean=grad_mean, grad_high=grad_high)


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
    import dataclasses
    import os
    import tempfile

    from tpugs_torch.apps.train import run
    from tpugs_torch.encoders import get_encoder
    from tpugs_torch.raster import kernels as K
    from tpugs_torch.raster.train import render_scene
    from tpugs_torch.train.config import TrainConfig
    from tpugs_torch.train.lpips import lpips_distance, random_lpips_params
    from tpugs_torch.train.metrics import psnr, ssim
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
        info, r = refine_checked(tr, orig["refine"], rng, [
            (cams.viewmats[c], cams.Ks[c]) for c in range(LOOP_CAMS)], w, h, LOOP_CAPACITY)
        refines.append(r)
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


# Phase 10: the profiling tools at the canonical lift shape. Kernel names
# as the profiler's trace shows them (demangled, in namespace tpugs).
KERNEL_PATTERNS = {"B1": r"tpugs::.*\brender_kernel\b", "B2": r"tpugs::.*\badjoint_kernel\b",
                   "B3": r"tpugs::.*\breduce_kernel\b"}
TRACE_TOL = 0.10  # a kernel's mean ms in the trace against its CUDA-event ms
XLA_REDUCE_TOL = 1e-5  # the XLA reduce's sums against B3's, of the max
EAGER_VIEWS, IDLE_VIEWS, IDLE_STEPS = 2, 2, 2


def mem_line(tag):
    from tpugs_torch.utils.profiling import device_memory_stats

    m = device_memory_stats()
    return (f"{tag}: device_memory_stats in use {m['bytes_in_use'] / 1e9:.2f} GB, peak "
            f"{m['peak_bytes_in_use'] / 1e9:.2f} GB of {m['bytes_limit'] / 1e9:.2f} GB")


def traced_idle(tag, fn):
    """``fn()`` under ``torch.profiler`` inside one annotation, synchronised
    before the annotation closes; returns ``device_idle_share`` of that
    window. The trace is deleted after it is read."""
    import shutil
    import tempfile

    from tpugs_torch.utils.profiling import annotation, device_idle_share, trace

    tmp = tempfile.mkdtemp(prefix="tpugs_trace_")
    try:
        with trace(tmp) as path:
            with annotation(tag):
                fn()
                torch.cuda.synchronize()
        idle = device_idle_share(path)
        size = os.path.getsize(path)
    finally:
        shutil.rmtree(tmp)
    check(idle["events"] > 0, f"the {tag} trace holds device work (CUPTI traced the card)")
    return idle, size


def train_for_idle(scene0):
    """A trainer at phase 4's shape on its initial scene, with its staged
    images and camera indices."""
    from tpugs_torch.encoders import get_encoder
    from tpugs_torch.train.config import TrainConfig
    from tpugs_torch.train.trainer import Trainer
    from tpugs_torch.utils.synthetic import orbit_cameras

    w, h = W_FULL, H_FULL
    rng = np.random.default_rng(1)
    cams = orbit_cameras(TRAIN_CAMS, w, h, radius=3.0, device="cuda")
    images = torch.from_numpy(rng.uniform(0, 1, (TRAIN_CAMS, h, w, 3)).astype(np.float32)).cuda()
    cfg = TrainConfig(max_steps=30_000, sh_degree=3, feature_dim=128, feature_out_dim=512,
                      strategy="none", random_bkgd=False, sh_degree_interval=1)
    tr = Trainer(cfg, scene0, 1.0, teacher=get_encoder("linear:512"), width=w, height=h,
                 n_cameras=TRAIN_CAMS)
    staged = {"images": images, "viewmats": cams.viewmats, "Ks": cams.Ks}
    return tr, staged, rng.integers(0, TRAIN_CAMS, 1 + IDLE_STEPS)


def phase_profiling(view0, scene0, ref3):
    """``profile_stages.main`` at the canonical shape with its plan
    breakdown and a trace; the three idle shares' first two (the lift, the
    train step); the eager lift's stage split. ``view0`` is phase 3's view
    0 (num, den) on the host, ``scene0`` phase 4's initial scene, ``ref3``
    phase 3's records B1, B2 and B3 by id. Returns the records B1-prof,
    B2-prof, B3-prof: the profiled view is phase 3's view 0 (the same
    inputs, its num and den checked bit-equal), so each is phase 3's record
    (errors, times, twin times, bounds) with this phase's launches."""
    import shutil
    import tempfile

    from tpugs_torch.encoders.base import LinearRGBEncoder
    from tpugs_torch.experiments import profile_stages
    from tpugs_torch.experiments.profile_stages import eager_lift_split
    from tpugs_torch.lift.backproject import create_feature_field
    from tpugs_torch.lift.batch import backproject_views
    from tpugs_torch.raster import kernels as K
    from tpugs_torch.utils.profiling import StageTimer, kernel_times
    from tpugs_torch.utils.synthetic import orbit_cameras, random_scene

    t_phase = time.perf_counter()
    # 1. the stage profiler, its trace held to the profiled kernels
    torch.cuda.reset_peak_memory_stats()
    tmp = tempfile.mkdtemp(prefix="tpugs_profile_")
    try:
        K.LAUNCHES.reset()
        out = profile_stages.main([
            "--num-gaussians", str(N_FULL), "--width", str(W_FULL), "--height", str(H_FULL),
            "--feature-dim", str(D_FULL), "--tile", str(TILE), "--iters", "3",
            "--plan-breakdown", "--profile-dir", tmp, "--device", "cuda"])
        launches = K.LAUNCHES.snapshot()
        in_trace = {k: kernel_times(out["trace"], p) for k, p in KERNEL_PATTERNS.items()}
        trace_mb = os.path.getsize(out["trace"]) / 1e6
    finally:
        shutil.rmtree(tmp)
    print(mem_line("phase 10 profile_stages"), flush=True)
    for name in ("render", "adjoint", "reduce"):
        check(launches[name] > 0, f"profile_stages launched {name}")
    same_view = (torch.equal(out["num"].cpu(), view0[0])
                 and torch.equal(out["den"].cpu(), view0[1]))
    sums = out["sums"]
    unperm_equal = (torch.equal(sums["gather"], sums["write-back"])
                    and torch.equal(sums["gather"], sums["xla"]))
    xla_err = rel_err(sums["xla"], sums["pallas"])
    print(f"phase 10 profile_stages: the full view's num and den bit-equal to phase 3's view 0 "
          f"{same_view}; the two unpermutes bit-equal to the XLA reduce {unperm_equal}, which "
          f"is against B3 {xla_err[0]:.3e} abs, {xla_err[1]:.3e} of max; launches {launches}",
          flush=True)
    check(same_view, "the profiled view's num and den equal phase 3's view 0 bit for bit")
    check(unperm_equal, "the write-back and gather unpermutes bit-equal to the XLA reduce")
    check(xla_err[1] <= XLA_REDUCE_TOL, "the XLA reduce within f32 rounding of B3")
    del out["num"], out["den"], out["sums"], sums

    # the trace's kernels against phase 3's back-to-back CUDA-event times of
    # the same kernels on the same inputs; profile_stages' own time of one
    # call from an idle card (printed beside them) also holds the launch's
    # latency
    records, lines = [], []
    for kid, name, label in (("B1", "render", "render kernel (B1)"),
                             ("B2", "adjoint", "adjoint kernel (B2, bf16)"),
                             ("B3", "reduce", "reduce (B3)")):
        ref = ref3[kid]
        records.append(dict(ref, id=f"{kid}-prof", launches=launches[name]))
        n, total = in_trace[kid]
        mean = total / max(n, 1)
        lines.append(f"{kid} {n} launches, {mean:.4f} ms each (CUDA events back to back "
                     f"{ref['ms']:.4f}, one call from idle {out['ms'][label]:.4f})")
        check(n > 0, f"the trace holds {kid}'s kernel by name")
        check(abs(mean - ref["ms"]) <= TRACE_TOL * ref["ms"],
              f"{kid}'s trace time within {TRACE_TOL:.0%} of its CUDA-event time")
    print(f"phase 10 trace of the full view ({trace_mb:.1f} MB): " + "; ".join(lines),
          flush=True)

    # 2. idle shares: the lift (2 views after a warm-up), the train step
    scene = random_scene(N_FULL, seed=0, extent=1.0, scale_range=(0.004, 0.02), device="cuda")
    cams = orbit_cameras(VIEWS, W_FULL, H_FULL, radius=3.0, device="cuda")
    enc = LinearRGBEncoder(D_FULL, device="cuda")
    backproject_views(scene, cams.viewmats[:1], cams.Ks[:1], W_FULL, H_FULL, enc,
                      tile_size=TILE)
    K.LAUNCHES.reset()
    idle_lift, size = traced_idle("lift", lambda: backproject_views(
        scene, cams.viewmats[:IDLE_VIEWS], cams.Ks[:IDLE_VIEWS], W_FULL, H_FULL, enc,
        tile_size=TILE))
    n_lift = K.LAUNCHES.snapshot()
    check(n_lift["render"] == IDLE_VIEWS and n_lift["adjoint"] == IDLE_VIEWS,
          "the traced lift ran B1 and B2 once per view")
    print(f"phase 10 device idle share, lift ({IDLE_VIEWS} views, default engine): "
          f"{idle_lift['idle_share']:.4f} ({idle_lift['busy_ms']:.2f} ms busy of "
          f"{idle_lift['window_ms']:.2f}, {idle_lift['events']} device intervals, trace "
          f"{size / 1e6:.1f} MB)", flush=True)
    print(mem_line("phase 10 lift"), flush=True)
    tr, staged, idx = train_for_idle(scene0)
    tr.train_chunk(staged, 1, idx[:1])
    K.LAUNCHES.reset()
    idle_train, size = traced_idle("train", lambda: tr.train_chunk(staged, IDLE_STEPS, idx[1:]))
    n_train = K.LAUNCHES.snapshot()
    check(n_train["train_fwd"] >= IDLE_STEPS and n_train["train_bwd"] >= IDLE_STEPS,
          "the traced train steps ran B4 and B5")
    print(f"phase 10 device idle share, train step ({IDLE_STEPS} steps at phase 4's shape): "
          f"{idle_train['idle_share']:.4f} ({idle_train['busy_ms']:.2f} ms busy of "
          f"{idle_train['window_ms']:.2f}, {idle_train['events']} device intervals, trace "
          f"{size / 1e6:.1f} MB)", flush=True)
    print(mem_line("phase 10 train"), flush=True)
    del tr, staged

    # 3. the eager lift's stage split, composed of create_feature_field's calls
    sub = cams[:EAGER_VIEWS]
    ref, ref_ms = synced_ms(lambda: create_feature_field(scene, sub, enc, verbose=False))
    torch.cuda.reset_peak_memory_stats()
    timer = StageTimer(device="cuda")
    field = eager_lift_split(scene, sub, enc, timer)
    same = torch.equal(field, ref)
    del field, ref
    totals = {k: 1e3 * v / EAGER_VIEWS for k, v in timer.totals().items()}
    total = sum(totals.values())
    glue = total - sum(totals[k] for k in ("B4", "encode", "B2", "B3"))
    print(f"phase 10 eager lift split ({EAGER_VIEWS} views, tile 16, trans_eps 0, StageTimer "
          f"synchronised at each stage): field bit-equal to create_feature_field's {same}; "
          f"ms/view " + " ".join(f"{k}={v:.2f}" for k, v in totals.items())
          + f"; total {total:.2f} (create_feature_field {ref_ms / EAGER_VIEWS:.2f}), glue "
          f"(all but B4, encode, B2, B3) {glue:.2f}", flush=True)
    check(same, "the composed eager lift equals create_feature_field bit for bit")
    print(mem_line("phase 10 eager split"), flush=True)
    print(f"phase 10 total: {time.perf_counter() - t_phase:.1f} s", flush=True)
    return records


# Phase 11: the interactive apps on phase 7's LSeg-512 field.
PLANTED_CLICK = 256  # Gaussians of one known field row, in front of the scene at view 0
PLANT_DEPTH = 1.6  # their distance from camera 0 along its axis
VIEWER_KEYS = ("w", "d", "1", "2", "3", "drag", "g", "axes")
FRAME_STAGES = ("project", "plan", "sh+pack", "B4", "uint8 to host")
FRAME_SPLIT_ITERS = 5
SESSION_PEAK_GB = 30.0


def plant_cluster(scene, field_cpu, cams):
    """The scene and field with ``PLANTED_CLICK`` opaque red Gaussians at
    ``PLANT_DEPTH`` on camera 0's axis, each with the field row u, the
    negated mean direction of the field's rows (a direction no row
    shares). Returns (scene, field on the card, u on the host, the
    cluster's world centre)."""
    from tpugs_torch.core.scene import GaussianScene
    from tpugs_torch.query.masks import C0

    vm = cams.viewmats[0].double().cpu().numpy()
    centre = vm[:3, :3].T @ (np.array([0.0, 0.0, PLANT_DEPTH]) - vm[:3, 3])
    rng = np.random.default_rng(11)
    k = PLANTED_CLICK
    means = centre + 0.02 * rng.normal(size=(k, 3))
    lit = field_cpu[field_cpu.abs().sum(1) > 0]
    u = -lit.double().mean(0)
    u = (u / u.norm()).float()
    sh_deg = scene.shN.shape[1]
    extra = GaussianScene(
        means=torch.from_numpy(means.astype(np.float32)),
        quats=torch.tensor([[1.0, 0.0, 0.0, 0.0]]).repeat(k, 1),
        log_scales=torch.full((k, 3), float(np.log(0.01))),
        logit_opacities=torch.full((k,), 4.0),
        sh0=((torch.tensor([0.9, 0.1, 0.1]) - 0.5) / C0).repeat(k, 1, 1),
        shN=torch.zeros((k, sh_deg, 3)),
    ).to("cuda")
    planted = GaussianScene(**{f: torch.cat([getattr(scene, f), getattr(extra, f)])
                               for f in ("means", "quats", "log_scales", "logit_opacities",
                                         "sh0", "shN")})
    return planted, torch.cat([field_cpu, u.repeat(k, 1)]).cuda(), u, centre


def viewer_step(v, K0, key):
    """One action of the scripted viewer sequence (a key of ``VIEWER_KEYS``:
    a key press, a mouse drag of (40, -20) px, or the axes overlay), then
    its frame through ``render_frame`` (B4 with early exit)."""
    from tpugs_torch.apps.viewer import render_frame

    if key == "drag":
        v.handle_mouse("down", 600, 400)
        v.handle_mouse("move", 640, 380)
        v.handle_mouse("up", 640, 380)
    elif key != "axes":
        v.handle_key(key)
    return render_frame(v.scene, v.state.viewmat(), K0, v.width, v.height,
                        anaglyph=v.anaglyph, axes_overlay=key == "axes")


def tiled_frame(scene, vm, K0, w, h, anaglyph, axes):
    """The same viewer frame through ``plan_render`` + ``rasterize_with_plan``
    (B4 with no early exit; the reference's "tiled" engine), composed as
    ``render_frame`` composes it."""
    from tpugs_torch.apps.viewer import draw_axes
    from tpugs_torch.raster.api import plan_render, rasterize_with_plan
    from tpugs_torch.viz.common import to_uint8

    Kt = torch.from_numpy(K0).cuda()

    def render(vm):
        vm = torch.from_numpy(vm).cuda()
        with torch.no_grad():
            plan = plan_render(scene.means, scene.quats, scene.scales, scene.opacities,
                               vm, Kt, w, h)
            img, _ = rasterize_with_plan(scene.means, scene.quats, scene.scales,
                                         scene.opacities, scene.colors_all, vm, Kt, plan,
                                         sh_degree=scene.sh_degree)
        return to_uint8(img)

    frame = render(vm)
    if anaglyph:
        right = vm.copy()
        right[0, 3] += 0.05  # render_frame's default eye offset
        r = render(right)
        frame = np.stack([frame[..., 0], r[..., 1], r[..., 2]], axis=-1)
    return draw_axes(frame, vm, K0) if axes else frame


def phase_interactive(field_cpu):
    """The viewer's scripted frames, a click-and-segment session and the
    scene editor on phase 7's LSeg-512 field (``field_cpu``, normalised,
    on the host). Returns the record B4-frame."""
    from tpugs_torch.apps import llm_backend
    from tpugs_torch.apps.click_and_segment import PromptSession, project_point
    from tpugs_torch.apps.viewer import Viewer, render_frame
    from tpugs_torch.apps.viewer_llm import Assistant, SceneEditor, parse_rule_based
    from tpugs_torch.experiments.profile_stages import split
    from tpugs_torch.raster import kernels as K
    from tpugs_torch.raster import train as T
    from tpugs_torch.raster.api import rasterize_with_plan
    from tpugs_torch.raster.colors import prepare_colors
    from tpugs_torch.raster.plan import build_plan
    from tpugs_torch.raster.projection import project
    from tpugs_torch.raster.tiles import image_to_tiles
    from tpugs_torch.utils.synthetic import orbit_cameras, random_scene
    from tpugs_torch.utils.timing import time_cuda
    from tpugs_torch.viz.common import to_uint8

    t_phase = time.perf_counter()
    w, h = W_FULL, H_FULL
    scene = random_scene(N_FULL, seed=0, extent=1.0, scale_range=(0.004, 0.02), device="cuda")
    cams = orbit_cameras(VIEWS, w, h, radius=3.0, device="cuda")
    vm0 = cams.viewmats[0].cpu().numpy()
    K0 = cams.Ks[0].cpu().numpy()

    # 1. the viewer: 8 scripted frames through B4 with early exit, each
    #    within 1 LSB of the same frame through the tiled API, then the same
    #    8 traced
    v = Viewer(scene, K0, w, h, viewmats=cams.viewmats.cpu().numpy())
    render_frame(scene, vm0, K0, w, h, axes_overlay=True)  # warm-up, cv2's import
    torch.cuda.synchronize()
    frame_ms, worst, frames_launches, vms = [], 0, 0, []
    for key in VIEWER_KEYS:
        K.LAUNCHES.reset()
        t0 = time.perf_counter()
        frame = viewer_step(v, K0, key)
        frame_ms.append(1e3 * (time.perf_counter() - t0))
        n = K.LAUNCHES.snapshot()
        want = 2 if v.anaglyph else 1
        check(n["train_fwd"] == want and n["train_fwd_wide"] == 0,
              f"frame '{key}' ran B4 {want} time(s) ({n['train_fwd']})")
        frames_launches += n["train_fwd"]
        vms.append(v.state.viewmat())
        tiled = tiled_frame(v.scene, vms[-1], K0, w, h, v.anaglyph, key == "axes")
        worst = max(worst, int(np.abs(frame.astype(int) - tiled.astype(int)).max()))
    check(worst <= 1, f"every viewer frame within 1 LSB of the tiled API's ({worst})")
    print(f"phase 11 viewer ({w}x{h}, N={N_FULL}, B4 with early exit, tile 16; "
          f"frames after {', '.join(VIEWER_KEYS)}): ms per frame "
          + " ".join(f"{x:.2f}" for x in frame_ms)
          + f" (host clock, the uint8 frame on the host); {len(frame_ms) / sum(frame_ms) * 1e3:.2f}"
          f" frames/s; B4 launched {frames_launches} times (1 per frame, 2 per anaglyph frame); "
          f"against the tiled API (plan_render + rasterize_with_plan) max {worst} LSB",
          flush=True)
    v2 = Viewer(scene, K0, w, h, viewmats=cams.viewmats.cpu().numpy())
    idle_view, size = traced_idle("viewer", lambda: [viewer_step(v2, K0, k)
                                                      for k in VIEWER_KEYS])
    print(f"phase 11 device idle share, viewer ({len(VIEWER_KEYS)} frames, taken for phase 10): "
          f"{idle_view['idle_share']:.4f} ({idle_view['busy_ms']:.2f} ms busy of "
          f"{idle_view['window_ms']:.2f}, {idle_view['events']} device intervals, trace "
          f"{size / 1e6:.1f} MB)", flush=True)
    del v2

    # the first frame (after "w") stage by stage: render_scene's own calls
    # and the uint8 frame to the host, CUDA events at each stage's end
    vm, Kt, last = torch.from_numpy(vms[0]).cuda(), cams.Ks[0], {}

    def frame_stages(mark):
        with torch.no_grad():
            proj = project(scene.means, scene.quats, scene.scales, scene.opacities, vm, Kt, w, h)
            mark("project")
            plan = build_plan(proj, w, h, 16)
            mark("plan")
            opac = torch.where(proj.valid, proj.opacities, torch.zeros_like(proj.opacities))
            cols = prepare_colors(scene.means, scene.colors_all, vm, scene.sh_degree)
            geom, colp = T.pack_train(proj.means2d, proj.conics, opac, cols, plan)
            mark("sh+pack")
            image, _, done = T.train_forward(geom, colp, plan, K.TRANS_EPS)
            mark("B4")
            last.update(frame=to_uint8(image), plan=plan, geom=geom, colp=colp, image=image,
                        done=done)
            mark("uint8 to host")

    split_ms = split(frame_stages, FRAME_STAGES, FRAME_SPLIT_ITERS, torch.device("cuda"))
    same_frame = np.array_equal(last["frame"], render_frame(scene, vms[0], K0, w, h))
    print(f"phase 11 viewer frame split (the first frame, after 'w'; CUDA events at each "
          f"stage's end, mean of {FRAME_SPLIT_ITERS}): "
          + " ".join(f"{k}={v:.2f}" for k, v in split_ms.items())
          + f" ms; total {sum(split_ms.values()):.2f} ms; the composed frame bit-equal to "
          f"render_frame's {same_frame}", flush=True)
    check(same_frame, "the viewer frame composed of render_scene's calls equals render_frame's")

    # B4-frame: the first frame's B4 against its twin, its time, its bound
    plan, geom, colp, image, done = (last[k] for k in ("plan", "geom", "colp", "image", "done"))
    del last
    gen = torch.Generator(device="cuda").manual_seed(11)
    tiles = torch.randperm(plan.n_tiles, device="cuda", generator=gen)[:64]
    inside = tile_inside(h, w, 16, tiles)
    img_t, alpha_t, done_t = T.train_tiles_plain(geom, colp, plan, K.TRANS_EPS, tiles)
    b4 = rel_err(torch.where(inside, image_to_tiles(image, 16)[tiles], 0.0),
                 torch.where(inside, img_t, 0.0))
    check(b4[1] <= 1e-4 and torch.equal(done[tiles], done_t),
          "B4 (viewer frame) within 1e-4 of its twin, exit blocks equal")
    b4_ms = time_cuda(lambda: T.train_forward(geom, colp, plan, K.TRANS_EPS), 10)
    b4_plain = time_cuda(lambda: T.train_forward_plain(geom, colp, plan, K.TRANS_EPS), 1)
    pairs, weighted, _ = walked_pairs(geom, plan, K.TRANS_EPS)
    b4_bound = bound(int(done.sum()) * 128 * (8 + 3) * 4 + h * w * 4 * 4,
                     pairs * PAIR_OPS + weighted * 2 * 3, PEAK_F32_FLOPS)
    print(f"phase 11 B4-frame (D=3, tile 16, early exit) on the first frame: 64 tiles against "
          f"the twin, image rel {b4[1]:.3e}; {b4_ms:.4f} ms (twin {b4_plain:.1f}); {pairs} "
          f"pairs walked, {weighted} with a nonzero weight; bound {b4_bound[0]:.4f} ms by "
          f"{b4_bound[1]}, share {b4_bound[0] / b4_ms:.3f}", flush=True)
    records = [rec("B4-frame", "train_fwd (viewer frame)", "tpugs_torch/csrc/train_fwd.cu",
                   "tpugs/raster/pallas_train.py:250", frames_launches, b4, b4_ms, b4_plain,
                   b4_bound)]
    del geom, colp, image, done, img_t, alpha_t, plan, v

    # 2. the click session on the planted scene and field
    pscene, pfield, u, centre = plant_cluster(scene, field_cpu, cams)
    del scene
    n = pscene.num_gaussians
    planted = torch.arange(N_FULL, n, device="cuda")
    lit = field_cpu[field_cpu.abs().sum(1) > 0]
    u_max = float((lit @ u).max())
    check(u_max < 0, f"no scene row shares the planted direction (max cosine {u_max:.3f})")
    foot_alpha = T.render_scene(pscene.select(planted), torch.from_numpy(vm0).cuda(),
                                cams.Ks[0], w, h)[1]
    full_alpha = T.render_scene(pscene, torch.from_numpy(vm0).cuda(), cams.Ks[0], w, h)[1]
    cx, cy = project_point(centre, vm0, K0)
    # the negative click: the most opaque pixel of a coarse grid outside the
    # cluster's footprint (the scene's own features there)
    grid = torch.where(foot_alpha == 0, full_alpha, -1.0)[::37, ::37]
    at = int(torch.argmax(grid))
    bx, by = at % grid.shape[1] * 37, at // grid.shape[1] * 37
    check(float(full_alpha[by, bx]) > 0.5, "the negative click shows the scene")
    torch.cuda.reset_peak_memory_stats()
    session = PromptSession(pscene, pfield)
    K.LAUNCHES.reset()
    (rgbd, feat_img), rf_ms = synced_ms(lambda: session.render_rgbd_features(vm0, K0, w, h))
    n_rf = K.LAUNCHES.snapshot()
    check(n_rf["train_fwd"] == 2 and n_rf["train_fwd_wide"] == 0,
          "the RGB+ED render and, in channel slices, the 512-wide field ran B4's cluster "
          "kernel")
    s = session.scene
    with torch.no_grad():
        (vm_t, K_t, plan_s), plan_ms = synced_ms(lambda: session._plan(s, vm0, K0, w, h))
        _, rgbd_ms = synced_ms(lambda: rasterize_with_plan(
            s.means, s.quats, s.scales, s.opacities, s.colors_all, vm_t, K_t, plan_s,
            sh_degree=s.sh_degree, render_mode="RGB+ED"))
        _, feat_ms = synced_ms(lambda: rasterize_with_plan(
            s.means, s.quats, s.scales, s.opacities, session.features, vm_t, K_t, plan_s))
    check(rgbd.device.type == "cuda" and feat_img.device.type == "cuda",
          "the session's renders stay on the card")
    (_, add_ms) = synced_ms(lambda: session.add_click(cx, cy, rgbd, feat_img, vm0, K0, True))
    session.add_click(bx, by, rgbd, feat_img, vm0, K0, False)
    mask, mask_ms = synced_ms(session.mask3d)
    queries = torch.from_numpy(np.stack([p.feature for p in session.prompts]))
    m64, margin = mask_f64(pfield.cpu(), queries, 1)
    clear = margin > TIE_MARGIN
    m = mask.cpu().numpy()
    mask_equal = bool(np.array_equal(m[clear], m64[clear]))
    all_planted = bool(mask[planted].all())
    pane, pane_ms = synced_ms(lambda: session.three_pane(vm0, K0, w, h))
    extracted = pane[:, w:2 * w]
    outside = (foot_alpha == 0).cpu().numpy()
    clean = bool((extracted[outside] == 0).all())
    inside_lit = int((extracted[~outside].max(-1) > 0).sum())
    peak = torch.cuda.max_memory_allocated() / 1e9
    removed = session.remove_nearest(bx + 3, by - 2, vm0, K0)
    kept = [p.positive for p in session.prompts]
    print(f"phase 11 click session (N={n} with {PLANTED_CLICK} planted at depth "
          f"{PLANT_DEPTH} on view 0's axis, field D={pfield.shape[1]}; positive click "
          f"({cx}, {cy}), negative ({bx}, {by})): mask {int(mask.sum())} selected, all "
          f"{PLANTED_CLICK} planted {all_planted}; equal to float64 on the host {mask_equal} "
          f"outside {int((~clear).sum())} Gaussians within {TIE_MARGIN} of a tie; extracted "
          f"pane background outside the cluster's footprint {clean} ({inside_lit} pixels lit "
          f"inside); remove_nearest removed prompt {removed}, left {kept}; ms per click "
          f"(host clock, synchronised): render_rgbd_features {rf_ms:.2f} (plan {plan_ms:.2f}, "
          f"RGB+ED {rgbd_ms:.2f}, the {pfield.shape[1]}-wide field {feat_ms:.2f}), add_click "
          f"{add_ms:.2f}, mask3d {mask_ms:.2f}, three_pane {pane_ms:.2f}; peak {peak:.2f} GB",
          flush=True)
    check(all_planted and mask_equal, "the planted Gaussians selected; mask equal to float64")
    check(clean and inside_lit > 0, "the extracted pane shows only the planted cluster")
    check(removed == 1 and kept == [True], "remove_nearest removed the negative prompt")
    check(peak < SESSION_PEAK_GB, f"the session's peak below {SESSION_PEAK_GB} GB")
    del rgbd, feat_img, session, pane, extracted

    # 3. the scene editor: three phrases, then each command on the planted object
    phrases = {"segment the planted object": "segment",
               "make the planted object blue": "change_color",
               "undo the segmentation": "reset_segmentation"}
    parsed = {p: parse_rule_based(p) for p in phrases}
    check(all(parsed[p]["command"] == c for p, c in phrases.items()),
          f"parse_rule_based on the phrases ({parsed})")
    editor = SceneEditor(pscene, pfield, exemplar_lookup=lambda name: u.numpy())
    orig = {f: getattr(pscene, f).clone() for f in ("logit_opacities", "sh0", "shN")}
    steps = [parsed["segment the planted object"], parsed["make the planted object blue"],
             {"command": "reset_color"}, {"command": "reset_segmentation"},
             {"command": "exit"}]
    results, ms = [], []
    for cmd in steps:
        out, t = synced_ms(lambda cmd=cmd: editor.apply(cmd))
        results.append(out)
        ms.append(t)
        if cmd["command"] == "reset_color":
            check(torch.equal(editor.scene.sh0, orig["sh0"])
                  and torch.equal(editor.scene.shN, orig["shN"]), "reset_color restores SH")
        if cmd["command"] == "reset_segmentation":
            check(torch.equal(editor.scene.logit_opacities, orig["logit_opacities"]),
                  "reset_segmentation restores the opacities")
    check(results[0] == {"status": "ok", "selected": PLANTED_CLICK}
          and results[1] == {"status": "ok", "recolored": PLANTED_CLICK}
          and results[-1] == {"status": "exit"}, f"the editor's answers ({results})")
    print(f"phase 11 scene editor: parse_rule_based {list(parsed.values())}; apply "
          + "; ".join(f"{c['command']} -> {r} ({t:.2f} ms)" for c, r, t in zip(steps, results, ms)),
          flush=True)
    try:
        import transformers  # noqa: F401
    except ImportError as e:
        print(f"phase 11 LLM backend: transformers does not import here ({e}); the grammar "
              f"parser serves alone", flush=True)
    else:
        llm = llm_backend.make_backend("tiny-random")
        answer = Assistant(llm=llm).ask("show me the top view")
        check(answer == {"command": "change_view", "view": "top"},
              f"the tiny random GPT-2 answers through the grammar fallback ({answer})")
        print(f"phase 11 LLM backend: tiny-random GPT-2 on the card -> {answer}", flush=True)
    print(f"phase 11 total: {time.perf_counter() - t_phase:.1f} s", flush=True)
    return records


# Phase 12: the distribution on one card. NCCL refuses two ranks on one GPU,
# so the sharded programs run on a group of one rank (file:// store): each
# collective is then a copy, and the sharded results must equal the
# unsharded ones; the times say what sharding costs on one card, nothing of
# traffic between cards.
DIST_STEPS = 10  # timed steps of the sharded chunk
DIST_STAGED = 2  # staged cameras (with their 512-d teachers) for the chunk
LEAF_TOL, HEAD_TOL = 2e-5, 1e-7  # tests/test_dist.py: of each leaf's max; feature_proj absolute


def phase_dist(ref3, ref4, scene0):
    """The sharded lift at phase 3's shape (``num``/``den`` bit-equal to
    phase 3's), the sharded train step at phase 4's shape against
    ``Trainer._step_on``, the chunk's ms/step, the exchange cap, one
    ``refine_sharded`` against ``Trainer.refine``, the dry run and
    ``experiments/sharded_singlechip.py``, on a world-size-1 NCCL group."""
    import dataclasses

    import torch.distributed as dist

    from tpugs_torch.dist.dryrun import dryrun_ranks
    from tpugs_torch.dist.mesh import make_mesh, single_rank_group
    from tpugs_torch.dist.shard import (
        backproject_views_sharded,
        make_trainer_chunk_sharded,
        make_trainer_step_sharded,
        refine_sharded,
        shard_trainer,
    )
    from tpugs_torch.encoders import get_encoder
    from tpugs_torch.encoders.base import LinearRGBEncoder
    from tpugs_torch.experiments import sharded_singlechip
    from tpugs_torch.raster import kernels as K
    from tpugs_torch.raster.projection import project
    from tpugs_torch.train.config import TrainConfig
    from tpugs_torch.train.strategy import GradState
    from tpugs_torch.train.trainer import Trainer, _leaves
    from tpugs_torch.utils.synthetic import orbit_cameras, random_scene

    t_phase = time.perf_counter()
    print(f"phase 12 NCCL {torch.cuda.nccl.version()}", flush=True)
    with single_rank_group("cuda"):
        check(dist.get_backend() == "nccl" and dist.get_world_size() == 1,
              "phase 12 runs on a world-size-1 NCCL group")
        mesh = make_mesh((1, 1), device="cuda")
        try:
            make_mesh((1, 1), device="cpu")
            refused = False
        except RuntimeError:
            refused = True
        check(refused, "a CPU mesh over the NCCL group is refused")

        # the sharded lift at phase 3's shape
        scene = random_scene(N_FULL, seed=0, extent=1.0, scale_range=(0.004, 0.02),
                             device="cuda")
        cams = orbit_cameras(VIEWS, W_FULL, H_FULL, radius=3.0, device="cuda")
        enc = LinearRGBEncoder(D_FULL, device="cuda")
        ones = torch.ones(VIEWS, device="cuda")
        backproject_views_sharded(scene, cams.viewmats[:1], cams.Ks[:1], ones[:1], W_FULL,
                                  H_FULL, enc, mesh, tile_size=TILE)  # warm-up view
        torch.cuda.synchronize()
        num, den, ms_view, launches, peak_gb, stage_ms, _ = timed_lift(
            (scene, cams.viewmats, cams.Ks, ones, W_FULL, H_FULL, enc, mesh), "pallas",
            backproject_views_sharded, extra_stages=("collectives",))
        same = torch.equal(num.cpu(), ref3["num"]) and torch.equal(den.cpu(), ref3["den"])
        for name in ("render", "adjoint", "reduce"):
            check(launches[name] >= VIEWS,
                  f"{name} kernel launched at least once per view ({launches[name]})")
        stages = " ".join(f"{k}={v:.2f}" for k, v in stage_ms.items() if k != "collectives")
        print(f"phase 12 sharded lift (1, 1) N={N_FULL} {W_FULL}x{H_FULL} D={D_FULL} "
              f"tile={TILE} views={VIEWS}: {ms_view:.2f} ms/view (phase 3 "
              f"{ref3['ms_view']:.2f}), {1e3 / ms_view:.3f} views/s, peak {peak_gb:.2f} GB "
              f"(phase 3 {ref3['peak_gb']:.2f}); the collectives (cat + all_reduce over cam "
              f"+ reduce_scatter over gauss, CUDA events) {VIEWS * stage_ms['collectives']:.3f} "
              f"ms per call; stage ms/view {stages}; launches {launches}; num and den "
              f"bit-equal to phase 3's: {same}", flush=True)
        check(same, "the sharded lift's num and den equal phase 3's bit for bit")
        del num, den, scene, enc

        # the sharded train step at phase 4's shape, batch 1, the trainer's Adam
        w, h = W_FULL, H_FULL
        cfg = TrainConfig(max_steps=30_000, sh_degree=3, feature_dim=128, feature_out_dim=512,
                          strategy="none", random_bkgd=False, sh_degree_interval=1)
        teacher = get_encoder("linear:512")
        cams = orbit_cameras(TRAIN_CAMS, w, h, radius=3.0, device="cuda")
        rng = np.random.default_rng(12)
        images = torch.from_numpy(
            rng.uniform(0, 1, (DIST_STAGED, h, w, 3)).astype(np.float32)).cuda()

        def trainer(c=cfg):
            return Trainer(c, scene0, 1.0, teacher=teacher, width=w, height=h,
                           n_cameras=TRAIN_CAMS)

        ref = trainer()
        feats = torch.stack([teacher(im).to(ref.teacher_dtype) for im in images])
        zero_bg, ids = torch.zeros((DIST_STAGED, 3), device="cuda"), torch.arange(DIST_STAGED,
                                                                                  device="cuda")
        one = (cams.viewmats[:1], cams.Ks[:1], images[:1], feats[:1], zero_bg[:1], ids[:1])
        loss_ref = ref._step_on(cams.viewmats[0], cams.Ks[0], images[0], feats[0], None, None,
                                zero_bg[0], cfg.sh_degree, 0)["loss"]
        s0 = scene0.to("cuda")
        valid = project(s0.means, s0.quats, s0.scales, s0.opacities, cams.viewmats[0],
                        cams.Ks[0], w, h, ref.proj_config).valid
        survivors = int(valid.sum())
        del s0

        def sharded_step(rows=0, c=cfg):
            tr = trainer(c)
            shard_trainer(tr, mesh)
            out = make_trainer_step_sharded(tr, mesh, 1, rows)(
                tr.scene, tr.optimizer, tr.module_state(), *one)
            return tr, out

        tr, (_, _, _, loss, grad2d, vis, xover) = sharded_step()
        rel = abs(float(loss) - float(loss_ref)) / abs(float(loss_ref))
        errs, equal = {}, []
        for f in dataclasses.fields(tr.scene):
            a, b = getattr(tr.scene, f.name).detach(), getattr(ref.scene, f.name).detach()
            errs[f.name] = float((a - b).abs().max()) / (
                1.0 if f.name == "feature_proj" else float(b.abs().max()))
            if torch.equal(a, b):
                equal.append(f.name)
        print(f"phase 12 sharded step (1, 1) N={N_FULL} {w}x{h} D=131 batch 1, Adam: loss "
              f"{float(loss):.7f} against _step_on's {float(loss_ref):.7f} (rel {rel:.2e}); "
              f"leaves' max error of their max (feature_proj absolute) "
              f"{ {k: f'{v:.2e}' for k, v in errs.items()} }; bit-equal: {equal}; vis equal "
              f"to the view's valid rows: {torch.equal(vis, valid.float())}; xover "
              f"{float(xover)}", flush=True)
        check(rel <= 1e-6, "the sharded step's loss within 1e-6 of _step_on's")
        check(all(v <= (HEAD_TOL if k == "feature_proj" else LEAF_TOL) for k, v in errs.items()),
              "each leaf within tpugs' test_dist tolerances of _step_on's")
        check(torch.equal(vis, valid.float()) and float(xover) == 0, "vis equal, no xover")
        first = {"loss": loss, "grad2d": grad2d.clone(),
                 "leaves": {f.name: getattr(tr.scene, f.name).detach().clone()
                            for f in dataclasses.fields(tr.scene)}}
        del ref

        # 10 timed steps through the chunk, on its staged cameras
        staged = {"images": images, "viewmats": cams.viewmats[:DIST_STAGED],
                  "Ks": cams.Ks[:DIST_STAGED], "teachers": feats, "image_ids": ids}
        sel = (np.arange(DIST_STEPS) % DIST_STAGED)[:, None]
        chunk = make_trainer_chunk_sharded(tr, mesh, 1, DIST_STEPS)
        torch.cuda.reset_peak_memory_stats()
        K.LAUNCHES.reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        stats = chunk(tr.scene, tr.optimizer, tr.module_state(), staged, sel)[3]
        torch.cuda.synchronize()
        ms_step = 1e3 * (time.perf_counter() - t0) / DIST_STEPS
        launches = K.LAUNCHES.snapshot()
        peak = torch.cuda.max_memory_allocated() / 1e9
        for name in ("train_fwd", "train_bwd", "reduce"):
            check(launches[name] >= DIST_STEPS,
                  f"{name} kernel launched at least once per sharded step ({launches[name]})")
        check(bool(torch.isfinite(stats["loss"]).all()), "the chunk's losses finite")
        print(f"phase 12 sharded chunk (1, 1): {DIST_STEPS} steps {ms_step:.2f} ms/step (phase 4 "
              f"{ref4['ms_step']:.2f}, which also runs the teacher each step; the chunk reads "
              f"staged teachers), peak {peak:.2f} GB (phase 4 {ref4['peak_gb']:.2f}); losses "
              f"{' '.join(f'{x:.4f}' for x in stats['loss'].tolist())}; launches {launches}",
              flush=True)
        del tr, chunk, staged

        # the exchange cap: at view 0's survivors lossless, at half of them xover exact
        tr, (_, _, _, loss_c, g2d_c, _, xover_c) = sharded_step(survivors)
        capped_equal = (torch.equal(loss_c, first["loss"]) and torch.equal(g2d_c, first["grad2d"])
                        and all(torch.equal(getattr(tr.scene, k).detach(), v)
                                for k, v in first["leaves"].items()))
        del tr
        half = survivors // 2
        tr, (_, _, _, _, _, _, xover_h) = sharded_step(half)
        del tr
        print(f"phase 12 exchange cap: view 0 has {survivors} survivors of {N_FULL}; capped at "
              f"{survivors}: xover {float(xover_c)}, bit-equal to the uncapped step "
              f"{capped_equal}; capped at {half}: xover {float(xover_h)} (expected "
              f"{survivors - half})", flush=True)
        check(capped_equal and float(xover_c) == 0,
              "the step capped at the survivors equals the uncapped step bit for bit")
        check(float(xover_h) == survivors - half, "xover = survivors - cap, exactly")

        # one refine_sharded against Trainer.refine on the same state (phase 9's
        # strategy and capacity, cut to one step of phase 4's set-up)
        cfg_r = dataclasses.replace(cfg, strategy="default", capacity_multiple=LOOP_CAPACITY)
        ref = trainer(cfg_r)
        ref._step_on(cams.viewmats[0], cams.Ks[0], images[0], feats[0], None, None, zero_bg[0],
                     cfg.sh_degree, 0)
        tr = trainer(cfg_r)
        tr.scene = _leaves(ref._detached(), tr.device)
        shard_trainer(tr, mesh)
        tr.grad_state = GradState(ref.grad_state.grad2d_sum.clone(), ref.grad_state.count.clone())
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        info_ref = ref.refine()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        info = refine_sharded(tr, mesh)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        same_leaves = all(torch.equal(getattr(tr.scene, f.name).detach(),
                                      getattr(ref.scene, f.name).detach())
                          for f in dataclasses.fields(tr.scene))
        print(f"phase 12 refine_sharded (1, 1) after one step of phase 4's set-up with "
              f"strategy 'default', capacity {LOOP_CAPACITY}: N {N_FULL} -> "
              f"{tr.scene.num_gaussians} (Trainer.refine {ref.scene.num_gaussians}); info "
              f"{info} (Trainer.refine {info_ref}); leaves bit-equal {same_leaves}; "
              f"{1e3 * (t2 - t1):.1f} ms (Trainer.refine {1e3 * (t1 - t0):.1f} ms)", flush=True)
        check(info == info_ref and tr.scene.num_gaussians == ref.scene.num_gaussians
              and same_leaves, "refine_sharded equals Trainer.refine")
        del tr, ref, images, feats

        # the dry run and the single-device tool
        t0 = time.perf_counter()
        dry = dryrun_ranks("cuda")
        print(f"phase 12 dry run (1, 1) on the card: {dry} ({time.perf_counter() - t0:.1f} s)",
              flush=True)
        tool = sharded_singlechip.main([])
        check(tool["backproject"]["bit_equal"] and tool["train"]["ok"],
              "experiments/sharded_singlechip.py: parity")
    check(not dist.is_initialized(), "the phase's group destroyed")
    torch.cuda.empty_cache()
    print(f"phase 12 total: {time.perf_counter() - t_phase:.1f} s", flush=True)


# Phase 13: the garden-shaped dataset written to disk by the port's tool,
# then trained from disk through the train app at tpugs' refine cadence.
ATSCALE = dict(n_gaussians=2**19, n_cams=185, width=1296, height=840, n_sfm_points=100_000,
               radius=2.5, seed=0)  # garden's 185 images; tpugs' init_num_pts
ATSCALE_STEPS = 1100  # refines every 100 steps from step 500 (TrainConfig's defaults)
JPEG_MIN_PSNR = 40.0  # dB: each decoded JPEG (quality 75) against its rendered frame
JPEG_CONTROL_QUALITY = 30  # a writer at this quality must fall below JPEG_MIN_PSNR
REFINE_CHECK_VIEWS = 8  # train views in which no padded row may be valid after a refine


def psnr(a, b) -> float:
    """PSNR in dB of two uint8 images."""
    mse = float(np.mean((a.astype(np.float64) - b) ** 2))
    return 10 * np.log10(255.0**2 / max(mse, 1e-12))


def check_jpegs(data_dir, frames):
    """Each JPEG ``make_atscale_dataset`` wrote, decoded by ``read_image``, against its
    rendered frame: PSNR at least ``JPEG_MIN_PSNR``, and nearer than the
    frame with R and B swapped (the channel order); the worst frame encoded
    at ``JPEG_CONTROL_QUALITY`` falls below the limit (the control).
    Returns the worst image's (PSNR, index, mean abs, max abs, mean abs to
    the swapped frame), the control's PSNR and the seconds of the decodes."""
    import cv2

    from tpugs_torch.io.images import read_image

    worst, t0 = None, time.perf_counter()
    for i, frame in enumerate(frames):
        dec = read_image(os.path.join(data_dir, "images", f"frame_{i:04d}.jpg"))
        check(dec.shape == frame.shape and dec.dtype == np.uint8, f"frame {i} decodes")
        err = np.abs(dec.astype(np.int16) - frame)
        psnr_db = psnr(dec, frame)
        swapped = float(np.abs(dec.astype(np.int16) - frame[..., ::-1]).mean())
        item = (psnr_db, i, float(err.mean()), int(err.max()), swapped)
        worst = item if worst is None or item < worst else worst
        check(psnr_db >= JPEG_MIN_PSNR, f"frame {i}: the JPEG within {JPEG_MIN_PSNR} dB "
              f"({psnr_db:.2f})")
        check(err.mean() < swapped, f"frame {i}: R and B in their order ({err.mean():.2f} "
              f"against {swapped:.2f} with them swapped)")
    decode_s = time.perf_counter() - t0
    frame = frames[worst[1]]
    ok, buf = cv2.imencode(".jpg", np.ascontiguousarray(frame[..., ::-1]),
                           [cv2.IMWRITE_JPEG_QUALITY, JPEG_CONTROL_QUALITY])
    check(ok, "the control frame encodes")
    control = psnr(read_image(buf.tobytes()), frame)
    check(control < JPEG_MIN_PSNR, f"frame {worst[1]} at quality {JPEG_CONTROL_QUALITY} "
          f"falls below {JPEG_MIN_PSNR} dB ({control:.2f})")
    return worst, control, decode_s


def phase_atscale():
    """The garden-shaped dataset (``apps/make_atscale_dataset.main`` at
    ``ATSCALE``, each piece timed, the JPEGs held against the frames) in a
    temporary directory, then ``apps/train.main`` on it: chunked,
    ``ATSCALE_STEPS`` steps, main's other defaults (features 128 against
    ``linear:512``, SH 3, strategy "default" at capacity 16384, SfM init,
    test_every 8). The trainer's methods are wrapped on the class, so the
    run stays main's own: the SfM init's count, each chunk's ms/step and N,
    each refine checked as phase 9's (the first replayed on the CPU), the
    first step after the last refine of the loop recorded and B4, B5 and B3
    held and timed on it (B4-, B5-, B3-atscale), the final eval, the
    checkpoints, the staging and the image reads timed. Returns the three
    kernel records."""
    import tempfile
    from unittest import mock

    from tpugs_torch.apps import make_atscale_dataset
    from tpugs_torch.apps import train as train_app
    from tpugs_torch.io.images import read_image
    from tpugs_torch.raster import kernels as K
    from tpugs_torch.train.config import TrainConfig
    from tpugs_torch.train.dataset import Parser
    from tpugs_torch.train.trainer import Trainer

    t_phase = time.perf_counter()
    w, h, steps = ATSCALE["width"], ATSCALE["height"], ATSCALE_STEPS
    cfg = TrainConfig()
    refine_steps = [s for s in range(cfg.refine_start_iter, steps + 1, cfg.refine_every)
                    if s < cfg.refine_stop_iter]
    last_in_loop = max(s for s in refine_steps if s < steps)
    with tempfile.TemporaryDirectory() as tmp:
        data, out_dir = os.path.join(tmp, "data"), os.path.join(tmp, "result")
        built, build_ms = synced_ms(lambda: make_atscale_dataset.main(data, device="cuda",
                                                                      **ATSCALE))
        worst, control, decode_s = check_jpegs(data, built["frames"])
        del built["frames"]
        planted = np.zeros((64, 64, 3), np.uint8)
        planted[..., 0] = 220
        planted[:, 32:, 2] = 200
        path = os.path.join(tmp, "planted.jpg")
        make_atscale_dataset.write_jpeg(path, planted)
        back = read_image(path).astype(np.float64)
        check(abs(back[:, :24, 0].mean() - 220) < 3 and back[:, :24, 2].mean() < 3
              and abs(back[:, 40:, 2].mean() - 200) < 3,
              "a planted red and blue image keeps its channels through write_jpeg, read_image")
        jpeg_mb = sum(os.path.getsize(os.path.join(data, "images", f))
                      for f in os.listdir(os.path.join(data, "images"))) / 1e6
        print(f"phase 13 dataset ({ATSCALE}): {build_ms / 1e3:.2f} s: " + ", ".join(
            f"{k} {v:.3f}" for k, v in built["seconds"].items()) + f" s; {jpeg_mb:.1f} MB of "
            f"JPEGs, ckpt.pt {os.path.getsize(os.path.join(data, 'ckpt.pt')) / 1e6:.1f} MB; "
            f"decoded ({decode_s:.2f} s) against the rendered frames: worst PSNR "
            f"{worst[0]:.2f} dB (frame {worst[1]}, mean abs {worst[2]:.3f}, max abs "
            f"{worst[3]}; {worst[4]:.2f} mean abs with R and B swapped), bound >= "
            f"{JPEG_MIN_PSNR} dB; the same frame at quality {JPEG_CONTROL_QUALITY} "
            f"{control:.2f} dB; a planted red and blue image kept its channels", flush=True)

        box = {"init_n": None, "parse_s": 0.0, "load_s": 0.0, "loads": 0, "stage_ms": 0.0,
               "views": [], "traj_error": None, "reset_steps": []}
        chunks, losses, refines, records, evals, saves = [], [], [], [], [], []
        held = {"check_ms": 0.0, "armed": False, "peak": 0}
        orig_t = {k: getattr(Trainer, k) for k in (
            "__init__", "refine", "reset_opacities", "_step_on", "train_chunk",
            "stage_dataset", "evaluate", "save_checkpoint", "save_checkpoint_full",
            "render_traj")}
        orig_p = {k: getattr(Parser, k) for k in ("__post_init__", "load_image")}

        def init(self, *a, **kw):
            orig_t["__init__"](self, *a, **kw)
            box["tr"] = self
            box["init_n"] = self.scene.num_gaussians
            self.strategy.rng = box["rng"] = TimedRng(self.strategy.rng)

        def post_init(self):
            t0 = time.perf_counter()
            orig_p["__post_init__"](self)
            box["parse_s"] += time.perf_counter() - t0

        def load_image(self, idx):
            t0 = time.perf_counter()
            out = orig_p["load_image"](self, idx)
            box["load_s"] += time.perf_counter() - t0
            box["loads"] += 1
            return out

        def stage_dataset(self, dataset):
            out, box["stage_ms"] = synced_ms(lambda: orig_t["stage_dataset"](self, dataset))
            pick = np.linspace(0, len(dataset) - 1, REFINE_CHECK_VIEWS).astype(int)
            box["views"] = [(out["viewmats"][c], out["Ks"][c]) for c in pick]
            return out

        def refine(self):
            info, r = refine_checked(self, lambda: orig_t["refine"](self), box["rng"],
                                     box["views"], w, h, self.cfg.capacity_multiple,
                                     replay_cpu=not refines)
            refines.append(r)
            held["armed"] = self.step == last_in_loop
            return info

        def reset_opacities(self):
            box["reset_steps"].append(self.step)
            return orig_t["reset_opacities"](self)

        def step_on(self, *args, **kw):
            if not held["armed"]:
                return orig_t["_step_on"](self, *args, **kw)
            held["armed"] = False
            self.record = seen = {}
            out = orig_t["_step_on"](self, *args, **kw)
            self.record = None
            torch.cuda.synchronize()
            held["peak"] = max(held["peak"], torch.cuda.max_memory_allocated())
            saved = K.LAUNCHES.snapshot()
            t = time.perf_counter()
            records.extend(train_step_records(
                seen, w, h, saved, f"phase 13 at step {self.step}, after the refine at "
                f"{last_in_loop}", ("B4-atscale", "B5-atscale", "B3-atscale")))
            del seen
            torch.cuda.synchronize()
            held["check_ms"] += 1e3 * (time.perf_counter() - t)
            for k, v in saved.items():
                setattr(K.LAUNCHES, k, v)
            torch.cuda.reset_peak_memory_stats()
            return out

        def train_chunk(self, staged, n_steps, cam_idx=None):
            step0, before = self.step, held["check_ms"]
            out, ms = synced_ms(lambda: orig_t["train_chunk"](self, staged, n_steps, cam_idx))
            chunks.append((step0, self.step, self.scene.num_gaussians,
                           (ms - (held["check_ms"] - before)) / n_steps))
            losses.append(out["loss"])
            return out

        def evaluate(self, dataset, max_images=None):
            out, ms = synced_ms(lambda: orig_t["evaluate"](self, dataset, max_images))
            evals.append((len(dataset), ms, out))
            return out

        def saver(name):
            def save(self, path):
                _, ms = synced_ms(lambda: orig_t[name](self, path))
                saves.append((name, ms, os.path.getsize(path)))
            return save

        def render_traj(self, Ks, output_path, n_frames=60):
            try:
                return orig_t["render_traj"](self, Ks, output_path, n_frames)
            except Exception as e:
                box["traj_error"] = f"{type(e).__name__}: {e}"
                raise

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        K.LAUNCHES.reset()
        with mock.patch.multiple(
                Trainer, __init__=init, refine=refine, reset_opacities=reset_opacities,
                _step_on=step_on, train_chunk=train_chunk, stage_dataset=stage_dataset,
                evaluate=evaluate, save_checkpoint=saver("save_checkpoint"),
                save_checkpoint_full=saver("save_checkpoint_full"), render_traj=render_traj), \
                mock.patch.multiple(Parser, __post_init__=post_init, load_image=load_image):
            tr, wall_ms = synced_ms(lambda: train_app.main(
                data, out_dir, data_factor=1, max_steps=steps, chunked=True, save_every=0))
        launches = K.LAUNCHES.snapshot()
        peak_gb = max(held["peak"], torch.cuda.max_memory_allocated()) / 1e9
        gif = os.path.join(out_dir, "traj.gif")
        check(box["traj_error"] is None and os.path.exists(gif),
              f"main's render_traj wrote traj.gif ({box['traj_error']})")
        traj_frames, traj_ms, traj_loop = read_gif_cv2(gif)
        traj_mb = os.path.getsize(gif) / 1e6
        check(len(traj_frames) == 30 and traj_ms == [100] * 30 and traj_loop == 0
              and all(f.shape == (h, w, 3) for f in traj_frames)
              and sum(int(f.any()) for f in traj_frames) == 30,
              f"traj.gif: 30 frames of {w}x{h}, none black, 100 ms each, endless loop")

    n_train = sum(1 for i in range(ATSCALE["n_cams"]) if i % cfg.test_every)
    check(tr is box["tr"] and box["init_n"] == ATSCALE["n_sfm_points"],
          f"the SfM init has {ATSCALE['n_sfm_points']} Gaussians ({box['init_n']})")
    check([r["step"] for r in refines] == refine_steps and not box["reset_steps"],
          f"refines at {refine_steps} and no opacity reset ({[r['step'] for r in refines]}, "
          f"{box['reset_steps']})")
    check(len(records) == 3, f"the step after the refine at {last_in_loop} was recorded")
    loss = np.concatenate(losses)
    check(len(loss) == steps and bool(np.isfinite(loss).all()), "every loss finite")
    check(float(losses[-1].mean()) < float(losses[0].mean()),
          "the last chunk's mean loss below the first chunk's")
    for k in ("train_fwd", "train_bwd", "reduce"):
        check(launches[k] >= steps, f"{k} launched every step ({launches[k]})")
    for r, k in zip(records, ("train_fwd", "train_bwd", "reduce")):
        r["launches"] = launches[k]
    check(len(evals) == 1 and all(bool(np.isfinite(evals[0][2][k])) for k in ("psnr", "ssim")),
          "the final eval finite")
    check({name for name, _, _ in saves} == {"save_checkpoint", "save_checkpoint_full"},
          "both final checkpoints saved")
    print(f"phase 13 train app from disk: {wall_ms / 1e3:.1f} s for {steps} chunked steps "
          f"({n_train} train views staged, {ATSCALE['n_cams'] - n_train} validation); parse "
          f"{box['parse_s']:.3f} s, {box['loads']} image reads {box['load_s']:.2f} s "
          f"({1e3 * box['load_s'] / max(box['loads'], 1):.2f} ms each), staging "
          f"{box['stage_ms'] / 1e3:.2f} s; SfM init N {box['init_n']}; peak {peak_gb:.2f} GB; "
          f"launches {launches}", flush=True)
    print("phase 13 ms/step by chunk [steps) N: " + ", ".join(
        f"[{a},{b}) {n} {ms:.2f}" for a, b, n, ms in chunks) + "; mean loss by chunk "
        + " ".join(f"{x.mean():.4f}" for x in losses), flush=True)
    for r in refines:
        cpu = ("the CPU refine: same counts and masks, rows within "
               f"{r['cpu_row_err']:.3e}" if r["cpu_row_err"] is not None else "not replayed")
        print(f"phase 13 refine @ {r['step']}: N {r['n_before']} -> alive {r['alive']} "
              f"(kept {r['kept']}, duplicated {r['duplicated']}, split {r['split']}, pruned "
              f"{r['pruned']}) -> N {r['n']}; {r['ms']:.1f} ms ({r['draw_ms']:.1f} ms host "
              f"draws); mean accumulated grad2d of the visible {r['grad_mean']:.3e} "
              f"(grow_grad2d {cfg.grow_grad2d}), {100 * r['grad_high']:.2f}% above it; {cpu}",
              flush=True)
    n_val, eval_ms, metrics = evals[0]
    print(f"phase 13 final eval ({n_val} views from disk, N {tr.scene.num_gaussians}): PSNR "
          f"{metrics['psnr']:.3f}, SSIM {metrics['ssim']:.4f}, {eval_ms / n_val:.2f} ms per "
          f"image (its read, render and metrics; render {1e3 * metrics['ellipse_time']:.2f} "
          f"ms); checkpoints " + ", ".join(f"{name} {ms / 1e3:.2f} s {size / 1e9:.3f} GB"
                                           for name, ms, size in saves), flush=True)
    K0 = box["views"][0][1]
    frames = tr.render_traj(K0, "", n_frames=8)
    check(len(frames) == 8 and all(f.shape == (h, w, 3) and f.dtype == np.uint8
                                   for f in frames), "render_traj: 8 uint8 frames")
    print(f"phase 13 trajectory GIF written by main's render_traj and read back by cv2: "
          f"{len(traj_frames)} frames of {w}x{h}, {traj_mb:.2f} MB; render_traj with no path: "
          f"8 frames, {sum(int(f.any()) for f in frames)} not black; phase 13 total "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)
    del tr, box
    torch.cuda.empty_cache()
    return records


def phase_gather():
    """``experiments/gather_locality.main([])`` at its defaults (the seed-0
    scene of 2^19 Gaussians and its Morton order, the 4-view orbit at
    1296 x 840, tile 32): its lines, the Morton lift against the default
    lift in scene order for both engines (``gather_locality``'s ``ok``:
    equal to f32 rounding for the Gaussians neither moved in a span, which
    a depth tie explains, nor in a tile that renders differently, which a
    move or a pack row's rounding explains; a weight sum beyond rounding
    only where moved; the rest within the module's limits), each kernel
    launched every view; then the Morton scene's lift
    alone through each engine with the counts set to 0 just before, and
    its view 0 held against the twins and timed as phase 3's view 0 (B1-,
    B2-, B3-, B6-, B7-morton, with the counts of that lift). Returns the
    five kernel records."""
    from tpugs_torch.encoders.base import LinearRGBEncoder
    from tpugs_torch.experiments import gather_locality
    from tpugs_torch.lift.batch import backproject_views
    from tpugs_torch.raster import kernels as K
    from tpugs_torch.utils.order import morton_permutation, permute_scene
    from tpugs_torch.utils.synthetic import orbit_cameras, random_scene

    t_phase = time.perf_counter()
    K.LAUNCHES.reset()
    out, ms = synced_ms(lambda: gather_locality.main([]))
    launches = K.LAUNCHES.snapshot()
    runs = 2 * gather_locality.VIEWS  # the two scenes' views, per engine
    for name in ("render", "adjoint", "reduce", "adjoint_scatter", "stripe_sum"):
        want = 2 * runs if name == "render" else runs
        check(launches[name] >= want, f"{name} launched every view ({launches[name]})")
    for engine, e in out["morton_equal"].items():
        check(e["ok"], f"the Morton lift ({engine}) equals the default lift in scene order to "
              f"f32 rounding for the Gaussians neither moved (a depth tie) nor in a tile that "
              f"renders differently (a move or a pack row's rounding), and within "
              f"{gather_locality.TIED_MAX_REL} of the row's max and "
              f"{gather_locality.TIED_MAX_SHARE} of N for the others: {e}")
    mean = {k: v["mean"] for k, v in out["lift"].items()}
    print(f"phase 14 gather locality: {ms / 1e3:.1f} s; launches {launches}; mean ms/view by "
          "stage: " + "; ".join(f"{k} " + ", ".join(f"{s} {v:.3f}" for s, v in m.items())
                               for k, m in mean.items()), flush=True)
    print("phase 14 Morton against default (stage mean ms/view): " + "; ".join(
        f"{e} {s} {mean[f'{e}-morton'][s] / mean[f'{e}-default'][s]:.3f}x"
        for e in ("pallas", "scatter") for s in ("pack", "render", "adjoint", "reduce")),
        flush=True)
    w, h = W_FULL, H_FULL
    scene = random_scene(N_FULL, seed=0, extent=1.0, scale_range=(0.004, 0.02), device="cuda")
    scene_m = permute_scene(scene, morton_permutation(scene))
    del scene
    cams = orbit_cameras(gather_locality.VIEWS, w, h, radius=3.0, device="cuda")
    enc = LinearRGBEncoder(D_FULL, device="cuda")
    counts = {}
    for engine in ("pallas", "scatter"):
        torch.cuda.synchronize()
        K.LAUNCHES.reset()
        backproject_views(scene_m, cams.viewmats, cams.Ks, w, h, enc, tile_size=TILE,
                          device="cuda", reduce_engine=engine)
        torch.cuda.synchronize()
        counts[engine] = K.LAUNCHES.snapshot()
    names = {"pallas": ("render", "adjoint", "reduce"),
             "scatter": ("render", "adjoint_scatter", "stripe_sum")}
    for engine, kernels in names.items():
        for name in kernels:
            check(counts[engine][name] >= gather_locality.VIEWS,
                  f"the Morton lift ({engine}) launched {name} every view "
                  f"({counts[engine][name]})")
    print(f"phase 14 the Morton scene's lift alone: launches {counts}", flush=True)
    records, r = lift_view_records(scene_m, cams, enc, counts["pallas"], counts["scatter"],
                                   "phase 14 Morton", "-morton")
    del r, scene_m
    torch.cuda.empty_cache()
    print(f"phase 14 total {time.perf_counter() - t_phase:.1f} s", flush=True)
    return records


BPE_PROBE = "#version: 0.2\nt a\nta b\nl e</w>\nv a\nc e</w>\n"  # merges for the text probe


def phase_convert():
    """The weight-conversion self-check (``apps/convert_weights.main``) on
    the card: LSeg-512 (ViT-L/16 + DPT head) in lang-seg's layout with the
    families the loader drops planted (the CLIP text tower under
    ``clip_pretrained.`` with a visual tensor and ``logit_scale``, timm's
    classifier, ``scratch.refinenet4.resConfUnit1``) and DINOv2
    ViT-L/14-reg with its ``mask_token``, seeded random weights written to
    a temporary directory, with a small BPE merges file; each self-check's
    output equal bit for bit to the module's own forward on the probe, the
    report's counts to the modules', and a planted unknown key raising."""
    import tempfile

    from tpugs_torch.apps import convert_weights as CW
    from tpugs_torch.encoders.clip_text import CLIPTextTower, SimpleTokenizer, tokenize
    from tpugs_torch.encoders.dino import DinoEncoder
    from tpugs_torch.encoders.lseg import LSegEncoder, LSegNet
    from tpugs_torch.encoders.vit import DINOV2_VIT_L14_REG, VisionTransformer

    t_phase = time.perf_counter()
    torch.manual_seed(0)
    net = LSegNet(device="cuda")
    text = CLIPTextTower(device="cuda")
    with torch.no_grad():  # its projection and positions start at zero
        for p in text.parameters():
            p.normal_(0.0, 0.02)
    vit = VisionTransformer(DINOV2_VIT_L14_REG, act="gelu", device="cuda")
    gen = torch.Generator().manual_seed(1)

    def rand(*shape):
        return torch.randn(shape, generator=gen)

    lseg_sd = {k: v.cpu() for k, v in net.state_dict().items()}
    lseg_sd.update({f"clip_pretrained.{k}": v.cpu() for k, v in text.state_dict().items()})
    lseg_sd.update({
        "clip_pretrained.visual.proj": rand(768, 512), "clip_pretrained.logit_scale": rand(),
        "logit_scale": rand(), "pretrained.model.head.weight": rand(1000, 1024),
        "pretrained.model.head.bias": rand(1000),
        **{f"scratch.refinenet4.resConfUnit1.conv{i}.{p}": rand(256, 256, 3, 3)
           if p == "weight" else rand(256) for i in (1, 2) for p in ("weight", "bias")}})
    dino_sd = {k: v.cpu() for k, v in vit.state_dict().items()}
    dino_sd["mask_token"] = rand(1, 1024)
    with tempfile.TemporaryDirectory() as tmp:
        lseg_path, dino_path = os.path.join(tmp, "lseg.ckpt"), os.path.join(tmp, "dino.pth")
        bpe = os.path.join(tmp, "bpe.txt")
        with open(bpe, "w") as fh:
            fh.write(BPE_PROBE)
        t0 = time.perf_counter()
        torch.save({"state_dict": lseg_sd, "epoch": 200}, lseg_path)
        torch.save(dino_sd, dino_path)
        write_s = time.perf_counter() - t0
        sizes = [os.path.getsize(p) / 1e9 for p in (lseg_path, dino_path)]
        (report, outputs), ms = synced_ms(lambda: CW.main([
            "--lseg-ckpt", lseg_path, "--dino-ckpt", dino_path, "--bpe-path", bpe,
            "--out-dir", os.path.join(tmp, "out")]))
        with open(os.path.join(tmp, "out", "convert_report.json")) as fh:
            check(json.load(fh) == report, "convert_report.json holds the report")
        tokens = torch.from_numpy(tokenize(SimpleTokenizer(bpe), CW.TEXT_PROBE)).cuda().long()
        unknown = dict(lseg_sd, **{"scratch.extra.weight": rand(3)})
        try:
            CW.convert_lseg(unknown, os.path.join(tmp, "bad"), "", {}, torch.device("cuda"))
        except RuntimeError as e:
            raised = "scratch.extra.weight" in str(e)
        else:
            raised = False
    check(raised, "a planted unknown key raises")
    with torch.no_grad():
        own = {"lseg": LSegEncoder.from_net(net)(CW._probe(480, torch.device("cuda"))),
               "dino": DinoEncoder.from_vit(vit)(CW._probe(224, torch.device("cuda"))),
               "clip_text": text.eval()(tokens)}
    for tower, module in (("lseg", net), ("clip_text", text), ("dino", vit)):
        check(torch.equal(outputs[tower], own[tower]),
              f"{tower}: the self-check's output equals the module's own forward bit for bit")
        counted = sum(v.numel() for v in module.state_dict().values())
        check(report[tower]["converted"]["parameters"] == counted
              and report[tower]["converted"]["tensors"] == len(module.state_dict()),
              f"{tower}: the report counts the module's state dict")
        stats = report[tower]["self_check"]
        check(stats["finite"] and stats["shape"] == list(own[tower].shape),
              f"{tower}: the self-check's output finite, of the module's shape")
    print(f"phase 15 convert_weights on the card: checkpoints written in {write_s:.1f} s "
          f"(LSeg {sizes[0]:.3f} GB, DINOv2 {sizes[1]:.3f} GB); the tool {ms / 1e3:.1f} s; "
          + "; ".join(f"{t} {r['converted']} {r['self_check']}" for t, r in report.items())
          + "; each output bit-equal to its module's forward; a planted unknown key raised; "
          f"phase 15 total {time.perf_counter() - t_phase:.1f} s", flush=True)
    del net, text, vit, outputs, own
    torch.cuda.empty_cache()


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; no card", file=sys.stderr)
        return 1
    if PEAKS_H100 is None:
        print("chip_smoke: the tpugs_torch package is not beside this script",
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
    view0 = (view.num.cpu(), view.den.cpu())
    del view
    train_records, scene0, ref4 = phase_train()
    records += train_records
    records += phase_eager()
    records += phase_absgrad()
    phase_app()
    lseg_records, field = phase_lseg(ref3["den"])
    records += lseg_records
    records += phase_queries(field, ref3)
    records += phase_training_loop(scene0)
    records += phase_profiling(view0, scene0, {r["id"]: r for r in records})
    del view0
    records += phase_interactive(field)
    del field
    phase_dist(ref3, ref4, scene0)
    del ref3, scene0
    records += phase_atscale()
    records += phase_gather()
    phase_convert()
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

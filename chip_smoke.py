#!/usr/bin/env python3
"""Drive the PyTorch port (``tpugs_torch``) on one CUDA card and check it.

    python3 chip_smoke.py        # from the repo root; one H100, nvcc on the box

Four phases; the first failure ends the run with a nonzero exit:

1. build   — compile ``tpugs_torch/csrc/*.cu`` for sm_90a and load them.
2. kernels — each kernel (B1 render, B2 adjoint in f32 and bf16, B3
             reduce) against its plain PyTorch twin on CUDA tensors, at mid
             shapes with edge cases: W, H not multiples of the tile, empty
             tiles, tiles that exit early, Gaussians covering many tiles.
3. full width — the canonical back-projection shape (N = 2^19 Gaussians,
             1296 x 840, D = 512, tile 32, linear encoder, 8 orbit views
             after one warm-up view) through ``backproject_views``; per-stage
             CUDA-event times, ms/view, views/s, peak memory; 64 random
             tiles of one view held against the twins; every kernel must
             have launched at least once per view.
4. kernels line — one JSON object per kernel with its launches, errors,
             time, the twin's time, its bound on this card and, for B3,
             the time of one library call (sparse CSR product) that
             computes the same sums.

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
        if "registers" in line or "Compiling entry" in line
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
    for name, n in launches.items():
        check(n >= VIEWS, f"{name} kernel launched at least once per view ({n})")
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

    def bound(bytes_, ops, peak):
        t_bytes, t_ops = 1e3 * bytes_ / PEAK_BYTES_S, 1e3 * ops / peak
        return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")

    b1_bound = bound(block_bytes + n_tiles * tspx * 5 * 4, PAIR_OPS * pairs, PEAK_F32_FLOPS)
    b2_bound = bound(block_bytes + n_tiles * tspx * D * 2 + T_padded * (D + 1) * 2,
                     2 * pairs * (D + 1), PEAK_BF16_FLOPS)
    b3_bound = bound(n_isects * ((D + 1) * 2 + 4) + N_FULL * ((D + 1) * 4 + 4),
                     n_isects * (D + 1), PEAK_F32_FLOPS)
    print(f"phase 3 work of one view: {n_tiles} tiles, {n_isects} intersections, "
          f"T_padded {T_padded}, {int(r.blocks_done.sum())} blocks walked "
          f"({pairs} pixel-Gaussian pairs)", flush=True)

    def rec(kid, name, src, replaces, n, err, ms, plain, b, lib=None):
        return {"id": kid, "name": name, "route": "cuda", "source": src,
                "replaces": replaces, "launches": n, "max_abs_err": err[0],
                "max_err": err[-1], "ms": ms, "plain_ms": plain, "bound_ms": b[0],
                "bound_by": b[1], "library_ms": lib}

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
    records = phase_full_width()
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

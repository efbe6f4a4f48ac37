"""Does index locality change the card's row-gather rate, and the lift's
stages? Counterpart: ``scripts/exp_gather_locality.py``.

The lift pays two random-row gathers per view: the pack (T rows of 64 B
from the (N, 16) parameter table) and the reduce (each Gaussian's rows of
the contribution buffer). A Gaussian's tile neighbours are its spatial
neighbours, so sorting the scene by 3D Morton code (``utils/order.py``)
clusters each tile's gather indices. On the seed-0 scene of N Gaussians
(``extent=1.0``, scales in (0.004, 0.02)), the 4-view orbit at radius 3,
tile 32, the scene as drawn ("default") and Morton-sorted ("morton"):

1. the pack-shaped gather: an (N + 1, 16) f32 table gathered by T
   indices, T being view 0's padded intersection count: uniform-random,
   sorted, and each scene's plan index, its composed index from padded
   slot to original id (``order[padded_gid]``, the padding to row N), which
   is what ``raster/pack.py`` gathers;
2. the reduce-shaped gather: a (T + 128, 640) bf16 table gathered by the
   rows the port's reduces read for each plan: the plan's CSR
   ``gauss_pos`` in Gaussian order, which B3 walks Gaussian by Gaussian
   (``raster/kernels.py::reduce_rows``; with Morton order neighbouring ids
   read rows of neighbouring tiles), and the XLA engine's cover-major
   slot table (``raster/reduce.py``, tpugs' own index, its slots cut at
   the exact caps); then uniform-random and sorted indices of the same
   count;
3. the lift: ``lift/batch.py::backproject_views`` over the 4 views on both
   scenes with both reduce engines ("pallas": B1, B2, B3; "scatter": B1,
   B6, B7) and ``LinearRGBEncoder(--feature-dim)``, each view's stages
   (``lift/batch.py::STAGES``) timed. The stages "render", "adjoint" and
   "reduce" each hold one kernel launch (B1; B2 or B6; B3 or B7) and its
   wrapper's checks and allocation. The Morton lift, put back into scene
   order by ``inverse_permutation``, is held against the default lift.
   Each Gaussian's rows are summed in tile order either way, but the
   plan's stable depth sort orders Gaussians of equal depth by index,
   which the permutation changes, and two such Gaussians that overlap
   composite in the other order. The SH colours also round by an
   element's position. ``tie_effects`` renders each view of both scenes
   (B1) and holds each move (a Gaussian the two plans put in different
   slots of a span) to a depth tie and each other pack row to f32
   rounding; every tile whose render or bf16 features differ must hold a
   move or such a row. A Gaussian neither moved nor in such a tile in any
   view reads the same features and, to rounding, the same weights, so its
   sums must agree to f32 rounding (``TIE_REL`` of the row's max); a
   weight sum (``den``) may differ beyond its rounding only for a moved
   Gaussian, since behind a move the transmittance differs by rounding
   only. The others' feature sums (``num``) change with the features at
   the pixels where a moved pair overlaps, and a near-black pixel turns
   its normalised feature on a difference far below the colour's
   rounding; they are held to ``TIED_MAX_REL`` of the row's max, and the
   Gaussians beyond rounding to ``TIED_MAX_SHARE`` of N.

The tables and the random indices are drawn on the device from seed 0.
A gather writes its rows to a preallocated buffer (``index_select``), as
the pack does; the rates count the gathered rows' bytes once. Each time
is the median of ``REPEATS`` calls after one warm-up call, by CUDA
events on the card and the host clock on the CPU (``profile_stages.timed``).

    python -m tpugs_torch.experiments.gather_locality [--device cpu] \\
        [--num-gaussians N --width W --height H --feature-dim D]

``main(argv)`` returns every measurement and the printed lines.
"""

from __future__ import annotations

import argparse
import time
from typing import Dict

import numpy as np
import torch

from tpugs_torch.core.device import resolve_device
from tpugs_torch.experiments.profile_stages import timed

TILE = 32
VIEWS = 4
REDUCE_WIDTH = 640  # 513 columns of bf16 rows, padded as tpugs' reduce reads them
REPEATS = 3  # timed calls per gather, after one warm-up call
TIE_REL = 1e-6  # f32 rounding of a Gaussian's sums, against its row's max
# the moved Gaussians and those in a changed tile (``tie_effects``): the
# limits of the Morton lift's differences, set from the card's readings
# at the defaults (a largest difference of 0.399 of the row's max, 774
# Gaussians beyond rounding)
TIED_MAX_REL = 0.5
TIED_MAX_SHARE = 0.003  # of N


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--num-gaussians", type=int, default=2**19)
    ap.add_argument("--width", type=int, default=1296)
    ap.add_argument("--height", type=int, default=840)
    ap.add_argument("--feature-dim", type=int, default=512)
    ap.add_argument("--device", default="cuda")
    return ap


def pack_index(plan) -> torch.Tensor:
    """The pack's gather index: padded slot -> original id, N for padding."""
    n = plan.num_gaussians
    order_ext = torch.cat([plan.order, torch.full((1,), n, dtype=plan.order.dtype,
                                                  device=plan.order.device)])
    return order_ext[plan.padded_gid.long().clamp(max=n)]


def slot_index(plan) -> torch.Tensor:
    """The XLA reduce engine's slot table flattened cover-major: row j
    holds each column's j-th row, for the columns with more than j rows."""
    from tpugs_torch.raster.plan import slot_columns

    slot_order, culled = slot_columns(plan)
    first = plan.gauss_offsets.long()[slot_order]
    pos = plan.gauss_pos.long()
    cover = int(culled[0]) if plan.n_isects else 0
    caps = torch.searchsorted(-culled, -torch.arange(cover, device=culled.device),
                              side="left").tolist()
    return torch.cat([pos[first[:cap] + j] for j, cap in enumerate(caps)]
                     or [pos[:0]])


def _lift_stages(scene, cams, width, height, encoder, engine, dev):
    """``backproject_views`` with its stages timed per view: (num, den,
    [{stage: ms} per view])."""
    from tpugs_torch.lift.batch import STAGES, backproject_views

    marks = []

    def on_stage(name):
        if dev.type == "cuda":
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            marks.append((name, ev))
        else:
            marks.append((name, time.perf_counter()))

    if dev.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        start.record()
    else:
        start = time.perf_counter()
    num, den = backproject_views(scene, cams.viewmats, cams.Ks, width, height, encoder,
                                 tile_size=TILE, device=dev, on_stage=on_stage,
                                 reduce_engine=engine)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    views, prev = [], start
    for i, (name, mark) in enumerate(marks):
        if i % len(STAGES) == 0:
            views.append({})
        views[-1][name] = (prev.elapsed_time(mark) if dev.type == "cuda"
                           else 1e3 * (mark - prev))
        prev = mark
    return num, den, views


def tie_effects(scene, perm, cams, width: int, height: int, encoder) -> dict:
    """Where ``scene`` and its permutation ``permute_scene(scene, perm)``
    part, over the views of ``cams`` (B1 renders both): "moved", (N,)
    bool, the Gaussians that the two plans put in different slots of a
    tile's span; "changed", (N,) bool, the Gaussians in a tile whose
    render or the lift's bf16 features of it (a pixelwise ``encoder``)
    differ; and the counts that must be 0: "moves_without_tie", slots
    where the plans hold Gaussians of different depths (the stable sort
    reorders only equal depths); "rows_beyond_rounding", slots holding one
    Gaussian whose pack rows differ beyond f32 rounding (``TIE_REL`` of
    the larger value, at least 1; the SH colours round by an element's
    position); "unexplained_changes", changed tiles with neither a move
    nor a pack row that differs. "changed_tiles" counts the tiles."""
    from tpugs_torch.lift.batch import render_and_pack
    from tpugs_torch.raster.projection import project
    from tpugs_torch.utils.order import permute_scene

    n, dev = scene.num_gaussians, scene.means.device
    scene_m = permute_scene(scene, perm)
    perm = torch.as_tensor(np.asarray(perm), device=dev)
    moved = torch.zeros(n, dtype=torch.bool, device=dev)
    changed = torch.zeros(n, dtype=torch.bool, device=dev)
    counts = dict.fromkeys(("changed_tiles", "moves_without_tie", "rows_beyond_rounding",
                            "unexplained_changes"), 0)
    for c in range(cams.num_cameras):
        view = (cams.viewmats[c], cams.Ks[c], width, height)
        r, r_m = render_and_pack(scene, *view, TILE), render_and_pack(scene_m, *view, TILE)
        if r.plan.T_padded != r_m.plan.T_padded:
            raise RuntimeError(f"view {c}: the permuted scene's plan has another layout")
        depth = project(scene.means, scene.quats, scene.scales, scene.opacities, *view).depths
        plan = r.plan
        gid, gid_m = plan.padded_gid.long(), r_m.plan.padded_gid.long()
        pad = torch.full_like(gid, -1)
        ids = torch.where(gid < n, plan.order[gid.clamp(max=n - 1)], pad)
        ids_m = torch.where(gid_m < n, perm[r_m.plan.order[gid_m.clamp(max=n - 1)]], pad)
        spans = torch.diff(plan.padded_starts.long(),
                           append=torch.tensor([plan.T_padded], device=dev))
        tile = torch.repeat_interleave(torch.arange(plan.n_tiles, device=dev), spans,
                                       output_size=plan.T_padded)
        move = ids != ids_m
        counts["moves_without_tie"] += int(
            ((ids[move] < 0) | (ids_m[move] < 0) | (depth[ids[move]] != depth[ids_m[move]])).sum())
        moved[ids[move & (ids >= 0)]] = True
        rounded = (r.packed != r_m.packed).any(1) & ~move
        scale = torch.maximum(r.packed.abs(), r_m.packed.abs()).clamp(min=1)
        counts["rows_beyond_rounding"] += int(
            ((r.packed - r_m.packed).abs() > TIE_REL * scale).any(1)[~move].sum())
        explained = torch.zeros(plan.n_tiles, dtype=torch.bool, device=dev)
        explained[tile[move | rounded]] = True
        feats, feats_m = (encoder(t[..., :3]).to(torch.bfloat16) for t in (r.tiles, r_m.tiles))
        diff = (r.tiles != r_m.tiles).flatten(1).any(1) | (feats != feats_m).flatten(1).any(1)
        del feats, feats_m, r_m
        counts["changed_tiles"] += int(diff.sum())
        counts["unexplained_changes"] += int((diff & ~explained).sum())
        changed[ids[(ids >= 0) & diff[tile]]] = True
    return {"moved": moved, "changed": changed, **counts}


def _morton_against_default(num_m, den_m, num, den, inv, ties) -> dict:
    """The Morton lift in scene order against the default lift, with the
    permutation's effects (``tie_effects``): the Gaussians whose sums
    differ and those beyond f32 rounding of their row's max; of the
    Gaussians neither moved nor in a changed tile, those that differ and
    those beyond rounding, which must be none; the weight sums beyond
    their rounding, and of those the ones not moved, which must be none;
    the largest difference, overall and among the moved and changed, of
    the row's max. ``ok``: these hold, ``tie_effects``' counts are 0, and
    the differences among the moved and changed are within
    ``TIED_MAX_REL`` and ``TIED_MAX_SHARE``."""
    moved, hit = ties["moved"], ties["moved"] | ties["changed"]
    sums_m = torch.cat([num_m, den_m[:, None]], 1)[inv]
    sums = torch.cat([num, den[:, None]], 1)
    differ = (sums_m != sums).any(1)
    scale = sums.abs().amax(1).clamp(min=1e-30)
    rel = (sums_m - sums).abs().amax(1) / scale
    beyond = differ & (rel > TIE_REL)
    weights = (sums_m[:, -1] - sums[:, -1]).abs() > TIE_REL * sums[:, -1].abs()
    e = {"bit_equal": not bool(differ.any()), "differing": int(differ.sum()),
         "beyond_rounding": int(beyond.sum()), "max_rel": float(rel.max()),
         **{k: v for k, v in ties.items() if k not in ("moved", "changed")},
         "moved": int(moved.sum()), "moved_or_changed": int(hit.sum()),
         "untouched_differing": int((differ & ~hit).sum()),
         "untouched_beyond_rounding": int((beyond & ~hit).sum()),
         "touched_max_rel": float(torch.where(hit, rel, 0).max()),
         "weights_beyond_rounding": int(weights.sum()),
         "weights_beyond_unmoved": int((weights & ~moved).sum())}
    e["ok"] = (e["moves_without_tie"] == e["rows_beyond_rounding"] == 0
               and e["unexplained_changes"] == e["untouched_beyond_rounding"] == 0
               and e["weights_beyond_unmoved"] == 0 and e["touched_max_rel"] <= TIED_MAX_REL
               and e["beyond_rounding"] <= TIED_MAX_SHARE * len(rel))
    return e


def main(argv=None) -> dict:
    from tpugs_torch.encoders.base import LinearRGBEncoder
    from tpugs_torch.lift.batch import STAGES
    from tpugs_torch.raster.plan import build_plan
    from tpugs_torch.raster.projection import project
    from tpugs_torch.utils.order import inverse_permutation, morton_permutation, permute_scene
    from tpugs_torch.utils.synthetic import orbit_cameras, random_scene

    args = _parser().parse_args(argv)
    dev = resolve_device(args.device)
    n, w, h, reps = args.num_gaussians, args.width, args.height, REPEATS
    lines = []

    def say(line):
        lines.append(line)
        print(line, flush=True)

    say(f"gather locality on {dev}: N {n}, {w}x{h}, tile {TILE}, {VIEWS} views, median of "
        f"{reps}")
    cams = orbit_cameras(VIEWS, w, h, radius=3.0, device=dev)
    scene = random_scene(n, seed=0, extent=1.0, scale_range=(0.004, 0.02), device=dev)
    perm = morton_permutation(scene)
    scenes = {"default": scene, "morton": permute_scene(scene, perm)}
    plans = {}
    for name, sc in scenes.items():
        proj = project(sc.means, sc.quats, sc.scales, sc.opacities, cams.viewmats[0],
                       cams.Ks[0], w, h)
        plans[name] = build_plan(proj, w, h, TILE)
    T, n_isects = plans["default"].T_padded, plans["default"].n_isects
    if (plans["morton"].T_padded, plans["morton"].n_isects) != (T, n_isects):
        raise RuntimeError("the Morton plan's sizes differ from the default plan's")
    gen = torch.Generator(device=dev).manual_seed(0)

    def rate(table, idx, kind, label):
        out = torch.empty((idx.shape[0], table.shape[1]), dtype=table.dtype, device=dev)
        ms = timed(lambda: torch.index_select(table, 0, idx, out=out), reps, dev)[0]
        rows, nbytes = idx.shape[0], idx.shape[0] * table.shape[1] * table.element_size()
        r = {"ms": ms, "rows": rows, "m_rows_s": rows / ms / 1e3, "gb_s": nbytes / ms / 1e6}
        say(f"{kind}[{label}]: {rows} rows of {table.shape[1] * table.element_size()} B in "
            f"{ms:.4f} ms -> {r['m_rows_s']:.1f} M rows/s, {r['gb_s']:.1f} GB/s")
        return r

    # 1. the pack-shaped gather: 64-B rows of an (N + 1)-row table
    table_s = torch.randn((n + 1, 16), generator=gen, device=dev)
    idx = torch.randint(0, n, (T,), generator=gen, device=dev)
    pack = {"uniform-random": rate(table_s, idx, "pack", "uniform-random"),
            "sorted": rate(table_s, idx.sort().values, "pack", "sorted")}
    for name, plan in plans.items():
        pack[f"plan-{name}"] = rate(table_s, pack_index(plan), "pack", f"plan-{name}")
    del table_s

    # 2. the reduce-shaped gather: 1280-B bf16 rows of a (T + 128)-row table
    table_b = torch.randn((T + 128, REDUCE_WIDTH), generator=gen, device=dev,
                          dtype=torch.bfloat16)
    reduce = {}
    for name, plan in plans.items():
        reduce[f"csr-{name}"] = rate(table_b, plan.gauss_pos.long(), "reduce", f"csr-{name}")
        reduce[f"slots-{name}"] = rate(table_b, slot_index(plan), "reduce", f"slots-{name}")
    idx = torch.randint(0, T, (n_isects,), generator=gen, device=dev)
    reduce["uniform-random"] = rate(table_b, idx, "reduce", "uniform-random")
    reduce["sorted"] = rate(table_b, idx.sort().values, "reduce", "sorted")
    del table_b, idx, plans

    # 3. the lift over the 4 views, both scenes, both engines
    enc = LinearRGBEncoder(args.feature_dim, device=dev)
    inv = torch.as_tensor(inverse_permutation(perm), device=dev)
    ties = tie_effects(scene, perm, cams, w, h, enc)
    lift: Dict[str, dict] = {}
    equal = {}
    for engine in ("pallas", "scatter"):
        # a warm-up view (allocator, library load)
        _lift_stages(scene, orbit_cameras(1, w, h, radius=3.0, device=dev), w, h, enc,
                     engine, dev)
        sums = {}
        for name, sc in scenes.items():
            num, den, views = _lift_stages(sc, cams, w, h, enc, engine, dev)
            sums[name] = (num, den)
            mean = {k: float(np.mean([v[k] for v in views])) for k in STAGES}
            lift[f"{engine}-{name}"] = {"views": views, "mean": mean,
                                        "ms_view": sum(mean.values())}
            for c, v in enumerate(views):
                say(f"lift[{engine}-{name}] view {c}: " + ", ".join(
                    f"{k} {v[k]:.3f}" for k in STAGES) + f" ms; total {sum(v.values()):.3f}")
        equal[engine] = _morton_against_default(*sums["morton"], *sums["default"], inv, ties)
        e = equal[engine]
        say(f"lift[{engine}] Morton in scene order against default: bit-equal "
            f"{e['bit_equal']}, {e['differing']} Gaussians differ (max {e['max_rel']:.3e} "
            f"of their row's max), {e['beyond_rounding']} beyond f32 rounding "
            f"(limit {TIED_MAX_SHARE * n:.0f}); {e['moved']} Gaussians moved in a span "
            f"({e['moves_without_tie']} without a depth tie), {e['rows_beyond_rounding']} "
            f"pack rows beyond rounding, {e['changed_tiles']} tiles of the {VIEWS} views "
            f"changed ({e['unexplained_changes']} with neither a move nor a rounded row); "
            f"neither moved nor in a changed tile {n - e['moved_or_changed']} Gaussians: "
            f"{e['untouched_differing']} differ, {e['untouched_beyond_rounding']} beyond "
            f"rounding; the other {e['moved_or_changed']}: max {e['touched_max_rel']:.3e} "
            f"(limit {TIED_MAX_REL}); weight sums beyond rounding "
            f"{e['weights_beyond_rounding']}, of which {e['weights_beyond_unmoved']} not "
            f"moved; ok {e['ok']}")
        del sums
    return {"T_padded": T, "n_isects": n_isects, "pack": pack, "reduce": reduce,
            "lift": lift, "morton_equal": equal, "lines": lines}


if __name__ == "__main__":
    main()

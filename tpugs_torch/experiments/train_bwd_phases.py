"""Where does the train backward kernel's time go? Times B5
(``csrc/train_bwd.cu``) on recorded inputs with each of its phases
removed in turn: ``--inputs step``, one full-width train step (D = 131,
tile 32, chip_smoke.py's phase 4); ``step512``, the same step at
``feature_dim`` 512 (D = 515, phase 4w); ``step1024``, the step at
``feature_dim`` 1024 against a 1024-wide teacher with absgrad (D = 1027,
phase 4x): its rows and its geometry rows; or ``absgrad``, chip_smoke.py's
phase 5 render (the canonical scene's view 0 at tile 16, ``trans_eps`` 0,
D = 515 with a background): its rows and its geometry rows.

The harness is ``adjoint_phases``'s: each variant is a copy of a B5
source with phases cut out by exact text substitutions (``TABLES``; a
pattern that is not found exactly once raises), compiled by ``nvcc`` into
its own library under ``build/train_bwd_phases/<table>/`` and launched
through the table's own entry points (``LAUNCH``) into rows of the
inputs' width (``rows``, D + 8 rounded up to 4) or of the 8 geometry
columns (``geometry``). The phases:

  u product   the products u = g . colour (the walk reads u = 0)
  g staging   every copy of the image cotangent g into shared memory
              (the products read stale shared memory)
  walk        the per-pixel walk: w, d sigma and d op are constants (u
              is still consumed, so its product stays)
  geometry    the 8 geometry sums over pixels
  d col       the product d col = w^T g
  zero rows   the rows of the blocks past a tile's early exit
  colour staging  (cluster kernels) the sub-blocks' colour copies
  exchange    (cluster kernels) the DSMEM sums of the ranks' partial rows
  group sum   (geometry kernel) the second kernel, which adds the pixel
              groups' sums (only where G > 1)
  occupancy   (cluster kernel) not a phase: 114 KB more shared memory per
              CTA, so that only one fits on an SM

A variant's rows are wrong by design; only the full copy's columns are
held to the plain twin, on 64 sampled tiles, within ``GRAD_ROWS_TOL``
(the other columns taken from the twin). Tables: ``d4ac1ba``, the one-CTA
kernel of commit d4ac1ba; ``cluster``, the resident-g cluster kernel that
replaced it (D <= 256), and ``old-cluster``, the same kernel in another
commit's source (its full copy only); ``colour`` and ``geom``, the colour
slices and the geometry cluster kernel; ``old``, commit d031322's B5 (its full
copy only): its geometry launch (the geometry cluster kernel of 64-pixel
ranks up to 700 channels, a one-CTA geometry kernel above) and, on every
``rows`` work, its route: B5's rows per 512-channel chunk of the colours
and, with absgrad above 512 channels, the geometry launch over all of
them (``old/route``, the chunks' inputs cut beforehand). Where a table's
full copy writes every column, the tool prints whether its rows equal the
route's bit for bit. ``--widest`` (repeatable) times the colour table
with slices of at most that many columns. Beside the tables, the tree's
own ``train_rows`` and ``train_geom_rows`` (the route) are timed on the
same inputs, with the bound of each work (chip_smoke.py's B5 bounds).

On the card::

    git show d4ac1ba:tpugs_torch/csrc/train_bwd.cu > build/train_bwd_d4ac1ba.cu
    python -m tpugs_torch.experiments.train_bwd_phases \\
        --run d4ac1ba=build/train_bwd_d4ac1ba.cu --run cluster
    git show d031322:tpugs_torch/csrc/train_bwd.cu > build/train_bwd_d031322.cu
    python -m tpugs_torch.experiments.train_bwd_phases --inputs step1024 \\
        --run old=build/train_bwd_d031322.cu --run geom --run colour
    python -m tpugs_torch.experiments.train_bwd_phases \\
        --run old-cluster=build/train_bwd_d031322.cu --run cluster

prints one line per kernel, work and variant: ms (CUDA events, mean of
``--iters`` launches), the full kernel timed first and last. The kernels
of one call share the recorded inputs and the card.
"""

from __future__ import annotations

import argparse
import ctypes
import re
import subprocess
from pathlib import Path
from typing import Dict, List, Tuple

import torch

from tpugs_torch.experiments.adjoint_phases import Sub, build_variants, variants
from tpugs_torch.raster import train as T

_D4_WALK = """            const PairTerms t = pair_terms(g, gi, px, py);
            const float alpha = clipped_alpha(t, gi < remaining);
            const bool kept = alpha != 0.0f;
            const float w = alpha * texc * trans;
            cs = fmaf(w, u[i], cs);
            const float v = grem - cs;
            const float d_alpha = texc * trans * u[i] - (v + h) / fmaxf(1.0f - alpha, 1e-6f);
            const float d_araw = (kept && t.alpha_raw < kAlphaMax) ? d_alpha : 0.0f;
            Dop[i * kLdD + tid] = d_araw * t.e;
            Dsig[i * kLdD + tid] = t.sigma > 0.0f ? -d_araw * g.op[gi] * t.e : 0.0f;
            Ws[tid * kLdW + i] = w;
            texc *= 1.0f - alpha;"""
_CONST_WALK = """            cs = fmaf(1e-3f, u[i], cs);
            Dop[i * kLdD + tid] = 1e-3f + grem + h + trans + gi;
            Dsig[i * kLdD + tid] = 1e-3f;
            Ws[tid * kLdW + i] = 1e-3f;"""

TABLES: Dict[str, Dict[str, List[Sub]]] = {
    "old": {},
    "d4ac1ba": {
        "u product": [("        for (int k = 0; k < kDK; ++k) {\n"
                       "            const float gv = Gs[tid * kLdG + k];",
                       "        for (int k = 0; k < 0; ++k) {\n"
                       "            const float gv = Gs[tid * kLdG + k];")],
        "g staging": [
            ("\n          stage_g(Gs, gimg, c, d0, x0, y0, ts_shift, width, height, D, tid);", "\n"),
            ("\n            stage_g(Gs, gimg, c, d0, x0, y0, ts_shift, width, height, D, tid);",
             "\n"),
        ],
        "walk": [(_D4_WALK, _CONST_WALK)],
        "geometry": [("for (int q = l; q < kThreads; q += 8) {",
                      "for (int q = l; q < 0; q += 8) {")],
        "d col": [("            for (int q = 0; q < kThreads; ++q) {\n"
                   "              const float4 w4",
                   "            for (int q = 0; q < 0; ++q) {\n"
                   "              const float4 w4")],
        "zero rows": [("  for (long long idx = tid; idx < n_zero; idx += kThreads) "
                       "store(out + zero0 + idx, 0.0f);\n", "")],
    },
    "old-cluster": {},
}

_CLUSTER_WALK = """            const PairTerms t = pair_terms(g, gi, px, py);
            const float alpha = clipped_alpha(t, gi < remaining);
            const bool kept = alpha != 0.0f;
            const float w = alpha * texc * trans;
            cs = fmaf(w, uu[e], cs);
            const float v = grem - cs;
            const float d_alpha = texc * trans * uu[e] - (v + h) / fmaxf(1.0f - alpha, 1e-6f);
            const float d_araw = (kept && t.alpha_raw < kAlphaMax) ? d_alpha : 0.0f;
            ww[e] = w;
            texc *= 1.0f - alpha;
            dsv[e] = t.sigma > 0.0f ? -d_araw * g.op[gi] * t.e : 0.0f;
            dopv[e] = d_araw * t.e;
            dxv[e] = t.dx;
            dyv[e] = t.dy;"""
_CLUSTER_CONST_WALK = """            const float d_araw = 1e-3f * gi;
            cs = fmaf(1e-3f, uu[e], cs);
            ww[e] = 1e-3f;
            dsv[e] = d_araw + grem + h + trans;
            dopv[e] = d_araw;
            dxv[e] = px;
            dyv[e] = py;"""
_D_COL = [("for (int q = q0; q < q0 + kPix / 2; ++q) {", "for (int q = q0; q < q0; ++q) {")]

TABLES["cluster"] = {
    "u product": [("for (int k = 0; k < D4; k += 4) {", "for (int k = 0; k < 0; k += 4) {")],
    "g staging": [("    if (ok) v = gimg[(static_cast<long long>(y) * width + x) * D + c];\n"
                   "    Gs[pl * ldg + c] = v;\n",
                   "    if (ok) v = gimg[(static_cast<long long>(y) * width + x) * D + c];\n")],
    "colour staging": [("    cp_async4(Ct + i * L.ldg + e - i * D, src + e);\n", "")],
    "walk": [(_CLUSTER_WALK, _CLUSTER_CONST_WALK)],
    "geometry": [("make_float4(ww[0], ww[1], ww[2], ww[3]);\n"
                  "          float sum = 0.0f;  // every term is 0 when no lane has a nonzero d "
                  "alpha\n          if (__any_sync(0xffffffffu, any)) {",
                  "make_float4(ww[0], ww[1], ww[2], ww[3]);\n"
                  "          float sum = 0.0f;\n          if (false) {")],
    "d col": _D_COL,
    "zero rows": [("  for (long long v = R * kCThreads + tid; v < n_vec; v += (kGhost ? G : 1) * C "
                   "* kCThreads)\n"
                   "    *reinterpret_cast<uint4*>(out + zero0 + v * V) = make_uint4(0, 0, 0, 0);\n",
                   "")],
    "exchange": [("        sum_partials(out + (row0 + gbase) * RW, part, C, rank, RW, tid);\n",
                  "        ;\n")],
    "occupancy": [("*bytes = ClusterLayout(D, RW).bytes();",
                   "*bytes = ClusterLayout(D, RW).bytes() + 114 * 1024;")],
}

TABLES["colour"] = {
    "g staging": [("      v = gimg[(static_cast<long long>(y) * width + x) * D + c0 + c];\n"
                   "    Gs[pl * ldg + c] = v;\n",
                   "      v = gimg[(static_cast<long long>(y) * width + x) * D + c0 + c];\n")],
    "walk": [("""            const PairTerms t = pair_terms(g, gi, px, py);
            const float alpha = clipped_alpha(t, gi < remaining);
            ww[e] = alpha * texc * trans;
            texc *= 1.0f - alpha;""", """            ww[e] = 1e-3f * gi + trans + px + py;""")],
    "d col": _D_COL,
    "exchange": [("        sum_columns(out + (row0 + gbase) * RW + c0, part, C, rank, Ns, ns, RW, "
                  "tid);\n", "        ;\n")],
}

_GEOM_WALK = """          const PairTerms pt = pair_terms(g, gi, px, py);
          const float alpha = clipped_alpha(pt, gi < remaining);
          al[e] = alpha;
          ex[e] = pt.e;
          if (alpha != 0.0f && pt.alpha_raw < kAlphaMax) grad |= 1u << e;
          if (pt.sigma > 0.0f) pos |= 1u << e;
          S = fmaf(alpha * P, uu[e], S);
          P *= 1.0f - alpha;"""
_GEOM_CONST_WALK = """          al[e] = 1e-3f * gi + px + py;
          ex[e] = 1e-3f;
          grad |= 1u << e;
          pos |= 1u << e;
          S = fmaf(al[e] * P, uu[e], S);
          P *= 1.0f - al[e];"""

TABLES["geom"] = {
    "u product": [("for (int k = 0; k < kw4; k += 4) {", "for (int k = 0; k < 0; k += 4) {")],
    "g staging": [("    if (c < D && inside) v = gimg[(static_cast<long long>(y) * width + x) * D "
                   "+ c];\n    Gs[pl * ldg + c] = v;\n",
                   "    if (c < D && inside) v = gimg[(static_cast<long long>(y) * width + x) * D "
                   "+ c];\n")],
    "colour staging": [
        ("      if (k < kw) cp_async16(Cc + i * kLdC + k, src + static_cast<long long>(i) * D + k);\n",
         ""),
        ("        cp_async4(Cc + i * kLdC + k, src + static_cast<long long>(i) * D + k);\n",
         "        ;\n"),
    ],
    "walk": [(_GEOM_WALK, _GEOM_CONST_WALK)],
    "geometry": [("for (int p = l; p < NP; p += 8) {", "for (int p = l; p < 0; p += 8) {")],
    "zero rows": [("  for (long long v = R * kGThreads + tid; v < n_vec; v += G * C * kGThreads)\n"
                   "    *reinterpret_cast<uint4*>(out + zero0 + v * V) = make_uint4(0, 0, 0, 0);\n",
                   "")],
    "exchange": [("    if (G == 1)\n"
                  "      sum_geometry(out + row0 * RW + col0, part, C, rank, RW, n_pad, tid);\n"
                  "    else\n"
                  "      sum_geometry(gsum + (row0 / kBlock * G + group) * kBlock * kGeomGrads, "
                  "part, C, rank,\n                   kGeomGrads, 0, tid);\n", "")],
    "group sum": [("  if (G > 1) {\n    const int col0 = RW == kGeomGrads ? 0 : D;",
                   "  if (false) {\n    const int col0 = RW == kGeomGrads ? 0 : D;")],
}

VARIANTS = (
    ("full", ()),
    ("no u product", ("u product",)),
    ("no g staging", ("g staging",)),
    ("no colour staging", ("colour staging",)),
    ("no walk", ("walk",)),
    ("no geometry sums", ("geometry",)),
    ("no d col product", ("d col",)),
    ("no zero rows", ("zero rows",)),
    ("no DSMEM sums", ("exchange",)),
    ("no group sum", ("group sum",)),
    ("one CTA per SM", ("occupancy",)),
    ("no products", ("u product", "d col")),
)


OLD_GEOM_MAX_CHANNELS = 700  # d031322's geometry cluster kernel (64-pixel ranks); above, one CTA


def _old_geom(d: int, text: str):
    """d031322's geometry launch at D = ``d`` from its source ``text``:
    (entry, ts -> its cluster arguments after the row width). Up to 700
    channels its geometry cluster kernel; above, its one-CTA geometry
    kernel, the source's other f32 geometry entry (no cluster arguments)."""
    if d <= OLD_GEOM_MAX_CHANNELS:
        return "tpugs_train_bwd_geom_f32", lambda ts: (ts * ts // 64, 64)
    (name,) = set(re.findall(r'extern "C" int (tpugs_train_bwd_geom_\w+_f32)\(', text)) - {
        "tpugs_train_bwd_geom_f32"}
    return name, lambda ts: ()


# table -> work -> (entry point, or (D, source text) -> entry point; (ts, D,
# widest) -> the cluster arguments after the row width, or None where the
# kernel does not take the width, or (ts, D, source text) -> them; the
# columns it writes: "all", "colour" 0:D or "geometry" D onward; whether the
# entry takes the pixel groups' scratch after out (and, for the tree's
# cluster kernel and colour slices, the scratch's row count T_padded last))
LAUNCH = {
    "d4ac1ba": {"rows": ("tpugs_train_bwd_f32", lambda ts, d, ws: (), "all", False)},
    "cluster": {"rows": ("tpugs_train_bwd_f32", lambda ts, d, ws: T.train_cluster(ts, d), "all",
                         True)},
    "old-cluster": {"rows": ("tpugs_train_bwd_f32", lambda ts, d, ws: (
        None if T.train_cluster(ts, d) is None else T.train_cluster(ts, d)[:2]), "all", False)},
    "old": {"geometry": (lambda d, text: _old_geom(d, text)[0],
                         lambda ts, d, text: _old_geom(d, text)[1](ts), "all", False)},
    "colour": {"rows": ("tpugs_train_bwd_colour_f32", lambda ts, d, ws: T.rank_groups(ts)
                        + T.fwd_slices(d, ws or T.COLOUR_SLICE_CHANNELS), "colour", True)},
    "geom": {"rows": ("tpugs_train_bwd_geom_f32", lambda ts, d, ws: T.geom_cluster(ts, d),
                      "geometry", True),
             "geometry": ("tpugs_train_bwd_geom_f32", lambda ts, d, ws: T.geom_cluster(ts, d),
                          "all", True)},
}

_P, _I = ctypes.c_void_p, ctypes.c_int


def recorded_step(warmup: int = 3, feature_dim: int = 128, teacher: int = 512,
                  absgrad: bool = False) -> dict:
    """B5's inputs and rows of one train step at ``chip_smoke.py``'s phase 4
    configuration (2^19 Gaussians, 1296 x 840, tile 32, f32 rows) with
    ``feature_dim`` features (D = 3 + feature_dim) against a ``linear``
    teacher ``teacher`` wide, absgrad on or off, caught by
    ``Trainer.record`` after ``warmup`` steps."""
    import numpy as np

    from tpugs_torch.encoders import get_encoder
    from tpugs_torch.train.config import TrainConfig
    from tpugs_torch.train.trainer import Trainer, init_scene_from_points
    from tpugs_torch.utils.synthetic import orbit_cameras

    n, w, h, n_cams = 2**19, 1296, 840, 8
    rng = np.random.default_rng(0)
    pts = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    rgbs = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    cams = orbit_cameras(n_cams, w, h, radius=3.0, device="cuda")
    images = torch.from_numpy(rng.uniform(0, 1, (n_cams, h, w, 3)).astype(np.float32)).cuda()
    cam_idx = rng.integers(0, n_cams, warmup + 1)
    cfg = TrainConfig(max_steps=30_000, sh_degree=3, feature_dim=feature_dim,
                      feature_out_dim=teacher, strategy="none", random_bkgd=False,
                      sh_degree_interval=1, absgrad=absgrad)
    tr = Trainer(cfg, init_scene_from_points(pts, rgbs, cfg), 1.0,
                 teacher=get_encoder(f"linear:{teacher}"), width=w, height=h, n_cameras=n_cams)
    staged = {"images": images, "viewmats": cams.viewmats, "Ks": cams.Ks}
    tr.train_chunk(staged, warmup, cam_idx[:warmup])
    tr.record = seen = {}
    tr.train_chunk(staged, 1, cam_idx[warmup:])
    tr.record = None
    torch.cuda.synchronize()
    return seen


def absgrad_inputs(d: int = 515) -> dict:
    """chip_smoke.py's phase 5 render at D = ``d``: the canonical scene
    (2^19 Gaussians, seed 0), view 0 of 8 orbit views at 1296 x 840, tile
    16, ``trans_eps`` 0, seeded colours, background and image cotangent.
    Returns B5's inputs (geom, cols, g, hterm, grem0, blocks_done, plan)
    for ``rows`` and ``geometry``, and the image without its background."""
    from tpugs_torch.raster.plan import build_plan
    from tpugs_torch.raster.projection import project
    from tpugs_torch.utils.synthetic import orbit_cameras, random_scene

    n, w, h = 2**19, 1296, 840
    scene = random_scene(n, seed=0, extent=1.0, scale_range=(0.004, 0.02), device="cuda")
    cams = orbit_cameras(8, w, h, radius=3.0, device="cuda")
    with torch.no_grad():
        proj = project(scene.means, scene.quats, scene.scales, scene.opacities,
                       cams.viewmats[0], cams.Ks[0], w, h)
        plan = build_plan(proj, w, h, 16)
    gen = torch.Generator(device="cuda").manual_seed(15)
    opac = torch.where(proj.valid, proj.opacities, torch.zeros_like(proj.opacities))
    colors = torch.rand((n, d), device="cuda", generator=gen)
    bg = torch.rand((d,), device="cuda", generator=gen)
    g = torch.randn((h, w, d), device="cuda", generator=gen)
    geom, cols = T.pack_train(proj.means2d, proj.conics, opac, colors, plan)
    image, alpha, done = T.train_forward(geom, cols, plan, 0.0)
    hterm = ((g @ bg) * (1.0 - alpha)).contiguous()
    args = (geom, cols, g, hterm, (g * image).sum(-1).contiguous(), done, plan)
    return {"rows": args, "geometry": args}, image


def parent_route(lib, text: str, args, image, absgrad: bool, stream):
    """d031322's B5 launches for one render on ``args`` (all D channels;
    ``image`` without its background), into new rows: per 512-channel chunk
    of the colours, that chunk's rows (its cluster kernel up to 256
    channels, else its colour slices plus its geometry cluster kernel;
    ``hterm`` in the first chunk only), and with ``absgrad`` above 512
    channels its geometry launch over all D (its geometry cluster kernel up
    to 700 channels, its one-CTA geometry kernel above; ``text`` is its
    source). The chunks' inputs are cut here; the returned function makes
    the launches."""
    from tpugs_torch.raster import kernels as K

    geom, cols, g, hterm, _, done, plan = args
    d, ts, ntx = cols.shape[1], plan.tile_size, plan.grid[0]
    launches = []

    def add(name, cluster, c, g_c, h_c, grem_c, out):
        fn = getattr(lib, name)
        fn.argtypes = [_P] * 10 + [_I] * (7 + len(cluster)) + [_P]
        fn.restype = _I
        launches.append(lambda: fn(
            K._ptr(geom), K._ptr(c), K._ptr(g_c), K._ptr(h_c), K._ptr(grem_c),
            K._ptr(plan.tile_starts), K._ptr(plan.tile_ends), K._ptr(plan.padded_starts),
            K._ptr(done), K._ptr(out), plan.n_tiles, ntx, ts, plan.width, plan.height,
            c.shape[1], out.shape[1], *cluster, stream))

    for a in range(0, d, 512):
        b = min(a + 512, d)
        c, g_c = cols[:, a:b].contiguous(), g[..., a:b].contiguous()
        h_c = hterm if a == 0 else torch.zeros_like(hterm)
        grem_c = (g_c * image[..., a:b]).sum(-1).contiguous()
        out = torch.empty((plan.T_padded, T.grad_row_width(b - a)), device="cuda")
        if b - a <= T.CLUSTER_MAX_CHANNELS:
            add("tpugs_train_bwd_f32", T.train_cluster(ts, b - a)[:2], c, g_c, h_c, grem_c, out)
            continue
        add("tpugs_train_bwd_colour_f32", (ts * ts // T.PIXELS_PER_RANK, T.PIXELS_PER_RANK)
            + T.fwd_slices(b - a, T.COLOUR_SLICE_CHANNELS), c, g_c, h_c, grem_c, out)
        add("tpugs_train_bwd_geom_f32", (ts * ts // 64, 64), c, g_c, h_c, grem_c, out)
    if absgrad and d > 512:
        name, layout = _old_geom(d, text)
        out = torch.empty((plan.T_padded, T.GEOM_GRADS), device="cuda")
        add(name, layout(ts), cols, g, hterm, args[4], out)

    def go():
        for launch in launches:
            rc = launch()
            if rc != 0:
                raise RuntimeError(f"the parent's route failed with CUDA error {rc}")
    return go


def work_bound(args, work: str):
    """(least ms, what bounds it) of B5's rows or geometry rows on ``args``,
    as chip_smoke.py counts them: pairs * 30 + nonzero-alpha pairs * (4D +
    30) f32 operations for the rows, (2D + 30) for the geometry; the walked
    blocks' packs, g, hterm and grem0 once, blocks_done, the rows written."""
    from tpugs_torch.raster.kernels import _all_tiles, _walk_blocks
    from tpugs_torch.utils.profiling import PEAKS_H100

    geom, cols, g, _, _, done, plan = args
    d, (h, w) = cols.shape[1], (plan.height, plan.width)
    kept = torch.zeros((), dtype=torch.int64, device=geom.device)

    def visit(st):
        kept.add_((st.terms["alpha"] != 0).sum())

    _walk_blocks(geom, plan, _all_tiles(plan, geom.device), 0.0, visit, n_blocks=done)
    walked = int(done.sum())
    pairs = walked * 128 * plan.tile_size**2
    per_pair = 4 * d if work == "rows" else 2 * d
    width = T.grad_row_width(d) if work == "rows" else T.GEOM_GRADS
    ops = pairs * 30 + int(kept) * (per_pair + 30)
    nbytes = walked * 128 * (8 + d) * 4 + h * w * (d + 2) * 4 + 4 * plan.n_tiles \
        + plan.T_padded * width * 4
    t_b, t_o = 1e3 * nbytes / (PEAKS_H100["hbm_gbps"] * 1e9), \
        1e3 * ops / (PEAKS_H100["tflops_f32"] * 1e12)
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


def measure(runs: List[Tuple[str, Path]], iters: int = 3, inputs: str = "step",
            widest=(None,)) -> List[Tuple[str, str, float]]:
    """(kernel, variant, ms) of every variant of every (table, source) in
    ``runs`` on every work of the recorded ``inputs`` that the table takes,
    the colour table once for each ``widest`` slice (None:
    COLOUR_SLICE_CHANNELS); with the ``old`` table, its route on every
    ``rows`` work (``parent_route``); then the route (the tree's
    ``train_rows`` and ``train_geom_rows``) on each work, and each work's
    bound."""
    from tpugs_torch.raster import kernels as K
    from tpugs_torch.utils.timing import time_cuda

    build = Path(K.__file__).resolve().parents[2] / "build" / "train_bwd_phases"
    texts = {table: Path(source).read_text() for table, source in runs}
    libs = {table: {name: ctypes.CDLL(str(so)) for name, so in
                    build_variants(source, TABLES[table], build / table, VARIANTS).items()}
            for table, source in runs}
    absgrad = inputs in ("absgrad", "step1024")
    if inputs == "absgrad":
        works, image = absgrad_inputs()
    else:
        wide = {"step": (128, 512), "step512": (512, 512), "step1024": (1024, 1024)}[inputs]
        s = recorded_step(feature_dim=wide[0], teacher=wide[1], absgrad=absgrad)
        args = tuple(s[k] for k in (
            "geom", "cols", "g_image", "hterm", "grem0", "blocks_done", "plan"))
        works, image = {"rows": args}, s["image"]
        if inputs == "step1024":
            works["geometry"] = args
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    gen = torch.Generator(device="cuda").manual_seed(0)
    results = []
    for work, args in works.items():
        geom, cols, g, hterm, grem0, done, plan = args
        d, ts = cols.shape[1], plan.tile_size
        width = T.grad_row_width(d) if work == "rows" else T.GEOM_GRADS
        out = torch.zeros((plan.T_padded, width), dtype=torch.float32, device="cuda")
        ntx, _ = plan.grid
        tiles = torch.randperm(plan.n_tiles, device="cuda", generator=gen)[:64]
        rows_t, mags = T.train_rows_plain(*args, torch.float32, tiles, magnitudes=True,
                                          geometry_only=work == "geometry")
        count = (plan.tile_ends[tiles] - plan.tile_starts[tiles]).long()
        length = (count + K.BLOCK - 1) // K.BLOCK * K.BLOCK
        owner = torch.repeat_interleave(torch.arange(len(tiles), device="cuda"), length)
        first = torch.cumsum(length, 0) - length
        span = (plan.padded_starts[tiles].long()[owner] - first[owner]
                + torch.arange(int(length.sum()), device="cuda"))  # the tiles' padded rows
        d_err = d if work == "rows" else 0
        route = (lambda: T.train_rows(*args)) if work == "rows" else (
            lambda: T.train_geom_rows(*args))
        route_rows = route()

        def launcher(lib, table, ws):
            name, layout, _, takes_gsum = LAUNCH[table][work]
            if table == "old":  # its launch depends on the width and its source
                name, ws = name(d, texts[table]), texts[table]
            cluster = layout(ts, d, ws)
            rows_last = table in ("cluster", "colour", "geom")  # T_padded after the layout
            fn = getattr(lib, name)
            fn.argtypes = ([_P] * (11 if takes_gsum else 10) + [_I] * (7 + len(cluster))
                           + [ctypes.c_longlong] * rows_last + [_P])
            fn.restype = _I
            gsum = (torch.empty((plan.T_padded * cluster[2] * width,), device="cuda")
                    if takes_gsum and cluster[2] > 1 else None)
            extra = (None if gsum is None else K._ptr(gsum),) if takes_gsum else ()
            cluster = cluster + (plan.T_padded,) * rows_last

            def go():
                rc = fn(
                    K._ptr(geom), K._ptr(cols), K._ptr(g), K._ptr(hterm), K._ptr(grem0),
                    K._ptr(plan.tile_starts), K._ptr(plan.tile_ends),
                    K._ptr(plan.padded_starts), K._ptr(done), K._ptr(out), *extra,
                    plan.n_tiles, ntx, ts, plan.width, plan.height, d, width, *cluster, stream)
                if rc != 0:
                    raise RuntimeError(f"variant launch failed with CUDA error {rc}")
                return out
            return go

        for table, _ in runs:
            if work not in LAUNCH[table] or LAUNCH[table][work][1](
                    ts, d, texts[table] if table == "old" else None) is None:
                continue
            for ws in widest if table == "colour" else (None,):
                tag = f"{table}/{work}" + (f"/{ws or T.COLOUR_SLICE_CHANNELS}"
                                           if table == "colour" else "")
                launcher(libs[table]["full"], table, ws)()
                torch.cuda.synchronize()
                got = rows_t[span].clone()
                written = {"all": slice(0, width), "colour": slice(0, d),
                           "geometry": slice(d, width)}[LAUNCH[table][work][2]]
                got[:, written] = out[span][:, written]
                _, of_group, of_entry = T.grad_rows_error(got, rows_t[span], d_err, mags[span])
                group_tol, entry_tol = T.GRAD_ROWS_TOL[torch.float32]
                if not (of_group <= group_tol and of_entry <= entry_tol):
                    raise RuntimeError(f"{tag}: the full copy's rows differ from the twin "
                                       f"({of_group:.3e}, {of_entry:.3e})")
                if LAUNCH[table][work][2] == "all":
                    print(f"B5 {tag}: the full copy's rows bit-equal to the route's "
                          f"{torch.equal(out, route_rows)}", flush=True)
                for name in [name for name, _ in variants(TABLES[table], VARIANTS)] + ["full"]:
                    results.append((tag, name, time_cuda(
                        launcher(libs[table][name], table, ws), iters)))
        del route_rows
        if work == "rows" and "old" in libs:
            old = parent_route(libs["old"]["full"], texts["old"], args, image, absgrad, stream)
            results.append(("old/route", f"D={d} tile {ts}", time_cuda(old, iters)))
            del old
        results.append((f"route/{work}", f"D={d} tile {ts}", time_cuda(route, iters)))
        b = work_bound(args, work)
        results.append((f"bound/{work}", f"D={d} by {b[1]}", b[0]))
        del rows_t, mags, out
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    here = Path(__file__).resolve().parents[1] / "csrc" / "train_bwd.cu"
    ap.add_argument("--run", action="append", metavar="TABLE[=SOURCE]",
                    help="a kernel to take apart: its table and source (default the "
                         "tree's train_bwd.cu); repeatable")
    ap.add_argument("--inputs", choices=("step", "step512", "step1024", "absgrad"),
                    default="step",
                    help="the recorded train step (D = 131), the step at feature_dim 512, at "
                         "1024 with absgrad, or chip_smoke.py's phase 5 render at D = 515")
    ap.add_argument("--widest", action="append", type=int,
                    help="the colour table's widest slice (default COLOUR_SLICE_CHANNELS); "
                         "repeatable")
    ap.add_argument("--iters", type=int, default=3)
    a = ap.parse_args(argv)
    runs = []
    for r in a.run or ["cluster"]:
        table, _, src = r.partition("=")
        if table not in TABLES:
            raise SystemExit(f"unknown table {table!r}; known: {sorted(TABLES)}")
        runs.append((table, Path(src) if src else here))
    if not torch.cuda.is_available():
        raise SystemExit("train_bwd_phases needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"train_bwd phases of {runs} on {a.inputs} inputs, {smi}", flush=True)
    for kernel, name, ms in measure(runs, a.iters, a.inputs, tuple(a.widest or (None,))):
        print(f"B5 {kernel:18s} {name:18s} {ms:.3f} ms", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

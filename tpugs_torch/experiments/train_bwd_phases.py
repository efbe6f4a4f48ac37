"""Where does the train backward kernel's time go? Times B5
(``csrc/train_bwd.cu``) on the inputs of one recorded full-width train
step with each of its phases removed in turn.

The harness is ``adjoint_phases``'s: each variant is a copy of a B5
source with phases cut out by exact text substitutions (``TABLES``; a
pattern that is not found exactly once raises), compiled by ``nvcc`` into
its own library under ``build/train_bwd_phases/<table>/`` and launched
through its own ``tpugs_train_bwd_f32``. The phases:

  u product   the products u = g . colour (the walk reads u = 0)
  g staging   every copy of the image cotangent g into shared memory
              (the products read stale shared memory)
  walk        the per-pixel walk: w, d sigma and d op are constants (u
              is still consumed, so its product stays)
  geometry    the 8 geometry sums over pixels
  d col       the product d col = w^T g
  zero rows   the rows of the blocks past a tile's early exit
  colour staging  (cluster kernel) the sub-blocks' colour copies
  exchange    (cluster kernel) the DSMEM sums of the ranks' partial rows
  occupancy   (cluster kernel) not a phase: 114 KB more shared memory per
              CTA, so that only one fits on an SM

A variant's rows are wrong by design; only the full copy's rows are held
to the plain twin, on 64 sampled tiles, within ``GRAD_ROWS_TOL``. Table
``d4ac1ba`` is the one-CTA kernel of commit d4ac1ba; table ``cluster`` is
the resident-g cluster kernel that replaced it.

On the card::

    git show d4ac1ba:tpugs_torch/csrc/train_bwd.cu > build/train_bwd_d4ac1ba.cu
    python -m tpugs_torch.experiments.train_bwd_phases \\
        --run d4ac1ba=build/train_bwd_d4ac1ba.cu --run cluster

prints one line per kernel and variant: ms (CUDA events, mean of
``--iters`` launches), the full kernel timed first and last. The kernels
of one call share the recorded step and the card.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
from pathlib import Path
from typing import Dict, List, Tuple

import torch

from tpugs_torch.experiments.adjoint_phases import Sub, build_variants, variants

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

TABLES["cluster"] = {
    "u product": [("for (int k = 0; k < D4; k += 4) {", "for (int k = 0; k < 0; k += 4) {")],
    "g staging": [("    Gs[pl * ldg + c] = v;\n", "")],
    "colour staging": [("    cp_async4(Ct + i * L.ldg + e - i * D, src + e);\n", "")],
    "walk": [(_CLUSTER_WALK, _CLUSTER_CONST_WALK)],
    "geometry": [("if (__any_sync(0xffffffffu, any)) {", "if (false) {")],
    "d col": [("for (int q = q0; q < q0 + kPix / 2; ++q) {",
               "for (int q = q0; q < q0; ++q) {")],
    "zero rows": [("    *reinterpret_cast<uint4*>(out + zero0 + v * V) = make_uint4(0, 0, 0, 0);\n"
                   "  cluster_wait();", "  cluster_wait();")],
    "exchange": [("      sum_partials(out + (row0 + gbase) * RW, part, C, rank, RW, tid);\n", "")],
    "occupancy": [("*bytes = ClusterLayout(D, RW).bytes();",
                   "*bytes = ClusterLayout(D, RW).bytes() + 114 * 1024;")],
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
    ("one CTA per SM", ("occupancy",)),
    ("no products", ("u product", "d col")),
)

# Tables whose kernel takes the cluster geometry (C, P) after the row width.
CLUSTER_TABLES = ("cluster",)

_P, _I = ctypes.c_void_p, ctypes.c_int


def _load(so: Path, table: str) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(so))
    fn = lib.tpugs_train_bwd_f32
    fn.argtypes = [_P] * 10 + [_I] * 7 + ([_I, _I] if table in CLUSTER_TABLES else []) + [_P]
    fn.restype = _I
    return lib


def recorded_step(warmup: int = 3) -> dict:
    """B5's inputs and rows of one train step at ``chip_smoke.py``'s phase 4
    configuration (2^19 Gaussians, 1296 x 840, D = 131, tile 32, f32
    rows), caught by ``Trainer.record`` after ``warmup`` steps."""
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
    cfg = TrainConfig(max_steps=30_000, sh_degree=3, feature_dim=128, feature_out_dim=512,
                      strategy="none", random_bkgd=False, sh_degree_interval=1)
    tr = Trainer(cfg, init_scene_from_points(pts, rgbs, cfg), 1.0,
                 teacher=get_encoder("linear:512"), width=w, height=h, n_cameras=n_cams)
    staged = {"images": images, "viewmats": cams.viewmats, "Ks": cams.Ks}
    tr.train_chunk(staged, warmup, cam_idx[:warmup])
    tr.record = seen = {}
    tr.train_chunk(staged, 1, cam_idx[warmup:])
    tr.record = None
    torch.cuda.synchronize()
    return seen


def measure(runs: List[Tuple[str, Path]], iters: int = 3) -> List[Tuple[str, str, float]]:
    """(table, variant, ms) of every variant of every (table, source) in
    ``runs``, on one recorded step."""
    from tpugs_torch.raster import kernels as K
    from tpugs_torch.raster import train as T
    from tpugs_torch.utils.timing import time_cuda

    build = Path(K.__file__).resolve().parents[2] / "build" / "train_bwd_phases"
    libs = {table: {name: _load(so, table) for name, so in
                    build_variants(source, TABLES[table], build / table, VARIANTS).items()}
            for table, source in runs}
    s = recorded_step()
    geom, cols, plan, g, hterm, grem0, done = (s[k] for k in (
        "geom", "cols", "plan", "g_image", "hterm", "grem0", "blocks_done"))
    d = cols.shape[1]
    width = T.grad_row_width(d)
    out = torch.empty((plan.T_padded, width), dtype=torch.float32, device="cuda")
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    ntx, _ = plan.grid

    def launcher(lib, table):
        cluster = T.train_cluster(plan.tile_size, d) if table in CLUSTER_TABLES else ()

        def go():
            rc = lib.tpugs_train_bwd_f32(
                K._ptr(geom), K._ptr(cols), K._ptr(g), K._ptr(hterm), K._ptr(grem0),
                K._ptr(plan.tile_starts), K._ptr(plan.tile_ends), K._ptr(plan.padded_starts),
                K._ptr(done), K._ptr(out), plan.n_tiles, ntx, plan.tile_size, plan.width,
                plan.height, d, width, *cluster, stream)
            if rc != 0:
                raise RuntimeError(f"variant launch failed with CUDA error {rc}")
            return out
        return go

    gen = torch.Generator(device="cuda").manual_seed(0)
    tiles = torch.randperm(plan.n_tiles, device="cuda", generator=gen)[:64]
    rows_t, mags = T.train_rows_plain(geom, cols, g, hterm, grem0, done, plan, torch.float32,
                                      tiles, magnitudes=True)
    count = (plan.tile_ends[tiles] - plan.tile_starts[tiles]).long()
    length = (count + K.BLOCK - 1) // K.BLOCK * K.BLOCK
    owner = torch.repeat_interleave(torch.arange(len(tiles), device="cuda"), length)
    first = torch.cumsum(length, 0) - length
    span = (plan.padded_starts[tiles].long()[owner] - first[owner]
            + torch.arange(int(length.sum()), device="cuda"))  # the tiles' padded rows
    results = []
    for table, _ in runs:
        full = launcher(libs[table]["full"], table)()
        torch.cuda.synchronize()
        _, of_group, of_entry = T.grad_rows_error(full[span], rows_t[span], d, mags[span])
        group_tol, entry_tol = T.GRAD_ROWS_TOL[torch.float32]
        if not (of_group <= group_tol and of_entry <= entry_tol):
            raise RuntimeError(f"table {table}: the full copy's rows differ from the twin "
                               f"({of_group:.3e}, {of_entry:.3e})")
        for name in [name for name, _ in variants(TABLES[table], VARIANTS)] + ["full"]:
            results.append((table, name, time_cuda(launcher(libs[table][name], table), iters)))
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    here = Path(__file__).resolve().parents[1] / "csrc" / "train_bwd.cu"
    ap.add_argument("--run", action="append", metavar="TABLE[=SOURCE]",
                    help="a kernel to take apart: its table and source (default the "
                         "tree's train_bwd.cu); repeatable")
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
    print(f"train_bwd phases of {runs} on {smi}", flush=True)
    for table, name, ms in measure(runs, a.iters):
        print(f"B5 {table:8s} {name:18s} {ms:.3f} ms", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

"""Where does the train render kernel's time go? Times B4
(``csrc/train_fwd.cu``) on recorded inputs with each of its phases
removed in turn: ``--inputs step``, one full-width train step (D = 131,
tile 32, chip_smoke.py's phase 4), or ``--inputs viz``, the D = 512
feature image (chip_smoke.py's B4-viz: the canonical 2^19-Gaussian scene,
view 0 at 1296 x 840, tile 16, ``trans_eps`` 0, through
``rasterize_with_plan``; a seeded field of unit rows stands in for phase
7's LSeg field, which moves no time: the walk and the product do not
depend on the values).

The harness is ``adjoint_phases``'s: each variant is a copy of a B4
source with phases cut out by exact text substitutions (``TABLES``; a
pattern that is not found exactly once raises), compiled by ``nvcc`` into
its own library under ``build/train_fwd_phases/<table>/`` and launched
through its own ``tpugs_train_fwd`` on the step's packs. The phases of
table ``4d5fa2f`` (the one-CTA-per-channel-slice kernel of commit
4d5fa2f, whose grid is (tile, slice of 32 channels)):

  slices     every slice but the first: the grid is (tile, 1), so the
             weights are computed once per pair instead of ceil(D / 32)
             times (and only 32 channels are summed)
  product    the colour multiply-adds of every weighted pair
  staging    the block's colour copies into shared memory
  exit       the tile-wide exit barrier after each block (the exit is
             replayed from the recorded blocks_done)

and of table ``cluster`` (the thread-block cluster kernel that replaced
it):

  walk       the alpha evaluations: each alpha is a constant (the
             exchange of alphas, the sequential product and the stores
             stay; the exit is replayed from the recorded blocks_done)
  stores     the walk's stores of W (hi and lo) into shared memory, and
             the weights' products that only they read
  product    the 3xTF32 wgmma product
  staging    the colour loads and their hi/lo stores into shared memory
  split      the hi/lo split and stores alone (the loads stay)
  image      the image's stores to device memory (its staging in shared
             memory stays)
  exchange   the cluster-wide exit exchange (DSMEM marks and the cluster
             barrier per block; the exit is replayed)
  occupancy  not a phase: 114 KB more shared memory per CTA, so that
             only one fits on an SM
  skip       not a phase: a chunk's product is skipped where every weight
             of a warpgroup's 64 pixels is 0 (a pixel's 16 weights are 0
             where its transmittance did not move over the chunk, or was 0
             before it); the output stays exact

The cluster kernel cuts D into channel slices of at most
``SLICE_CHANNELS`` columns (``raster/train.py::fwd_slices``); each
``--widest`` (repeatable) times the cluster table's variants with slices
of at most that many columns.

A variant's output is wrong by design; only the full copy's image and
alpha are held to the plain twin, on 64 sampled tiles, within 1e-4, with
its exit blocks equal.

On the card::

    git show 4d5fa2f:tpugs_torch/csrc/train_fwd.cu > build/train_fwd_4d5fa2f.cu
    python -m tpugs_torch.experiments.train_fwd_phases \\
        --run 4d5fa2f=build/train_fwd_4d5fa2f.cu --run cluster
    python -m tpugs_torch.experiments.train_fwd_phases --inputs viz \\
        --widest 256 --widest 128 --variant full --variant "skip empty chunks"

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

from tpugs_torch.experiments.adjoint_phases import (
    _DONE_GLOBAL, Sub, build_variants, variants)

TABLES: Dict[str, Dict[str, List[Sub]]] = {
    "4d5fa2f": {
        "slices": [("  const dim3 grid(n_tiles, (D + tpugs::kSliceC - 1) / tpugs::kSliceC);",
                    "  const dim3 grid(n_tiles, 1);")],
        "product": [("      if (w != 0.0f) {", "      if (false) {")],
        "staging": [("      col[i][c] = c < nc ? cols[(row0 + i) * D + c0 + c] : 0.0f;\n", "")],
        "exit": [_DONE_GLOBAL,
                 ("    keep = __syncthreads_or(trans > trans_eps);",
                  "    keep = b + 1 < g_done[tile];")],
    },
}

TABLES["cluster"] = {
    "walk": [_DONE_GLOBAL,
             ("    mine[e] = pair_alpha(g, i, px, py, i < remaining);",
              "    mine[e] = 1e-3f * (i + 1);"),
             ("    const int any = __syncthreads_or(trans > trans_eps);",
              "    const int any = __syncthreads_or(b + 1 < g_done[tile]);")],
    "stores": [("    *reinterpret_cast<float4*>(Wh + o) = hi;\n"
                "    *reinterpret_cast<float4*>(Wl + o) =", "    if (false) *reinterpret_cast<float4*>(Wl + o) =")],
    "product": [("mma_chunk<NB>(acc, Wh, Wl, Ch, Cl, wg);", "(void)0;")],
    "split": [("      split_colours<N>(Ch, Cl, Raw + buf * kKC * N, ns, tid);\n", "")],
    "image": [("      for (int c = lane; c < ns; c += 32) o[c] = smem[p * LD + c];",
               "      (void)o;")],
    "staging": [("      split_colours<N>(Ch, Cl, Raw + buf * kKC * N, ns, tid);\n", ""),
                ("        stage_colours(Raw + (buf ^ 1) * kKC * N, cols, row0 + (j + 1) * kKC, D, c0, ns,"
                 " tid);", "        (void)0;")],
    "exchange": [_DONE_GLOBAL,
                 ("    if (any && tid < C) st_cluster(map_rank(smem_addr(&exit_mark[b & 1]), tid), b + 1);\n"
                  "    cluster_arrive();\n"
                  "    cluster_wait();\n"
                  "    keep = exit_mark[b & 1] == b + 1;",
                  "    keep = any >= 0 && b + 1 < g_done[tile];")],
    "occupancy": [("  *bytes = cluster_bytes(16 * NB);", "  *bytes = cluster_bytes(16 * NB) + 114 * 1024;")],
    "skip": [("  __shared__ int exit_mark[2];  // block b's mark, b + 1, in slot b % 2\n",
              "  __shared__ int exit_mark[2];  // block b's mark, b + 1, in slot b % 2\n"
              "  __shared__ int live[2][kThreads / 32];\n"),
             ("      walk_chunk(g, j * kKC, q, px, py, remaining, trans, texc, Wh, Wl, pl);\n",
              "      const float t0 = texc;\n"
              "      walk_chunk(g, j * kKC, q, px, py, remaining, trans, texc, Wh, Wl, pl);\n"
              "      {\n"
              "        const int any = __any_sync(0xffffffffu, texc != t0 && t0 * trans != 0.0f);\n"
              "        if (lane == 0) live[buf][warp] = any;\n"
              "      }\n"),
             ("mma_chunk<NB>(acc, Wh, Wl, Ch, Cl, wg);",
              "if (live[buf][4 * wg] | live[buf][4 * wg + 1] | live[buf][4 * wg + 2] |\n"
              "          live[buf][4 * wg + 3])\n"
              "        mma_chunk<NB>(acc, Wh, Wl, Ch, Cl, wg);")],
}

VARIANTS = (
    ("full", ()),
    ("one channel slice", ("slices",)),
    ("no product", ("product",)),
    ("no colour staging", ("staging",)),
    ("no exit barrier", ("exit",)),
    ("one slice without product", ("slices", "product")),
    ("no walk", ("walk",)),
    ("no weight stores", ("stores",)),
    ("no exit exchange", ("exchange",)),
    ("no colour split", ("split",)),
    ("no image stores", ("image",)),
    ("one CTA per SM", ("occupancy",)),
    ("walk only", ("product", "staging")),
    ("skip empty chunks", ("skip",)),
)

# Tables whose kernel takes the cluster geometry (C, P, S, Ns) after D and eps.
CLUSTER_TABLES = ("cluster",)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def _load(so: Path, table: str) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(so))
    fn = lib.tpugs_train_fwd
    cluster = [_I] * 4 if table in CLUSTER_TABLES else []
    fn.argtypes = [_P] * 8 + [_I] * 6 + [_F] + cluster + [_P]
    fn.restype = _I
    if hasattr(lib, "tpugs_diag_set_done"):
        lib.tpugs_diag_set_done.argtypes = [_P]
        lib.tpugs_diag_set_done.restype = _I
    return lib


def recorded_viz(d: int = 512) -> dict:
    """B4's inputs and outputs at chip_smoke.py's B4-viz: the D = ``d``
    feature image of view 0 of the canonical scene (2^19 Gaussians, 8 orbit
    views at 1296 x 840) through ``rasterize_with_plan`` (tile 16,
    ``trans_eps`` 0), with a seeded field of unit rows."""
    from tpugs_torch.raster.api import plan_render, rasterize_with_plan
    from tpugs_torch.utils.synthetic import orbit_cameras, random_scene

    scene = random_scene(2**19, seed=0, extent=1.0, scale_range=(0.004, 0.02), device="cuda")
    cams = orbit_cameras(8, 1296, 840, radius=3.0, device="cuda")
    field = torch.randn((scene.num_gaussians, d), device="cuda",
                        generator=torch.Generator(device="cuda").manual_seed(0))
    field = field / field.norm(dim=1, keepdim=True)
    vm, Km = cams.viewmats[0], cams.Ks[0]
    plan = plan_render(scene.means, scene.quats, scene.scales, scene.opacities, vm, Km,
                       cams.width, cams.height)
    seen = {}
    with torch.no_grad():
        rasterize_with_plan(scene.means, scene.quats, scene.scales, scene.opacities, field,
                            vm, Km, plan, record=seen)
    torch.cuda.synchronize()
    return seen


def measure(runs: List[Tuple[str, Path]], iters: int = 5, inputs: str = "step",
            widest=(None,), only=None) -> List[Tuple[str, str, float]]:
    """(table, variant, ms) of every variant (or those named in ``only``)
    of every (table, source) in ``runs`` on the recorded ``inputs``; the
    cluster table once for each ``widest`` slice (None: SLICE_CHANNELS),
    named ``cluster/<widest>``."""
    from tpugs_torch.experiments.train_bwd_phases import recorded_step
    from tpugs_torch.raster import kernels as K
    from tpugs_torch.raster import train as T
    from tpugs_torch.raster.tiles import image_to_tiles
    from tpugs_torch.utils.timing import time_cuda

    chosen = [v for v in VARIANTS if only is None or v[0] in only or v[0] == "full"]
    build = Path(K.__file__).resolve().parents[2] / "build" / "train_fwd_phases"
    libs = {table: {name: _load(so, table) for name, so in
                    build_variants(source, TABLES[table], build / table, chosen).items()}
            for table, source in runs}
    s = recorded_viz() if inputs == "viz" else recorded_step()
    geom, cols, plan, eps, done = (s[k] for k in (
        "geom", "cols", "plan", "trans_eps", "blocks_done"))
    d = cols.shape[1]
    h, w, ts = plan.height, plan.width, plan.tile_size
    img = torch.empty((h, w, d), dtype=torch.float32, device="cuda")
    alpha = torch.empty((h, w), dtype=torch.float32, device="cuda")
    out_done = torch.empty_like(done)
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    ntx, _ = plan.grid

    def launcher(lib, table, wide_slice=None):
        cluster = ()
        if table in CLUSTER_TABLES:
            cluster = T.train_fwd_cluster(ts, d)
            if wide_slice is not None:
                cluster = cluster[:2] + T.fwd_slices(d, wide_slice)

        def go():
            rc = lib.tpugs_train_fwd(
                K._ptr(geom), K._ptr(cols), K._ptr(plan.tile_starts), K._ptr(plan.tile_ends),
                K._ptr(plan.padded_starts), K._ptr(img), K._ptr(alpha), K._ptr(out_done),
                plan.n_tiles, ntx, ts, w, h, d, float(eps), *cluster, stream)
            if rc != 0:
                raise RuntimeError(f"variant launch failed with CUDA error {rc}")
            return img
        return go

    gen = torch.Generator(device="cuda").manual_seed(0)
    tiles = torch.randperm(plan.n_tiles, device="cuda", generator=gen)[:64]
    img_t, alpha_t, done_t = T.train_tiles_plain(geom, cols, plan, eps, tiles)
    inside = image_to_tiles(torch.ones((h, w, 1), device="cuda"), ts)[tiles] > 0
    results = []
    for table, _ in runs:
        cluster = table in CLUSTER_TABLES
        for ws in widest if cluster else (None,):
            tag = f"{table}/{ws or T.SLICE_CHANNELS}" if cluster else table
            launcher(libs[table]["full"], table, ws)()
            torch.cuda.synchronize()
            got = torch.where(inside, image_to_tiles(img, ts)[tiles], 0.0)
            ref = torch.where(inside, img_t, 0.0)
            err = float((got - ref).abs().max() / ref.abs().max())
            got_a = torch.where(inside[..., 0],
                                image_to_tiles(alpha[..., None], ts)[tiles][..., 0], 0.0)
            ref_a = torch.where(inside[..., 0], alpha_t, 0.0)
            err_a = float((got_a - ref_a).abs().max() / ref_a.abs().max())
            if not (err <= 1e-4 and err_a <= 1e-4 and torch.equal(out_done[tiles], done_t)):
                raise RuntimeError(f"table {tag}: the full copy differs from the twin "
                                   f"(image {err:.3e}, alpha {err_a:.3e})")
            for name in [name for name, _ in variants(TABLES[table], chosen)] + ["full"]:
                lib = libs[table][name]
                if hasattr(lib, "tpugs_diag_set_done") and lib.tpugs_diag_set_done(K._ptr(done)):
                    raise RuntimeError("setting the replayed exit failed")
                results.append((tag, name, time_cuda(launcher(lib, table, ws), iters)))
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    here = Path(__file__).resolve().parents[1] / "csrc" / "train_fwd.cu"
    ap.add_argument("--run", action="append", metavar="TABLE[=SOURCE]",
                    help="a kernel to take apart: its table and source (default the "
                         "tree's train_fwd.cu); repeatable")
    ap.add_argument("--inputs", choices=("step", "viz"), default="step",
                    help="the recorded train step (D = 131) or the B4-viz feature image "
                         "(D = 512)")
    ap.add_argument("--widest", action="append", type=int,
                    help="the cluster table's widest channel slice (default SLICE_CHANNELS); "
                         "repeatable")
    ap.add_argument("--variant", action="append",
                    help="time only these variants (and the full kernel); repeatable")
    ap.add_argument("--iters", type=int, default=5)
    a = ap.parse_args(argv)
    runs = []
    for r in a.run or ["cluster"]:
        table, _, src = r.partition("=")
        if table not in TABLES:
            raise SystemExit(f"unknown table {table!r}; known: {sorted(TABLES)}")
        runs.append((table, Path(src) if src else here))
    known = {name for name, _ in VARIANTS}
    if a.variant and not set(a.variant) <= known:
        raise SystemExit(f"unknown variant in {a.variant}; known: {sorted(known)}")
    if not torch.cuda.is_available():
        raise SystemExit("train_fwd_phases needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"train_fwd phases of {runs} on {a.inputs} inputs, {smi}", flush=True)
    for table, name, ms in measure(runs, a.iters, a.inputs, tuple(a.widest or (None,)),
                                   a.variant):
        print(f"B4 {table:12s} {name:22s} {ms:.3f} ms", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

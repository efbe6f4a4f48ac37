"""Where does the train render kernel's time go? Times B4
(``csrc/train_fwd.cu``) on the inputs of one recorded full-width train
step with each of its phases removed in turn.

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

A variant's output is wrong by design; only the full copy's image and
alpha are held to the plain twin, on 64 sampled tiles, within 1e-4, with
its exit blocks equal.

On the card::

    git show 4d5fa2f:tpugs_torch/csrc/train_fwd.cu > build/train_fwd_4d5fa2f.cu
    python -m tpugs_torch.experiments.train_fwd_phases \\
        --run 4d5fa2f=build/train_fwd_4d5fa2f.cu --run cluster

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
    "split": [("      split_colours<N>(Ch, Cl, Raw + buf * kKC * N, D, tid);\n", "")],
    "image": [("      for (int c = lane; c < D; c += 32) o[c] = smem[p * LD + c];",
               "      (void)o;")],
    "staging": [("      split_colours<N>(Ch, Cl, Raw + buf * kKC * N, D, tid);\n", ""),
                ("        stage_colours(Raw + (buf ^ 1) * kKC * N, cols, row0 + (j + 1) * kKC, D, tid);",
                 "        (void)0;")],
    "exchange": [_DONE_GLOBAL,
                 ("    if (any && tid < C) st_cluster(map_rank(smem_addr(&exit_mark[b & 1]), tid), b + 1);\n"
                  "    cluster_arrive();\n"
                  "    cluster_wait();\n"
                  "    keep = exit_mark[b & 1] == b + 1;",
                  "    keep = any >= 0 && b + 1 < g_done[tile];")],
    "occupancy": [("  *bytes = cluster_bytes(16 * NB);", "  *bytes = cluster_bytes(16 * NB) + 114 * 1024;")],
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
)

# Tables whose kernel takes the cluster geometry (C, P) after D and eps.
CLUSTER_TABLES = ("cluster",)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def _load(so: Path, table: str) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(so))
    fn = lib.tpugs_train_fwd
    cluster = [_I, _I] if table in CLUSTER_TABLES else []
    fn.argtypes = [_P] * 8 + [_I] * 6 + [_F] + cluster + [_P]
    fn.restype = _I
    if hasattr(lib, "tpugs_diag_set_done"):
        lib.tpugs_diag_set_done.argtypes = [_P]
        lib.tpugs_diag_set_done.restype = _I
    return lib


def measure(runs: List[Tuple[str, Path]], iters: int = 5) -> List[Tuple[str, str, float]]:
    """(table, variant, ms) of every variant of every (table, source) in
    ``runs``, on one recorded step."""
    from tpugs_torch.experiments.train_bwd_phases import recorded_step
    from tpugs_torch.raster import kernels as K
    from tpugs_torch.raster import train as T
    from tpugs_torch.raster.tiles import image_to_tiles
    from tpugs_torch.utils.timing import time_cuda

    build = Path(K.__file__).resolve().parents[2] / "build" / "train_fwd_phases"
    libs = {table: {name: _load(so, table) for name, so in
                    build_variants(source, TABLES[table], build / table, VARIANTS).items()}
            for table, source in runs}
    s = recorded_step()
    geom, cols, plan, eps, done = (s[k] for k in (
        "geom", "cols", "plan", "trans_eps", "blocks_done"))
    d = cols.shape[1]
    h, w, ts = plan.height, plan.width, plan.tile_size
    img = torch.empty((h, w, d), dtype=torch.float32, device="cuda")
    alpha = torch.empty((h, w), dtype=torch.float32, device="cuda")
    out_done = torch.empty_like(done)
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    ntx, _ = plan.grid

    def launcher(lib, table):
        cluster = T.train_fwd_cluster(ts, d) if table in CLUSTER_TABLES else ()

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
        launcher(libs[table]["full"], table)()
        torch.cuda.synchronize()
        got = torch.where(inside, image_to_tiles(img, ts)[tiles], 0.0)
        ref = torch.where(inside, img_t, 0.0)
        err = float((got - ref).abs().max() / ref.abs().max())
        got_a = torch.where(inside[..., 0], image_to_tiles(alpha[..., None], ts)[tiles][..., 0], 0.0)
        ref_a = torch.where(inside[..., 0], alpha_t, 0.0)
        err_a = float((got_a - ref_a).abs().max() / ref_a.abs().max())
        if not (err <= 1e-4 and err_a <= 1e-4 and torch.equal(out_done[tiles], done_t)):
            raise RuntimeError(f"table {table}: the full copy differs from the twin "
                               f"(image {err:.3e}, alpha {err_a:.3e})")
        for name in [name for name, _ in variants(TABLES[table], VARIANTS)] + ["full"]:
            lib = libs[table][name]
            if hasattr(lib, "tpugs_diag_set_done") and lib.tpugs_diag_set_done(K._ptr(done)):
                raise RuntimeError("setting the replayed exit failed")
            results.append((table, name, time_cuda(launcher(lib, table), iters)))
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    here = Path(__file__).resolve().parents[1] / "csrc" / "train_fwd.cu"
    ap.add_argument("--run", action="append", metavar="TABLE[=SOURCE]",
                    help="a kernel to take apart: its table and source (default the "
                         "tree's train_fwd.cu); repeatable")
    ap.add_argument("--iters", type=int, default=5)
    a = ap.parse_args(argv)
    runs = []
    for r in a.run or ["cluster"]:
        table, _, src = r.partition("=")
        if table not in TABLES:
            raise SystemExit(f"unknown table {table!r}; known: {sorted(TABLES)}")
        runs.append((table, Path(src) if src else here))
    if not torch.cuda.is_available():
        raise SystemExit("train_fwd_phases needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"train_fwd phases of {runs} on {smi}", flush=True)
    for table, name, ms in measure(runs, a.iters):
        print(f"B4 {table:8s} {name:22s} {ms:.3f} ms", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

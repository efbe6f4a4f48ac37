"""Where does the adjoint kernel's time go? Times B2 (``csrc/adjoint.cu``)
on the canonical view with each of its phases removed in turn.

Each variant is a copy of an adjoint source with one or more phases cut
out by exact text substitutions (``TABLES``; a pattern that is not found
exactly once raises), compiled by ``nvcc`` into its own library under
``build/adjoint_phases/`` and launched through its own
``tpugs_adjoint_bf16``/``tpugs_adjoint_scatter_bf16`` on the view's real
inputs. The phases:

  product    the tensor-core product C += w^T F
  walk       the per-pixel weight walk (W is a constant; the tile's exit
             is replayed from B1's blocks so the same blocks are walked)
  staging    the feature sub-chunk copies into shared memory
  zero rows  the rows of the blocks past a tile's early exit
  sharing    (cluster kernel) the DSMEM stores of the weights
  occupancy  (cluster kernel) not a phase: 114 KB more shared memory per
             CTA, so that only one fits on an SM

A variant's rows are wrong by design; only the full copy's rows are held
equal to the package's own B2 (that the harness calls it as the package
does). Table ``pr3`` is the kernel of commit 0c6aa0d (one CTA per channel
slice and tile); table ``cluster`` is the cluster kernel that replaced it.

On the card::

    git show 0c6aa0d:tpugs_torch/csrc/adjoint.cu > build/adjoint_pr3.cu
    python -m tpugs_torch.experiments.adjoint_phases --source build/adjoint_pr3.cu --table pr3
    python -m tpugs_torch.experiments.adjoint_phases            # the tree's kernel

prints one line per variant: ms (CUDA events, mean of ``--iters``
launches), and the full kernel timed first and last.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
from pathlib import Path
from typing import Dict, List, Tuple

import torch

Sub = Tuple[str, str]

_PR3_WALK = """        for (int i = 0; i < kBlock; ++i) {
          const float alpha = pair_alpha(g, i, px, py, i < remaining);
          const float w = alpha * texc * trans;
          texc *= 1.0f - alpha;
          Wt[i * L::LDA + tid] = from_f<T>(in_img ? w : 0.0f);
        }"""
_PR3_ZERO = """      for (int idx = tid; idx < kBlock * kSlice; idx += kThreads)
        out[out_row<kScatter>(dest, row0 + idx / kSlice) * DC + c0 + idx % kSlice] =
            from_f<T>(0.0f);
"""
# The blocks each tile walks, from B1, for variants without the walk.
_DONE_GLOBAL: Sub = ('#include "common.cuh"\n',
                     '#include "common.cuh"\n__device__ const int* g_done = nullptr;\n'
                     'extern "C" int tpugs_diag_set_done(const int* p) {\n'
                     '  return static_cast<int>(cudaMemcpyToSymbol(g_done, &p, sizeof(p)));\n}\n')

TABLES: Dict[str, Dict[str, List[Sub]]] = {
    "pr3": {
        "product": [("      prod.accumulate(Wt, Fs, tid);\n", "")],
        "walk": [
            _DONE_GLOBAL,
            (_PR3_WALK, "        for (int i = 0; i < kBlock; ++i)\n"
                        "          Wt[i * L::LDA + tid] = from_f<T>(in_img ? 1e-3f : 0.0f);"),
            ("    keep = __syncthreads_or(any);", "    keep = __syncthreads_or(b + 1 < g_done[tile]);"),
        ],
        "staging": [("      stage_features<T>(Fs, feats, static_cast<long long>(tile) * tspx + "
                     "sub * L::P, c0, D,\n                        vec_ok, tid);\n", "")],
        "zero rows": [(_PR3_ZERO, "")],
    },
    "cluster": {
        "product": [("        prod.accumulate(Ws, Fs, npix, tid);\n", "")],
        "walk": [
            _DONE_GLOBAL,
            ("      if (g0 + rank < n_groups)\n"
             "        walk_pixel<T>(g, Tpix, (g0 + rank) * L::P + pl, pl, rank, q, w_dst, q < n_dst,\n"
             "                      remaining, x0, y0, ts, width, height);\n", ""),
            ("if (__syncthreads_or(any) && tid < C)",
             "if (__syncthreads_or(b + 1 < g_done[tile]) && tid < C)"),
        ],
        "staging": [("      if (has_cols)\n"
                     "        stage_features<T, kGhost>(Fs, feats, static_cast<long long>(tile) * "
                     "tspx + g0 * L::P,\n                                  npix, tspx - g0 * L::P, "
                     "c0, D, vec_ok, tid);\n", "")],
        "zero rows": [("      if (has_cols) zero_rows<T, kScatter>(out, dest, row0, DC, c0, tid);\n",
                       "")],
        "sharing": [("    if (store) {", "    if (false) {")],
        "occupancy": [("  const size_t bytes = L::bytes(C);\n  cudaError_t e = cudaFuncSetAttribute(adjoint_kernel<T, kScatter, kGhost>,",
                       "  const size_t bytes = L::bytes(C) + 114 * 1024;\n  cudaError_t e = cudaFuncSetAttribute(adjoint_kernel<T, kScatter, kGhost>,")],
    },
}

VARIANTS = (
    ("full", ()),
    ("no product", ("product",)),
    ("no walk", ("walk",)),
    ("no staging", ("staging",)),
    ("no zero rows", ("zero rows",)),
    ("no DSMEM stores", ("sharing",)),
    ("one CTA per SM", ("occupancy",)),
    ("walk and stores", ("product", "staging", "zero rows")),
)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def variant_source(text: str, table: Dict[str, List[Sub]], phases) -> str:
    """``text`` with ``phases`` cut out."""
    for phase in phases:
        for old, new in table[phase]:
            n = text.count(old)
            if n != 1:
                raise ValueError(f"phase {phase!r}: pattern found {n} times, expected once:\n{old}")
            text = text.replace(old, new)
    return text


def variants(table: Dict[str, List[Sub]], variant_list=VARIANTS):
    """The variants of ``variant_list`` whose phases ``table`` knows."""
    return [(name, phases) for name, phases in variant_list
            if all(p in table for p in phases)]


def build_variants(source: Path, table: Dict[str, List[Sub]], out_dir: Path,
                   variant_list=VARIANTS) -> Dict[str, Path]:
    """Compile every variant of ``source`` (all nvcc processes at once);
    returns name -> library. ptxas' report goes to ``<library>.log``."""
    from tpugs_torch.kernels.build import CSRC_DIR, NVCC_FLAGS, nvcc_path

    out_dir.mkdir(parents=True, exist_ok=True)
    text = source.read_text()
    nvcc = nvcc_path()
    procs = {}
    for name, phases in variants(table, variant_list):
        stem = name.replace(" ", "_")
        cu = out_dir / f"{stem}.cu"
        cu.write_text(variant_source(text, table, phases))
        so = out_dir / f"{stem}.so"
        procs[name] = (so, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-shared", "-I", str(CSRC_DIR), str(cu), "-o",
             str(so)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, p) in procs.items():
        log, _ = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed on variant {name!r}:\n{log}")
        so.with_suffix(".log").write_text(log)
        libs[name] = so
    return libs


def _load(so: Path, table: str) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(so))
    cluster = [_I, _I] if table == "cluster" else []
    scratch = 1 if table == "cluster" else 0  # the tiles' T past tile 32 (null here)
    for fn, n_ptr in (("tpugs_adjoint_bf16", 6), ("tpugs_adjoint_scatter_bf16", 7)):
        getattr(lib, fn).argtypes = [_P] * (n_ptr + scratch) + [_I] * 7 + [_F] + cluster + [_P]
        getattr(lib, fn).restype = _I
    return lib


def canonical_views(tile: int = 32):
    """The canonical view (chip_smoke.py's phase 3 shape) at ``tile``,
    default and scatter plans."""
    from tpugs_torch.encoders.base import LinearRGBEncoder
    from tpugs_torch.lift.batch import run_view
    from tpugs_torch.utils.synthetic import orbit_cameras, random_scene

    w, h = 1296, 840
    scene = random_scene(2**19, seed=0, extent=1.0, scale_range=(0.004, 0.02), device="cuda")
    cams = orbit_cameras(8, w, h, radius=3.0, device="cuda")
    enc = LinearRGBEncoder(512, device="cuda")
    args = (scene, cams.viewmats[0], cams.Ks[0], w, h, enc, tile)
    return run_view(*args), run_view(*args, reduce_engine="scatter")


def measure(source: Path, table: str, iters: int = 5) -> List[Tuple[str, str, float]]:
    """(kernel, variant, ms) for B2 and B6 of every variant."""
    from tpugs_torch.raster import kernels as K
    from tpugs_torch.utils.timing import time_cuda

    libs = {name: _load(so, table) for name, so in
            build_variants(source, TABLES[table], Path(K.__file__).resolve().parents[2]
                           / "build" / "adjoint_phases").items()}
    r, r_s = canonical_views()
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)

    def launcher(lib, plan, scatter):
        out = torch.empty((plan.R_striped + 1 if scatter else plan.T_padded,
                           K.contrib_width(r.feat_tiles.shape[-1])),
                          dtype=torch.bfloat16, device="cuda")
        fn = lib.tpugs_adjoint_scatter_bf16 if scatter else lib.tpugs_adjoint_bf16
        extra = (K._ptr(plan.slot_pos),) if scatter else ()
        cluster = K.adjoint_cluster(out.shape[1]) if table == "cluster" else ()
        scratch = (ctypes.c_void_p(None),) if table == "cluster" else ()
        ntx, _ = plan.grid

        def go():
            rc = fn(K._ptr(r.packed), K._ptr(plan.tile_starts), K._ptr(plan.tile_ends),
                    K._ptr(plan.padded_starts), K._ptr(r.feat_tiles), *extra, K._ptr(out),
                    *scratch, plan.n_tiles, ntx, plan.tile_size, plan.width, plan.height,
                    r.feat_tiles.shape[-1], out.shape[1], K.TRANS_EPS, *cluster, stream)
            if rc != 0:
                raise RuntimeError(f"variant launch failed with CUDA error {rc}")
            return out
        return go

    full = launcher(libs["full"], r.plan, False)()
    torch.cuda.synchronize()
    if not torch.equal(full, K.adjoint_rows(r.packed, r.feat_tiles, r.plan)):
        raise RuntimeError("the full copy's rows differ from the package's B2")
    done = r.blocks_done.to(torch.int32).contiguous()
    results = []
    order = [name for name, _ in variants(TABLES[table])] + ["full"]
    for name in order:
        lib = libs[name]
        if hasattr(lib, "tpugs_diag_set_done"):
            lib.tpugs_diag_set_done.argtypes = [_P]
            if lib.tpugs_diag_set_done(K._ptr(done)) != 0:
                raise RuntimeError("setting the replayed exit failed")
        results.append(("B2", name, time_cuda(launcher(lib, r.plan, False), iters)))
    for name in ("full", "no zero rows", "full"):
        results.append(("B6", name, time_cuda(launcher(libs[name], r_s.plan, True), iters)))
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    here = Path(__file__).resolve().parents[1] / "csrc" / "adjoint.cu"
    ap.add_argument("--source", type=Path, default=here)
    ap.add_argument("--table", choices=sorted(TABLES), default="cluster")
    ap.add_argument("--iters", type=int, default=5)
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("adjoint_phases needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"adjoint phases of {a.source} (table {a.table}) on {smi}", flush=True)
    for kernel, name, ms in measure(a.source, a.table, a.iters):
        print(f"{kernel} {name:14s} {ms:.3f} ms", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

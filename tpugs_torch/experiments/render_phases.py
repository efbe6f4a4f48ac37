"""Where does the render kernel's time go? Times B1 (``csrc/render.cu``)
on one recorded canonical lift view with each of its phases removed in
turn, and with its tiles split or reordered.

The harness is ``adjoint_phases``'s: each variant is a copy of a B1
source with phases cut out by exact text substitutions (``TABLES``; a
pattern that is not found exactly once raises), compiled by ``nvcc`` into
its own library under ``build/render_phases/<table>/`` and launched
through its own ``tpugs_render`` on the view's pack and plan. Every copy
gets two device arrays set before each launch: ``g_done``, the recorded
blocks each tile walked, and ``g_order``, the tiles by descending
``g_done``. The phases of table ``55f8844`` (the one-CTA-per-tile kernel
of commit 55f8844):

  heavy      only the tiles that walk at least ``HEAVY_BLOCKS`` blocks
             (the other CTAs return at once)
  light      only the other tiles
  order      every tile, heaviest first: CTA k takes tile g_order[k]
  walk       the alpha of every pair is a constant (the staging, the
             compositing and the barriers stay; the exit is replayed
             from g_done)
  loads      each pair reads one float of shared memory instead of ten
             (the other nine are constants; the exit is replayed)
  staging    the block's copy from device to shared memory (the walk
             reads stale shared memory; the exit is replayed)
  exit       the tile-wide vote: a plain barrier, the exit replayed

and of table ``cluster`` (the thread-block cluster kernel with per-warp
live masks that replaced it):

  heavy, light, order, walk   as above
  staging    the prefetch of every block after the first: each block
             walks the first block's rows (the exit is replayed)
  masks      the live-mask tests: each warp walks every Gaussian inside
             the span (the ballots stay)
  nowalk     the walk of the live Gaussians (the tests and ballots stay;
             the exit is replayed)
  exchange   the cluster-wide exit exchange (DSMEM marks and the cluster
             barrier per block; the exit is replayed)
  ilp1, ilp2, ilp8   not phases: the alphas of 1, 2 or 8 live pairs
             evaluated together instead of 4
  four CTAs, five CTAs   not phases: launch bounds for four or five
             resident CTAs per SM instead of six

and a row of its full copy launched without the cull.

A variant's output is wrong by design. The full copy of every table must
give the package's ``render_tiles`` image and ``blocks_done`` bit for bit
on the recorded view: for table ``55f8844`` that holds the tree's kernel
to its parent's. Each copy also reports its kernels' registers
(``cudaFuncGetAttributes``) and resident CTAs per SM
(``cudaOccupancyMaxActiveBlocksPerMultiprocessor``).

On the card::

    git show 55f8844:tpugs_torch/csrc/render.cu > build/render_55f8844.cu
    python -m tpugs_torch.experiments.render_phases \\
        --run 55f8844=build/render_55f8844.cu --run cluster

prints one line per kernel and variant: ms (CUDA events, mean of
``--iters`` launches), the full kernel timed first and last. The kernels
of one call share the recorded view and the card.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
from pathlib import Path
from typing import Dict, List, Tuple

import torch

from tpugs_torch.experiments.adjoint_phases import Sub, build_variants, variants

HEAVY_BLOCKS = 8  # a tile that walks at least this many blocks is heavy

# Device arrays of the recorded walk, put into every copy.
PRELUDE = """__device__ const int* g_done = nullptr;
__device__ const int* g_order = nullptr;
extern "C" int tpugs_diag_set(const int* done, const int* order) {
  cudaError_t e = cudaMemcpyToSymbol(g_done, &done, sizeof(done));
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(g_order, &order, sizeof(order));
  return static_cast<int>(e);
}
"""
_INCLUDE = '#include "common.cuh"\n'

# Registers and resident CTAs per SM of each table's kernels, appended to
# every copy: tpugs_diag_attrs(k, out) writes (registers, CTAs per SM) of
# kernel k into out and returns 0, or a CUDA error.
EPILOGUES = {
    "55f8844": """
extern "C" int tpugs_diag_attrs(int k, int* out) {
  if (k != 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaFuncAttributes a;
  cudaError_t e = cudaFuncGetAttributes(&a, tpugs::render_kernel);
  if (e != cudaSuccess) return static_cast<int>(e);
  out[0] = a.numRegs;
  return static_cast<int>(
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(out + 1, tpugs::render_kernel, 1024, 0));
}
""",
    "cluster": """
template <typename F>
static int diag_attrs(F kernel, int* out) {
  cudaFuncAttributes a;
  cudaError_t e = cudaFuncGetAttributes(&a, kernel);
  if (e != cudaSuccess) return static_cast<int>(e);
  out[0] = a.numRegs;
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      out + 1, kernel, tpugs::kThreads, 0));
}
extern "C" int tpugs_diag_attrs(int k, int* out) {
  if (k == 0) return diag_attrs(tpugs::render_kernel<true>, out);
  if (k == 1) return diag_attrs(tpugs::render_kernel<false>, out);
  return static_cast<int>(cudaErrorInvalidValue);
}
""",
}
KERNEL_NAMES = {"55f8844": ("render_kernel",),
                "cluster": ("render_kernel<cull>", "render_kernel<no cull>")}

_55_EXIT = "    keep = __syncthreads_or(trans > trans_eps);"
_55_REPLAY: Sub = (_55_EXIT, "    keep = __syncthreads_or(b + 1 < g_done[tile]);")
_55_TILE = "  const int tile = blockIdx.x;\n"

TABLES: Dict[str, Dict[str, List[Sub]]] = {
    "55f8844": {
        "heavy": [(_55_TILE, _55_TILE + f"  if (g_done[tile] < {HEAVY_BLOCKS}) return;\n")],
        "light": [(_55_TILE, _55_TILE + f"  if (g_done[tile] >= {HEAVY_BLOCKS}) return;\n")],
        "order": [(_55_TILE, "  const int tile = g_order[blockIdx.x];\n")],
        "walk": [("      const float alpha = pair_alpha(g, i, px, py, i < remaining);",
                  "      const float alpha = i < remaining ? 1e-3f : 0.0f;"), _55_REPLAY],
        "loads": [("      const float alpha = pair_alpha(g, i, px, py, i < remaining);",
                   "      const float m = g.mx[i];\n"
                   "      const float alpha = clipped_alpha(pair_terms_one(m, px, py), "
                   "i < remaining);"),
                  ("      for (int c = 0; c < 4; ++c) acc[c] += w * col[c][i];",
                   "      for (int c = 0; c < 4; ++c) acc[c] += w * (m + c);"),
                  _55_REPLAY],
        "staging": [("    load_geom(g, pack, row0, p);\n    if (p < kBlock) {",
                     "    if (false) {"), _55_REPLAY],
        "exit": [(_55_EXIT, "    __syncthreads();\n    keep = b + 1 < g_done[tile];")],
    },
}

_CL_TILE = "  const int tile = blockIdx.x / C;\n"
_CL_REPLAY: Sub = ("    const int any = __syncthreads_or(trans > trans_eps);",
                   "    const int any = __syncthreads_or(b + 1 < g_done[tile]);")
TABLES["cluster"] = {
    "heavy": [(_CL_TILE, _CL_TILE + f"  if (g_done[tile] < {HEAVY_BLOCKS}) return;\n")],
    "light": [(_CL_TILE, _CL_TILE + f"  if (g_done[tile] >= {HEAVY_BLOCKS}) return;\n")],
    "order": [(_CL_TILE, "  const int tile = g_order[blockIdx.x / C];\n")],
    "walk": [("          alpha[u] = clipped_alpha(pair_terms(g0.x, g0.y, g0.z, g0.w, g1.x, "
              "g1.y, px, py),\n                                   kCull || i < remaining);",
              "          alpha[u] = kCull || i < remaining ? 1e-3f : 0.0f;"), _CL_REPLAY],
    "staging": [("    if (b + 1 < nb_walk) stage_rows(rows[(b + 1) & 1], pack, pstart + (b + 1) * "
                 "kBlock, tid);\n", ""),
                ("    const StagedRow* r = rows[b & 1];", "    const StagedRow* r = rows[0];"),
                _CL_REPLAY],
    "masks": [("rect_dead(r[j], cst[j], x0, y0)", "false")],
    "nowalk": [("      for (unsigned m = live[k]; m != 0;) {",
                "      for (unsigned m = live[k] & (g_done[tile] < 0 ? ~0u : 0u); m != 0;) {"),
               _CL_REPLAY],
    "exchange": [("      cluster_wait();\n      pending = false;\n"
                  "      if (b > 0 && exit_mark[(b - 1) & 1] != b) break;",
                  "      if (b == 0) {\n        cluster_wait();\n        pending = false;\n      }\n"
                  "      if (b > 0 && b >= g_done[tile]) break;"),
                 ("      if (any && tid < C) st_cluster(map_rank(smem_addr(&exit_mark[(b - 1) & 1]), "
                  "tid), b);\n      cluster_arrive();\n      pending = true;",
                  "      (void)any;")],
    "ilp1": [("constexpr int kIlp = 4;", "constexpr int kIlp = 1;")],
    "ilp2": [("constexpr int kIlp = 4;", "constexpr int kIlp = 2;")],
    "ilp8": [("constexpr int kIlp = 4;", "constexpr int kIlp = 8;")],
    "four CTAs": [("__launch_bounds__(kThreads, 6)", "__launch_bounds__(kThreads, 4)")],
    "five CTAs": [("__launch_bounds__(kThreads, 6)", "__launch_bounds__(kThreads, 5)")],
}

# One shared load per pair: pair_terms with the other five geometry values
# constants (the same _rn operations, so the same arithmetic per pair).
_ONE_LOAD = """__device__ __forceinline__ tpugs::PairTerms pair_terms_one(float m, float px, float py) {
  tpugs::PairTerms t;
  t.dx = __fsub_rn(px, m);
  t.dy = __fsub_rn(py, m);
  const float quad = __fadd_rn(__fmul_rn(__fmul_rn(0.02f, t.dx), t.dx),
                               __fmul_rn(__fmul_rn(0.03f, t.dy), t.dy));
  t.sigma = __fadd_rn(__fmul_rn(0.5f, quad), __fmul_rn(__fmul_rn(0.001f, t.dx), t.dy));
  t.e = expf(-fmaxf(t.sigma, 0.0f));
  t.alpha_raw = __fmul_rn(0.5f, t.e);
  return t;
}
"""

VARIANTS = (
    ("full", ()),
    ("heavy tiles only", ("heavy",)),
    ("light tiles only", ("light",)),
    ("heaviest first", ("order",)),
    ("constant alpha", ("walk",)),
    ("one shared load per pair", ("loads",)),
    ("no staging", ("staging",)),
    ("no exit vote", ("exit",)),
    ("no mask tests", ("masks",)),
    ("masks but no walk", ("nowalk",)),
    ("neither tests nor walk", ("masks", "nowalk")),
    ("no exit exchange", ("exchange",)),
    ("one alpha at a time", ("ilp1",)),
    ("two alphas at a time", ("ilp2",)),
    ("eight alphas at a time", ("ilp8",)),
    ("four CTAs per SM", ("four CTAs",)),
    ("five CTAs per SM", ("five CTAs",)),
)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def copy_source(text: str, table: str) -> str:
    """``text`` with the prelude after its first include of common.cuh
    (and, for table 55f8844, the one-load helper) and the table's
    epilogue at its end."""
    if text.count(_INCLUDE) != 1:
        raise ValueError("the source must include common.cuh exactly once")
    extra = PRELUDE + (_ONE_LOAD if table == "55f8844" else "")
    return text.replace(_INCLUDE, _INCLUDE + extra) + EPILOGUES[table]


def _load(so: Path, table: str) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(so))
    fn = lib.tpugs_render
    if table == "55f8844":
        # pack, starts, ends, padded_starts, out, blocks_done, n_tiles, ntx, ts, eps, stream
        fn.argtypes = [_P] * 6 + [_I] * 3 + [_F, _P]
    else:
        from tpugs_torch.kernels.build import SIGNATURES

        fn.argtypes = SIGNATURES["tpugs_render"]
    fn.restype = _I
    lib.tpugs_diag_set.argtypes = [_P, _P]
    lib.tpugs_diag_set.restype = _I
    lib.tpugs_diag_attrs.argtypes = [_I, _P]
    lib.tpugs_diag_attrs.restype = _I
    return lib


def recorded_view():
    """The canonical lift view (``chip_smoke.py``'s phase 3 shape): view 0
    through ``run_view`` after one warm-up view."""
    from tpugs_torch.encoders.base import LinearRGBEncoder
    from tpugs_torch.lift.batch import run_view
    from tpugs_torch.utils.synthetic import orbit_cameras, random_scene

    w, h = 1296, 840
    scene = random_scene(2**19, seed=0, extent=1.0, scale_range=(0.004, 0.02), device="cuda")
    cams = orbit_cameras(8, w, h, radius=3.0, device="cuda")
    enc = LinearRGBEncoder(512, device="cuda")
    args = (scene, cams.viewmats[0], cams.Ks[0], w, h, enc, 32)
    run_view(*args)
    r = run_view(*args)
    torch.cuda.synchronize()
    return r


def attrs(lib: ctypes.CDLL, table: str) -> List[Tuple[str, int, int]]:
    """(kernel, registers, resident CTAs per SM) of a copy's kernels."""
    out = []
    for k, name in enumerate(KERNEL_NAMES[table]):
        buf = (ctypes.c_int * 2)()
        rc = lib.tpugs_diag_attrs(k, ctypes.cast(buf, ctypes.c_void_p))
        if rc != 0:
            raise RuntimeError(f"cudaFuncGetAttributes of {name} failed with CUDA error {rc}")
        out.append((name, buf[0], buf[1]))
    return out


def measure(runs: List[Tuple[str, Path]], iters: int = 20):
    """(table, variant, ms) of every variant of every (table, source) in
    ``runs`` on one recorded view, and (table, kernel, registers, CTAs per
    SM) of each table's full copy."""
    from tpugs_torch.raster import kernels as K
    from tpugs_torch.utils.timing import time_cuda

    build = Path(K.__file__).resolve().parents[2] / "build" / "render_phases"
    libs = {}
    for table, source in runs:
        src = build / table / "source.cu"
        src.parent.mkdir(parents=True, exist_ok=True)
        src.write_text(copy_source(source.read_text(), table))
        libs[table] = {name: _load(so, table) for name, so in
                       build_variants(src, TABLES[table], build / table, VARIANTS).items()}
    r = recorded_view()
    plan, pack = r.plan, r.packed
    ref_img, ref_done = K.render_tiles(pack, plan)
    torch.cuda.synchronize()
    done = ref_done.to(torch.int32).contiguous()
    order = torch.argsort(done, descending=True, stable=True).to(torch.int32)
    nt, ntx, ts = plan.n_tiles, plan.grid[0], plan.tile_size
    heavy = done >= HEAVY_BLOCKS
    print(f"recorded view: {nt} tiles, {int(done.sum())} blocks walked, "
          f"{int((done == 0).sum())} tiles walk none, {int(heavy.sum())} walk >= "
          f"{HEAVY_BLOCKS} ({int(done[heavy].sum())} blocks), max {int(done.max())}",
          flush=True)
    out = torch.empty_like(ref_img)
    out_done = torch.empty_like(done)
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)

    def launcher(lib, table, cull=True):
        def go():
            if table != "55f8844":
                K.launch_render(lib, pack, plan, K.TRANS_EPS, cull, out, out_done)
                return out
            rc = lib.tpugs_render(
                K._ptr(pack), K._ptr(plan.tile_starts), K._ptr(plan.tile_ends),
                K._ptr(plan.padded_starts), K._ptr(out), K._ptr(out_done), nt, ntx, ts,
                float(K.TRANS_EPS), stream)
            if rc != 0:
                raise RuntimeError(f"variant launch failed with CUDA error {rc}")
            return out
        return go

    results, registers = [], []
    for table, _ in runs:
        full = libs[table]["full"]
        launcher(full, table)()
        torch.cuda.synchronize()
        if not (torch.equal(out, ref_img) and torch.equal(out_done, done)):
            raise RuntimeError(f"table {table}: the full copy's image or blocks_done differ "
                               "from the package's render_tiles")
        registers += [(table, *a) for a in attrs(full, table)]
        for name in [name for name, _ in variants(TABLES[table], VARIANTS)] + ["full"]:
            lib = libs[table][name]
            if lib.tpugs_diag_set(K._ptr(done), K._ptr(order)) != 0:
                raise RuntimeError("setting the recorded walk failed")
            results.append((table, name, time_cuda(launcher(lib, table), iters)))
        if table == "cluster":  # the unculled instantiation, held bit-equal
            go = launcher(full, table, cull=False)
            go()
            torch.cuda.synchronize()
            if not (torch.equal(out, ref_img) and torch.equal(out_done, done)):
                raise RuntimeError("the unculled instantiation's image or blocks_done differ")
            results.append((table, "full, no cull", time_cuda(go, iters)))
            results.append((table, "full", time_cuda(launcher(full, table), iters)))
    return results, registers


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    here = Path(__file__).resolve().parents[1] / "csrc" / "render.cu"
    ap.add_argument("--run", action="append", metavar="TABLE[=SOURCE]",
                    help="a kernel to take apart: its table and source (default the "
                         "tree's render.cu); repeatable")
    ap.add_argument("--iters", type=int, default=20)
    a = ap.parse_args(argv)
    runs = []
    for r in a.run or ["cluster"]:
        table, _, src = r.partition("=")
        if table not in TABLES:
            raise SystemExit(f"unknown table {table!r}; known: {sorted(TABLES)}")
        runs.append((table, Path(src) if src else here))
    if not torch.cuda.is_available():
        raise SystemExit("render_phases needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"render phases of {runs} on {smi}", flush=True)
    results, registers = measure(runs, a.iters)
    for table, kernel, regs, ctas in registers:
        print(f"B1 {table:8s} {kernel}: {regs} registers, {ctas} resident CTAs per SM",
              flush=True)
    for table, name, ms in results:
        print(f"B1 {table:8s} {name:26s} {ms:.4f} ms", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

"""Are the kernels at tiles 16 and 32 bit-equal to another commit's? Builds
that commit's ``csrc`` into a library of its own and launches both
libraries, through the package's own wrappers, on the same inputs: B1
(culled and not), B2 and B6 in f32 and bf16 (one cluster, and several
clusters a tile), B4's cluster kernel and its wide kernel, B5's cluster
kernel, its colour slices plus geometry kernel, and its geometry rows at
widths of one and of several pixel groups. Every output must be equal bit
for bit; the first difference raises. With ``--time``, B1, B2 (bf16 rows)
and B5 (f32 rows, D = 131) at tile 32 on the canonical lift view (N =
2^19, 1296 x 840, D = 512) are timed by CUDA events, the parent's and the
tree's kernels in turns (parent, tree, tree, parent).

On the card, with the parent's sources unpacked beside the tree::

    git archive <commit> tpugs_torch/csrc | tar -x -C build/parent
    python -m tpugs_torch.experiments.tile_parity --parent build/parent/tpugs_torch/csrc

prints one line per kernel and shape, then the card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
from pathlib import Path

import torch

W, H, N = 300, 200, 20000
ADJOINT_D = (64, 600)  # one cluster of 1 CTA, and clusters of 5 CTAs
TRAIN_D = (131, 515)  # B5's cluster kernel; its colour slices plus geometry kernel
GEOM_D = (515, 1030, 2051)  # geometry rows: G = 1, 2 and 4 pixel groups at tile 32


def load(so: Path) -> ctypes.CDLL:
    from tpugs_torch.kernels.build import SIGNATURES

    lib = ctypes.CDLL(str(so))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def cases(ts: int):
    """(name, call) of every kernel at tile ``ts`` on one seeded view; each
    call returns the kernel's outputs as a tuple of tensors."""
    from tpugs_torch.encoders.base import LinearRGBEncoder
    from tpugs_torch.kernels.build import load_library
    from tpugs_torch.raster import kernels as K
    from tpugs_torch.raster import train as T
    from tpugs_torch.raster.colors import prepare_colors
    from tpugs_torch.raster.pack import pack_isect_all
    from tpugs_torch.raster.plan import build_plan, with_scatter_extras
    from tpugs_torch.raster.projection import project
    from tpugs_torch.utils.synthetic import orbit_cameras, random_scene

    scene = random_scene(N, seed=1, extent=0.6, scale_range=(0.01, 0.12), device="cuda")
    cams = orbit_cameras(1, W, H, radius=3.0, device="cuda")
    vm, Km = cams.viewmats[0], cams.Ks[0]
    proj = project(scene.means, scene.quats, scene.scales, scene.opacities, vm, Km, W, H)
    plan = build_plan(proj, W, H, ts)
    splan = with_scatter_extras(plan)
    packed = pack_isect_all(proj, prepare_colors(scene.means, scene.colors_all, vm,
                                                 scene.sh_degree), plan)
    img, _ = K.render_tiles(packed, plan)
    live = splan.slot_pos.long()[splan.gauss_pos.long()]  # B6 leaves the other rows unwritten
    out = [("B1", lambda: K.render_tiles(packed, plan)),
           ("B1 unculled", lambda: K.render_tiles_unculled(packed, plan))]
    for d in ADJOINT_D:
        feats = LinearRGBEncoder(d, seed=3, device="cuda")(img[..., :3]).contiguous()
        for dtype in (torch.float32, torch.bfloat16):
            f = feats.to(dtype)
            out.append((f"B2 D={d} {dtype}", lambda f=f: (K.adjoint_rows(packed, f, plan),)))
            out.append((f"B6 D={d} {dtype}",
                        lambda f=f: (K.adjoint_scatter_rows(packed, f, splan)[live],)))
    gen = torch.Generator(device="cuda").manual_seed(5)
    opac = torch.where(proj.valid, proj.opacities, torch.zeros_like(proj.opacities))
    for d in sorted(set(TRAIN_D + GEOM_D)):
        colors = torch.rand((N, d), device="cuda", generator=gen)
        geom, cols = T.pack_train(proj.means2d, proj.conics, opac, colors, plan)
        image, alpha, done = T.train_forward(geom, cols, plan)
        g = torch.randn((H, W, d), device="cuda", generator=gen)
        hterm = torch.randn((H, W), device="cuda", generator=gen) * (1.0 - alpha)
        args = (geom, cols, g, hterm, (g * image).sum(-1), done, plan)
        if d in TRAIN_D:
            out.append((f"B4 D={d}",
                        lambda geom=geom, cols=cols: T.train_forward(geom, cols, plan)))
            out.append((f"B4 wide D={d}", lambda geom=geom, cols=cols: T._launch_train_fwd(
                load_library(), geom, cols, plan, K.TRANS_EPS, None)))
            for dtype in (torch.float32, torch.bfloat16):
                out.append((f"B5 D={d} {dtype}",
                            lambda args=args, dtype=dtype: (T.train_rows(*args, dtype),)))
        if d in GEOM_D:
            out.append((f"B5 geometry rows D={d} {T.geom_cluster(ts, d)}",
                        lambda args=args: (T.train_geom_rows(*args),)))
    return out


def compare(parent: ctypes.CDLL) -> int:
    """Runs every case with the tree's library and with ``parent``; prints
    one line each and returns the number of cases."""
    from tpugs_torch.kernels import build

    own = build.load_library
    n = 0
    for ts in (16, 32):
        for name, call in cases(ts):
            mine = call()
            build.load_library = lambda: parent
            try:
                theirs = call()
            finally:
                build.load_library = own
            torch.cuda.synchronize()
            same = all(torch.equal(a, b) for a, b in zip(mine, theirs))
            print(f"tile {ts} {name}: bit-equal to the parent's {same}", flush=True)
            if not same:
                raise RuntimeError(f"tile {ts} {name} differs from the parent's kernel")
            n += 1
    return n


def timed(parent: ctypes.CDLL, iters: int = 10) -> None:
    """B1, B2 and B5 on the canonical view at tile 32: ms of the parent's
    and the tree's kernels in turns."""
    from tpugs_torch.experiments.adjoint_phases import canonical_views
    from tpugs_torch.kernels import build
    from tpugs_torch.raster import kernels as K
    from tpugs_torch.raster import train as T
    from tpugs_torch.utils.timing import time_cuda

    r, _ = canonical_views()
    plan = r.plan
    gen = torch.Generator(device="cuda").manual_seed(5)
    d = 131
    geom = r.packed[:, :T.GEOM_COLS].contiguous()
    cols = torch.rand((plan.T_padded, d), device="cuda", generator=gen)
    _, alpha, done = T.train_forward(geom, cols, plan)
    g = torch.randn((plan.height, plan.width, d), device="cuda", generator=gen)
    hterm = torch.randn((plan.height, plan.width), device="cuda", generator=gen) * (1.0 - alpha)
    args = (geom, cols, g, hterm, hterm, done, plan)
    kernels = {"B1": lambda: K.render_tiles(r.packed, plan),
               "B2 bf16": lambda: K.adjoint_rows(r.packed, r.feat_tiles, plan),
               "B5 f32 D=131": lambda: T.train_rows(*args)}
    own = build.load_library
    for name, fn in kernels.items():
        ms = []
        for lib in ("parent", "tree", "tree", "parent"):
            build.load_library = (lambda: parent) if lib == "parent" else own
            try:
                ms.append(time_cuda(fn, iters))
            finally:
                build.load_library = own
        print(f"{name} at tile 32 on the canonical view: parent {ms[0]:.4f} / {ms[3]:.4f} ms, "
              f"tree {ms[1]:.4f} / {ms[2]:.4f} ms", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path, required=True, help="the other commit's csrc")
    ap.add_argument("--time", action="store_true", help="time B1, B2 and B5 in turns")
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("tile_parity needs a CUDA card")
    from tpugs_torch.kernels.build import BUILD_DIR, compile_library

    parent = load(compile_library(a.parent, BUILD_DIR.parent / "tile_parity" / "libparent.so"))
    n = compare(parent)
    if a.time:
        timed(parent)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"{n} cases bit-equal to the parent's kernels at tiles 16 and 32 on {smi}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

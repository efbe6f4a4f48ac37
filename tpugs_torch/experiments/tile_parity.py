"""Are the kernels bit-equal to the parent commit's (1f38207)? Builds that
commit's ``csrc`` into a library of its own and launches both libraries,
through the package's own wrappers, on the same inputs (the parent's
library behind the tree's C interface, ``ParentLib``): at tiles 16 and 32,
B1 (culled and not), B2 and B6 in f32 and bf16 (one cluster, and several
clusters a tile), B4's cluster kernel (and its alpha and exit blocks
against the parent's wide kernel, which the tree no longer has), B5's
cluster kernel, its colour slices plus geometry kernel, and its geometry
rows at widths of one and of several pixel groups; at tiles 8, 12 and 24
the same but B4, whose route there changed (the parent's wide kernel, the
tree's cluster kernel with ghost ranks), and is held to its twin instead:
image and alpha within 1e-4, exit blocks equal. Every output must be equal
bit for bit; the first difference raises. With ``--time``, B1 and B5 (f32
rows, D = 131) at tile 32, and B2 and B6 (bf16 rows, and B2 in f32) at
tiles 16 and 32, on the canonical lift view (N = 2^19, 1296 x 840, D =
512) are timed by CUDA events, the parent's and the tree's kernels in
turns (parent, tree, tree, parent).

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


TILES = (16, 32)  # every kernel against the parent's
GHOST_TILES = (8, 12, 24)  # B1, B2/B6 and B5 against the parent's, B4 against its twin

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# The parent's C interface where the tree's differs (the tree added pixel
# groups, passes and scratch arguments; the parent had the wide kernel).
PARENT_SIGNATURES = {
    "tpugs_render": [_P] * 6 + [_I] * 3 + [_F, _I, _I, _P],
    "tpugs_adjoint_f32": [_P] * 6 + [_I] * 7 + [_F, _I, _I, _P],
    "tpugs_adjoint_bf16": [_P] * 6 + [_I] * 7 + [_F, _I, _I, _P],
    "tpugs_adjoint_scatter_f32": [_P] * 7 + [_I] * 7 + [_F, _I, _I, _P],
    "tpugs_adjoint_scatter_bf16": [_P] * 7 + [_I] * 7 + [_F, _I, _I, _P],
    "tpugs_train_fwd": [_P] * 8 + [_I] * 6 + [_F, _I, _I, _I, _I, _P],
    "tpugs_train_fwd_wide": [_P] * 8 + [_I] * 6 + [_F, _P],
    "tpugs_train_bwd_f32": [_P] * 10 + [_I] * 9 + [_P],
    "tpugs_train_bwd_bf16": [_P] * 10 + [_I] * 9 + [_P],
    "tpugs_train_bwd_colour_f32": [_P] * 10 + [_I] * 11 + [_P],
    "tpugs_train_bwd_colour_bf16": [_P] * 10 + [_I] * 11 + [_P],
    "tpugs_train_bwd_geom_f32": [_P] * 11 + [_I] * 10 + [_P],
    "tpugs_train_bwd_geom_bf16": [_P] * 11 + [_I] * 10 + [_P],
}


def _null(p) -> bool:
    return p is None or getattr(p, "value", 0) is None


class ParentLib:
    """The parent's library behind the tree's C interface: the arguments the
    tree added are dropped, and must hold what the parent did without them
    (one cluster a tile, no vote, no scratch; the parent kept B2's T in
    shared memory, so the scratch for it is dropped unread)."""

    def __init__(self, lib: ctypes.CDLL):
        self.lib = lib

    def __getattr__(self, name):
        return getattr(self.lib, name)

    def tpugs_render(self, *a):
        *head, cull, c, g, pas, stream = a
        assert g == 1 and pas == 0, "the parent walks a tile in one cluster"
        return self.lib.tpugs_render(*head, cull, c, stream)

    def _adjoint(self, name, at, a):
        assert a[at + 3] <= 32, "the parent keeps a tile's T in shared memory, to tile 32"
        return getattr(self.lib, name)(*a[:at], *a[at + 1:])

    def tpugs_adjoint_f32(self, *a):
        return self._adjoint("tpugs_adjoint_f32", 6, a)

    def tpugs_adjoint_bf16(self, *a):
        return self._adjoint("tpugs_adjoint_bf16", 6, a)

    def tpugs_adjoint_scatter_f32(self, *a):
        return self._adjoint("tpugs_adjoint_scatter_f32", 7, a)

    def tpugs_adjoint_scatter_bf16(self, *a):
        return self._adjoint("tpugs_adjoint_scatter_bf16", 7, a)

    def tpugs_train_fwd(self, *a):
        head, (c, p, g, s, ns, pas, stream) = a[:15], a[15:]
        assert g == 1 and pas == 0, "the parent walks a tile in one cluster"
        return self.lib.tpugs_train_fwd(*head, c, p, s, ns, stream)

    def _bwd(self, name, a):
        # geom .. out (10), gsum, n_tiles .. row width (7), the layout, T_padded, stream
        assert _null(a[10]), "the parent's ranks are one cluster"
        head, tail = a[:10] + a[11:18], a[18:]
        c, p, g, *slices, _, stream = tail
        assert g == 1, "the parent's ranks are one cluster"
        return getattr(self.lib, name)(*head, c, p, *slices, stream)

    def tpugs_train_bwd_f32(self, *a):
        return self._bwd("tpugs_train_bwd_f32", a)

    def tpugs_train_bwd_bf16(self, *a):
        return self._bwd("tpugs_train_bwd_bf16", a)

    def tpugs_train_bwd_colour_f32(self, *a):
        return self._bwd("tpugs_train_bwd_colour_f32", a)

    def tpugs_train_bwd_colour_bf16(self, *a):
        return self._bwd("tpugs_train_bwd_colour_bf16", a)

    def _geom(self, name, a):  # the tree's T_padded (second to last) dropped
        return getattr(self.lib, name)(*a[:-2], a[-1])

    def tpugs_train_bwd_geom_f32(self, *a):
        return self._geom("tpugs_train_bwd_geom_f32", a)

    def tpugs_train_bwd_geom_bf16(self, *a):
        return self._geom("tpugs_train_bwd_geom_bf16", a)


def load(so: Path) -> ParentLib:
    from tpugs_torch.kernels.build import SIGNATURES

    lib = ctypes.CDLL(str(so))
    for name, argtypes in {**SIGNATURES, **PARENT_SIGNATURES}.items():
        if name == "tpugs_train_fwd_max_clusters" or not hasattr(lib, name):
            continue
        fn = getattr(lib, name)
        fn.argtypes = PARENT_SIGNATURES.get(name, argtypes)
        fn.restype = ctypes.c_int
    return ParentLib(lib)


def _wide_parent(lib: ParentLib, geom, cols, plan, eps):
    """(alpha, blocks_done) of the parent's wide kernel."""
    from tpugs_torch.raster import kernels as K

    h, w, d = plan.height, plan.width, cols.shape[1]
    img = torch.empty((h, w, d), dtype=torch.float32, device="cuda")
    alpha = torch.empty((h, w), dtype=torch.float32, device="cuda")
    done = torch.empty((plan.n_tiles,), dtype=torch.int32, device="cuda")
    rc = lib.lib.tpugs_train_fwd_wide(
        K._ptr(geom), K._ptr(cols), K._ptr(plan.tile_starts), K._ptr(plan.tile_ends),
        K._ptr(plan.padded_starts), K._ptr(img), K._ptr(alpha), K._ptr(done), plan.n_tiles,
        plan.grid[0], plan.tile_size, w, h, d, float(eps), K._stream())
    K._launched(rc, "the parent's wide kernel")
    return alpha, done


def cases(ts: int):
    """(name, call) of every kernel at tile ``ts`` on one seeded view; each
    call returns the kernel's outputs as a tuple of tensors (B4 at the
    ghost tiles: its errors against its twin, which ``compare`` checks)."""
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
        if d in TRAIN_D and ts in TILES:
            out.append((f"B4 D={d}",
                        lambda geom=geom, cols=cols: T.train_forward(geom, cols, plan)))

            def against_wide(geom=geom, cols=cols):
                lib = load_library()
                if isinstance(lib, ParentLib):
                    return _wide_parent(lib, geom, cols, plan, K.TRANS_EPS)
                return T.train_forward(geom, cols, plan)[1:]
            out.append((f"B4 alpha and exit blocks against the wide kernel D={d}", against_wide))
        elif d in TRAIN_D:
            out.append((f"B4 D={d} against its twin", lambda geom=geom, cols=cols: twin_errors(
                T.train_forward(geom, cols, plan), T.train_forward_plain(geom, cols, plan))))
        if d in TRAIN_D:
            for dtype in (torch.float32, torch.bfloat16):
                out.append((f"B5 D={d} {dtype}",
                            lambda args=args, dtype=dtype: (T.train_rows(*args, dtype),)))
        if d in GEOM_D:
            out.append((f"B5 geometry rows D={d} {T.geom_cluster(ts, d)}",
                        lambda args=args: (T.train_geom_rows(*args),)))
    return out


def twin_errors(got, ref):
    """B4's (image, alpha) relative errors against its twin's and whether
    its exit blocks are the twin's."""
    rel = [float((a - b).abs().max() / b.abs().max()) for a, b in zip(got[:2], ref[:2])]
    return rel + [bool(torch.equal(got[2], ref[2]))]


def compare(parent: ParentLib) -> int:
    """Runs every case with the tree's library and with ``parent``; prints
    one line each and returns the number of cases."""
    from tpugs_torch.kernels import build

    own = build.load_library
    n = 0
    for ts in TILES + GHOST_TILES:
        for name, call in cases(ts):
            mine = call()
            if name.endswith("against its twin"):
                torch.cuda.synchronize()
                ok = mine[0] <= 1e-4 and mine[1] <= 1e-4 and mine[2]
                print(f"tile {ts} {name}: image {mine[0]:.3e}, alpha {mine[1]:.3e}, exit "
                      f"blocks equal {mine[2]}", flush=True)
                if not ok:
                    raise RuntimeError(f"tile {ts} {name} differs from its twin")
                n += 1
                continue
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


def timed(parent: ParentLib, iters: int = 10) -> None:
    """On the canonical view: B1 and B5 at tile 32, and B2 and B6 (bf16
    rows, and B2 in f32) at tiles 16 and 32: ms of the parent's and the
    tree's kernels in turns."""
    from tpugs_torch.experiments.adjoint_phases import canonical_views
    from tpugs_torch.kernels import build
    from tpugs_torch.raster import kernels as K
    from tpugs_torch.raster import train as T
    from tpugs_torch.utils.timing import time_cuda

    own = build.load_library

    def turns(name, fn):
        ms = []
        for lib in ("parent", "tree", "tree", "parent"):
            build.load_library = (lambda: parent) if lib == "parent" else own
            try:
                ms.append(time_cuda(fn, iters))
            finally:
                build.load_library = own
        print(f"{name} on the canonical view: parent {ms[0]:.4f} / {ms[3]:.4f} ms, "
              f"tree {ms[1]:.4f} / {ms[2]:.4f} ms", flush=True)

    for ts in (16, 32):
        r, r_s = canonical_views(ts)
        plan = r.plan
        f32 = r.feat_tiles.float()
        turns(f"B2 bf16 at tile {ts}", lambda: K.adjoint_rows(r.packed, r.feat_tiles, plan))
        turns(f"B2 f32 at tile {ts}", lambda: K.adjoint_rows(r.packed, f32, plan))
        turns(f"B6 bf16 at tile {ts}",
              lambda: K.adjoint_scatter_rows(r_s.packed, r_s.feat_tiles, r_s.plan))
        del f32
    gen = torch.Generator(device="cuda").manual_seed(5)
    d = 131
    geom = r.packed[:, :T.GEOM_COLS].contiguous()
    cols = torch.rand((plan.T_padded, d), device="cuda", generator=gen)
    _, alpha, done = T.train_forward(geom, cols, plan)
    g = torch.randn((plan.height, plan.width, d), device="cuda", generator=gen)
    hterm = torch.randn((plan.height, plan.width), device="cuda", generator=gen) * (1.0 - alpha)
    args = (geom, cols, g, hterm, hterm, done, plan)
    turns("B1 at tile 32", lambda: K.render_tiles(r.packed, plan))
    turns("B5 f32 D=131 at tile 32", lambda: T.train_rows(*args))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path, required=True, help="the other commit's csrc")
    ap.add_argument("--time", action="store_true", help="time B1, B2, B5 and B6 in turns")
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
    print(f"{n} cases at tiles {TILES + GHOST_TILES} held (bit-equal to the parent's kernels, "
          f"B4 at {GHOST_TILES} to its twin) on {smi}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

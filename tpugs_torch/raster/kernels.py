"""The lift path's kernels, their wrappers and their plain twins, and the
tile walk that the train kernels' twins (``raster/train.py``) share.
Counterparts in ``tpugs/raster/pallas_tiled.py``:

  B1 ``render_tiles``  <- ``render_pallas_raw`` (:1328, kernel :1229)
  B2 ``adjoint_rows``  <- ``adjoint_pallas_raw`` (:1573, kernel :1390)
  B3 ``reduce_rows``   <- ``reduce_contribs_pallas`` (:2178, kernel :2121)

and the opt-in scatter reduce engine (a plan built with ``scatter=True``):

  B6 ``adjoint_scatter_rows`` <- ``adjoint_scatter_pallas_raw`` (:1870,
                                 kernel :1672)
  B7 ``reduce_striped``       <- ``reduce_striped_pallas`` (:1987, kernel
                                 :1945)

plus the shared block weights (``_block_weights_full`` :1105) and tile
pixel centres (``_tile_pixels`` :1219).

Each wrapper checks device, dtype, shape and contiguity and raises on
anything else. A CPU tensor goes to the plain twin (``*_plain``), a CUDA
tensor to the CUDA kernel in ``tpugs_torch/csrc`` or an exception; nothing
falls back. Each kernel launch adds one to ``LAUNCHES``; B2 and B6 add
the lift's work, kernel or twin, to ``WORK``. The twins and the
kernels take any tile size (``check_tile``: at least 1), with ghost pixel
slots where a tile's pixels do not fill the kernel's warp rectangles or
pixel groups (``render_cluster``, ``adjoint_groups``). Where a tile's
pixels outgrow one cluster, B1 (and B4, ``raster/train.py``) decide the
tile-wide exit by an exact vote over pixel groups (``exit_vote_plain``
is its twin): a pixel's T never grows, so the tile exits at the largest of
the groups' own exit blocks.

B1 walks, per warp of 8 x 4 pixels, only the Gaussians of a block that can
reach the 1/255 clip somewhere in the warp's rectangle (``rect_live``, the
plan's sub-cutoff test on the rectangle's pixel centres with a margin for
rounding). A culled pair has alpha 0 at every pixel of the rectangle, so
the result is bit-equal to the walk of every pair, which
``render_tiles_unculled`` launches for the checks and
``render_tiles_plain(..., cull=True)`` mirrors on the CPU.

Semantics shared by B1 and B2 (the exact path of the reference; the port
computes exact weights in both contribution dtypes):

* ``sigma = 0.5*(a*dx^2 + c*dy^2) + b*dx*dy`` at pixel centres (+0.5);
  ``alpha = min(op*exp(-max(sigma, 0)), 0.999)``, zeroed unless
  ``sigma >= 0``, ``alpha >= 1/255`` and the slot is inside the span;
* ``w = alpha * T_excl * T_carry``; within a 128-Gaussian block the
  exclusive transmittance is a running product;
* a tile stops before a block once the largest transmittance over all
  its ts*ts pixels, including those outside the image, is at most
  ``trans_eps`` (block-granular and tile-wide).

B2 also zeroes the weights of pixels outside W x H, writes zero rows for
the blocks the early exit skips, and writes the ones-channel at column D,
which carries the weight denominator. In bf16 mode the weights are cast to
bf16 before the product, the product accumulates in f32 and the rows are
stored as bf16.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional, Tuple

import torch

from tpugs_torch.raster.binning import cdiv
from tpugs_torch.raster.pack import COL_COLOR, COL_GEOM, PACK_COLS
from tpugs_torch.raster.plan import BLOCK, Plan, scatter_columns
from tpugs_torch.utils.profiling import register_counters

ALPHA_MIN = 1.0 / 255.0
ALPHA_MAX = 0.999
TRANS_EPS = 1e-4  # early-exit transmittance threshold
CHANNEL_SLICE = 128  # contribution-row columns per CUDA block of B2
MAX_CLUSTER = 8  # CTAs of a thread-block cluster of B1, B2, B4 and B5 (the portable limit)
RENDER_CHANNELS = 5  # rgb, depth, 1 - T
CONTRIB_DTYPES = (torch.float32, torch.bfloat16)
RENDER_THREADS = 256  # threads of a B1 CTA, one per pixel
RECT_W, RECT_H = 8, 4  # a B1 warp's pixel rectangle
# tile (1024 pixels), and in a per-cluster scratch in device memory past it
CULL_SLACK = 1e-3  # the plan's slack on sig_cut (plan.py step 3)
CULL_MARGIN = 1e-4  # of the quadratic's term magnitudes, against f32 rounding


@dataclasses.dataclass
class LaunchCounts:
    """How many times each CUDA kernel was launched (twins do not count)."""

    render: int = 0
    render_unculled: int = 0
    render_vote: int = 0
    adjoint: int = 0
    reduce: int = 0
    train_fwd: int = 0
    train_fwd_vote: int = 0
    train_bwd: int = 0
    train_bwd_colour: int = 0
    train_bwd_geom: int = 0
    train_bwd_groups: int = 0  # B5's group-order adds after a launch in pixel groups
    adjoint_scatter: int = 0
    stripe_sum: int = 0

    def reset(self) -> None:
        for f in dataclasses.fields(self):
            setattr(self, f.name, 0)

    def snapshot(self) -> dict:
        return dataclasses.asdict(self)


LAUNCHES = LaunchCounts()
register_counters("launches", LAUNCHES)


class WorkCounts:
    """The lift kernels' work, whether the kernel or its twin runs:
    ``calls`` views whose rows B2 or B6 wrote, ``slots`` their plans'
    padded slots (the rows B2 writes and B3 reads), and ``isects`` their
    intersections, counted at the B2 and B6 wrappers; ``walked_slots``,
    BLOCK x the blocks each tile walked in B1 before its early exit, which
    the lift adds (``lift/batch.py::render_and_pack``). Every other slot is
    a zero row that B2 writes for a block past its tile's exit.
    ``walked_slots`` adds up on the device (one reduction and one add a
    view, no host sync); only ``snapshot`` reads it back."""

    def __init__(self) -> None:
        self.reset()

    def reset(self) -> None:
        self.calls = self.slots = self.isects = 0
        self._blocks = {}  # device -> () int64 blocks walked, added on that device

    def lifted(self, plan: Plan) -> None:
        self.calls += 1
        self.slots += plan.T_padded
        self.isects += plan.n_isects

    def walked(self, blocks_done: torch.Tensor) -> None:
        acc = self._blocks.get(blocks_done.device)
        if acc is None:
            acc = torch.zeros((), dtype=torch.int64, device=blocks_done.device)
            self._blocks[blocks_done.device] = acc
        acc.add_(blocks_done.sum(dtype=torch.int64))

    def snapshot(self) -> dict:
        blocks = sum(int(t) for t in self._blocks.values())
        return {"calls": self.calls, "slots": self.slots, "isects": self.isects,
                "walked_slots": BLOCK * blocks}


WORK = WorkCounts()
register_counters("work", WORK)


def contrib_width(feature_dim: int) -> int:
    """Row width of B2's output: D features + the ones-channel, padded to
    whole channel slices."""
    return cdiv(feature_dim + 1, CHANNEL_SLICE) * CHANNEL_SLICE


# ------------------------------------------------------------- checks


def _check(t: torch.Tensor, name: str, dtypes, shape, device) -> None:
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a tensor, got {type(t).__name__}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype not in dtypes:
        raise TypeError(f"{name} has dtype {t.dtype}, expected one of {dtypes}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_plan(plan: Plan, device) -> None:
    check_tile(plan.tile_size)
    nt = plan.n_tiles
    for name in ("tile_starts", "tile_ends", "padded_starts"):
        _check(getattr(plan, name), f"plan.{name}", (torch.int32,), (nt,), device)
    n = plan.num_gaussians
    _check(plan.gauss_offsets, "plan.gauss_offsets", (torch.int32,), (n + 1,), device)
    _check(plan.gauss_pos, "plan.gauss_pos", (torch.int32,), (plan.n_isects,), device)


def check_tile(tile_size: int) -> None:
    """The kernels and twins take tiles of at least 1 pixel a side; the
    plan checks and the layout functions call this."""
    if tile_size < 1:
        raise ValueError(f"tile_size {tile_size}: a tile is at least 1 pixel a side")


def _check_scatter_plan(plan: Plan, device) -> None:
    if plan.slot_pos is None:
        raise ValueError("the scatter engine needs a plan built with scatter=True")
    n = plan.num_gaussians
    _check(plan.slot_pos, "plan.slot_pos", (torch.int32,), (plan.T_padded,), device)
    _check(plan.culled, "plan.culled", (torch.int32,), (n,), device)
    _check(plan.slot_order, "plan.slot_order", (torch.int64,), (n,), device)
    n_stripes = plan.stripe_base.shape[0] if plan.stripe_base.ndim == 1 else -1
    _check(plan.stripe_base, "plan.stripe_base", (torch.int32,), (n_stripes,), device)


def _dispatch(device: torch.device) -> bool:
    """True for the CUDA kernel, False for the plain twin."""
    if device.type == "cuda":
        return True
    if device.type == "cpu":
        return False
    raise ValueError(f"no kernel or plain version for device {device}")


def _ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def _stream() -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


def _launched(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} kernel launch failed with CUDA error {rc}")


# ------------------------------------------------- shared twin pieces


def _tile_pixels(tiles: torch.Tensor, ntx: int, ts: int):
    """Pixel centres (k, ts*ts) of tiles ``tiles`` (k,)."""
    tx = (tiles % ntx).to(torch.float32)[:, None]
    ty = (tiles // ntx).to(torch.float32)[:, None]
    lp = torch.arange(ts * ts, device=tiles.device)
    lx = (lp % ts).to(torch.float32)[None, :]
    ly = (lp // ts).to(torch.float32)[None, :]
    return tx * ts + lx + 0.5, ty * ts + ly + 0.5


def _block_terms(geo, px, py, lane_valid) -> dict:
    """Per-pair terms (k, P, BLOCK) of block rows ``geo`` (k, BLOCK, >= 6;
    geometry in columns 0..5) at pixels px, py (k, P); ``lane_valid``
    (k, BLOCK). ``alpha`` is masked; ``keep`` is its mask; ``e`` is
    exp(-max(sigma, 0)) and ``alpha_raw`` = op * e, as in
    ``_block_weights_full``."""
    g = geo[:, None, :, COL_GEOM:COL_GEOM + 6]  # (k, 1, B, 6)
    mx, my, ca, cb, cc, op = g.unbind(-1)
    dx = px[..., None] - mx
    dy = py[..., None] - my
    sigma = 0.5 * (ca * dx * dx + cc * dy * dy) + cb * dx * dy
    e = torch.exp(-torch.clamp(sigma, min=0.0))
    alpha_raw = op * e
    alpha = torch.clamp(alpha_raw, max=ALPHA_MAX)
    keep = (sigma >= 0.0) & (alpha >= ALPHA_MIN) & lane_valid[:, None, :]
    return dict(dx=dx, dy=dy, sigma=sigma, e=e, alpha_raw=alpha_raw, keep=keep,
                alpha=torch.where(keep, alpha, torch.zeros_like(alpha)))


def _block_weights(alpha, trans):
    """w = alpha * T_excl * T_carry and the carried T after the block."""
    incl = torch.cumprod(1.0 - alpha, dim=-1)
    texc = torch.cat([torch.ones_like(incl[..., :1]), incl[..., :-1]], dim=-1)
    return alpha * texc * trans[..., None], trans * incl[..., -1]


def tile_rects(tiles: torch.Tensor, ntx: int, ts: int):
    """B1's warp rectangles of tiles ``tiles`` (k,): the first pixel centres
    x0, y0 (k, R) of the R = ceil(ts / RECT_W) * ceil(ts / RECT_H)
    rectangles of RECT_W x RECT_H pixels that cover the tile, row-major
    (where RECT_W or RECT_H does not divide ts, the last ones reach past
    it), and each tile pixel's rectangle (ts*ts,) int64."""
    dev = tiles.device
    per_row = cdiv(ts, RECT_W)
    r = torch.arange(per_row * cdiv(ts, RECT_H), device=dev)
    tx = (tiles % ntx)[:, None] * ts
    ty = (tiles // ntx)[:, None] * ts
    x0 = (tx + (r % per_row)[None, :] * RECT_W).to(torch.float32) + 0.5
    y0 = (ty + (r // per_row)[None, :] * RECT_H).to(torch.float32) + 0.5
    lp = torch.arange(ts * ts, device=dev)
    rect_of = (lp // ts) // RECT_H * per_row + (lp % ts) // RECT_W
    return x0, y0, rect_of


def rect_live(geo, x0, y0, lane_valid) -> torch.Tensor:
    """B1's cull (``cull_consts`` and ``rect_dead`` in ``csrc/render.cu``,
    the same f32 operations but the logarithm): live bits (k, R, BLOCK) of
    block rows ``geo`` (k, BLOCK, >= 6; geometry in columns 0..5) on the R
    rectangles of RECT_W x RECT_H pixel centres whose first centres are x0,
    y0 (k, R); ``lane_valid`` (k, BLOCK) marks the slots inside the span.

    A pair is dead when the minimum of sigma over the rectangle of pixel
    centres (the plan's edge minima, and 0 if the centre lies inside), less
    CULL_MARGIN times the sum of the quadratic's term magnitudes there,
    exceeds sig_cut = ln(max(255 op, 1)) + CULL_SLACK: then alpha < 1/255 at
    every pixel. A conic that is not positive definite, or a NaN or negative
    opacity, has sig_cut +inf and is never dead; nor is a pair with any
    other value that is not finite (fmin/fmax skip NaN as fminf/fmaxf do,
    and the margin is then infinite or NaN)."""
    g = geo[:, None, :, COL_GEOM:COL_GEOM + 6]  # (k, 1, B, 6)
    mx, my, ca, cb, cc, op = g.unbind(-1)
    tiny = torch.full_like(ca, 1e-12)
    ok = (ca > 0.0) & (cc > 0.0) & (ca * cc > cb * cb) & (op >= 0.0)
    cut = torch.log(torch.fmax(255.0 * op, torch.ones_like(op))) + CULL_SLACK
    cut = torch.where(ok, cut, torch.full_like(cut, float("inf")))
    inv_a, inv_c = 1.0 / torch.fmax(ca, tiny), 1.0 / torch.fmax(cc, tiny)
    x0, y0 = x0[..., None], y0[..., None]  # (k, R, 1)
    x1, y1 = x0 + (RECT_W - 1), y0 + (RECT_H - 1)
    lx, ux, ly, uy = x0 - mx, x1 - mx, y0 - my, y1 - my

    def edge(e, lo, hi, ce, co, inv_co):
        cbe = cb * e
        t = torch.fmin(torch.fmax(-cbe * inv_co, lo), hi)
        return (0.5 * ce) * e * e + (0.5 * co) * t * t + cbe * t

    qmin = torch.fmin(torch.fmin(edge(lx, ly, uy, ca, cc, inv_c), edge(ux, ly, uy, ca, cc, inv_c)),
                      torch.fmin(edge(ly, lx, ux, cc, ca, inv_a), edge(uy, lx, ux, cc, ca, inv_a)))
    inside = (lx <= 0.0) & (ux >= 0.0) & (ly <= 0.0) & (uy >= 0.0)
    qmin = torch.where(inside, torch.fmin(qmin, torch.zeros_like(qmin)), qmin)
    ex = torch.fmax(lx.abs(), ux.abs())
    ey = torch.fmax(ly.abs(), uy.abs())
    terms = (0.5 * ca) * ex * ex + (0.5 * cc) * ey * ey + cb.abs() * ex * ey
    dead = qmin - CULL_MARGIN * terms > cut
    return lane_valid[:, None, :] & ~dead


@dataclasses.dataclass
class BlockStep:
    """One step of ``_walk_blocks`` for the tiles still running:
    ``active`` indexes the walked tiles; ``w`` (ka, ts*ts, BLOCK) are the
    weights, ``trans`` (ka, ts*ts) the transmittance carried into the
    block, ``terms`` the block's ``_block_terms``; ``geo`` the block's pack
    rows and ``rows`` their indices."""

    active: torch.Tensor
    w: torch.Tensor
    trans: torch.Tensor
    terms: dict
    geo: torch.Tensor
    rows: torch.Tensor
    px: torch.Tensor
    py: torch.Tensor


def _walk_blocks(pack, plan, tiles, trans_eps, visit, n_blocks=None, cull=False,
                 voters=None):
    """The tile walk of B1/B2/B4/B5 for tiles ``tiles`` (k,), vectorised
    over tiles: for each block index b, the tiles still running get a
    ``BlockStep`` through ``visit``. A tile stops at its early exit, or,
    with ``n_blocks`` (k,), after exactly that many blocks (the forward's
    count, which the backward replays). The exit tests the largest T over
    all the tile's pixels, or over those of the bool mask ``voters``
    (ts*ts,) alone (a pixel group's own exit, ``exit_vote_plain``). With
    ``cull`` the alpha of every pair that B1's cull skips is set to 0 and
    ``terms["live"]`` (ka, ts*ts, BLOCK) holds the live bit of each pixel's
    rectangle. Returns (T (k, ts*ts), blocks processed (k,) int32)."""
    ntx, _ = plan.grid
    ts = plan.tile_size
    dev = pack.device
    count = (plan.tile_ends[tiles] - plan.tile_starts[tiles]).long()
    nb = (count + BLOCK - 1) // BLOCK
    if n_blocks is not None:
        nb = torch.minimum(nb, n_blocks.long())
    pstart = plan.padded_starts[tiles].long()
    px, py = _tile_pixels(tiles, ntx, ts)
    if cull:
        rx0, ry0, rect_of = tile_rects(tiles, ntx, ts)
    k = tiles.shape[0]
    trans = torch.ones((k, ts * ts), dtype=pack.dtype, device=dev)
    max_t = torch.ones((k,), dtype=pack.dtype, device=dev)
    done = torch.zeros((k,), dtype=torch.int32, device=dev)
    lane = torch.arange(BLOCK, device=dev)
    n_steps = int(nb.max()) if k else 0
    for b in range(n_steps):
        running = b < nb
        if n_blocks is None:
            running &= max_t > trans_eps
        active = torch.nonzero(running).squeeze(1)
        if active.numel() == 0:
            break
        rows = pstart[active, None] + b * BLOCK + lane[None, :]
        geo = pack[rows]  # (ka, BLOCK, pack columns)
        lane_valid = lane[None, :] < (count[active, None] - b * BLOCK)
        terms = _block_terms(geo, px[active], py[active], lane_valid)
        if cull:
            live = rect_live(geo, rx0[active], ry0[active], lane_valid)[:, rect_of]
            terms["live"] = live
            terms["alpha"] = torch.where(live, terms["alpha"], torch.zeros_like(terms["alpha"]))
        w, t_new = _block_weights(terms["alpha"], trans[active])
        visit(BlockStep(active, w, trans[active], terms, geo, rows, px[active], py[active]))
        trans[active] = t_new
        max_t[active] = (t_new if voters is None else t_new[:, voters]).max(dim=1).values
        done[active] += 1
    return trans, done


def _all_tiles(plan: Plan, device) -> torch.Tensor:
    return torch.arange(plan.n_tiles, device=device)


# ------------------------------------------------------------ B1 render


def render_tiles_plain(
    pack: torch.Tensor,
    plan: Plan,
    trans_eps: float = TRANS_EPS,
    tiles: Optional[torch.Tensor] = None,
    cull: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """B1's twin. Returns per-tile images (k, ts*ts, 5) [r, g, b, depth,
    1 - T] and the blocks each tile processed (k,) int32, for all tiles or
    for ``tiles``; with ``cull`` the alpha of every pair the kernel's cull
    skips is forced to 0 (the same bits)."""
    if tiles is None:
        tiles = _all_tiles(plan, pack.device)
    k = tiles.shape[0]
    img = torch.zeros((k, plan.tile_size**2, 4), dtype=pack.dtype, device=pack.device)

    def visit(st: BlockStep):
        cols = st.geo[..., COL_COLOR:COL_COLOR + 4]  # (ka, BLOCK, 4)
        img[st.active] += torch.bmm(st.w, cols)

    trans, done = _walk_blocks(pack, plan, tiles, trans_eps, visit, cull=cull)
    return torch.cat([img, (1.0 - trans)[..., None]], dim=-1), done


def render_cluster(tile_size: int) -> Tuple[int, int, int]:
    """(C, P, G) of B1: one tile's warp rectangles (``tile_rects``), one
    warp each, P = RENDER_THREADS pixel slots a CTA; up to MAX_CLUSTER CTAs
    (tiles up to 40) one cluster of C (G = 1: 4 at tile 32, 1 at tile 16),
    past that G = ceil(CTAs / MAX_CLUSTER) pixel groups of C = ceil(CTAs /
    G) CTAs, whose exit is the vote's (``exit_vote_plain``). Where the
    rectangles reach past the tile, or leave warps or CTAs without one,
    those pixel slots are ghosts: T starts at 0 there, so they weigh
    nothing, pass every exit vote and write nothing. The C side refuses
    any other layout."""
    check_tile(tile_size)
    rects = cdiv(tile_size, RECT_W) * cdiv(tile_size, RECT_H)
    ctas = cdiv(rects * RECT_W * RECT_H, RENDER_THREADS)
    groups = cdiv(ctas, MAX_CLUSTER)
    return cdiv(ctas, groups), RENDER_THREADS, groups


def render_groups(tile_size: int) -> torch.Tensor:
    """B1's pixel group of each of a tile's ts*ts pixels (row-major), int64:
    the group of the CTA whose warp rectangle holds it (``render_cluster``)."""
    c, p, _ = render_cluster(tile_size)
    _, _, rect_of = tile_rects(torch.zeros((1,), dtype=torch.int64), 1, tile_size)
    return rect_of // (p // 32) // c


def exit_vote_plain(
    pack: torch.Tensor,
    plan: Plan,
    groups: torch.Tensor,
    trans_eps: float = TRANS_EPS,
    tiles: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The exit vote's twin: for each tile (all, or ``tiles`` (k,)) and each
    pixel group of ``groups`` (ts*ts,) (``render_groups``, or
    ``raster/train.py::train_fwd_groups``), the blocks the group's pixels
    walk before their own largest T is at most ``trans_eps`` (k, G) int32,
    and the tile's blocks, the largest of them (k,) int32: the whole-tile
    walk's ``blocks_done``, since no pixel's T ever grows."""
    if tiles is None:
        tiles = _all_tiles(plan, pack.device)
    n_groups = int(groups.max()) + 1
    own = torch.stack([
        _walk_blocks(pack, plan, tiles, trans_eps, lambda st: None,
                     voters=(groups == g).to(pack.device))[1]
        for g in range(n_groups)], 1)
    return own, own.amax(1)


def launch_render(lib, pack, plan, trans_eps, cull, out, done) -> bool:
    """B1 through ``lib``'s ``tpugs_render`` (the package's library or a
    copy of it) into ``out`` and ``done``: one launch where the tile is
    one cluster, else the vote into zeroed ``done`` and the walk after it.
    Returns whether it voted."""
    ntx, _ = plan.grid
    c, _, g = render_cluster(plan.tile_size)
    if g > 1:
        done.zero_()
    for pas in ((1, 2) if g > 1 else (0,)):
        rc = lib.tpugs_render(
            _ptr(pack), _ptr(plan.tile_starts), _ptr(plan.tile_ends), _ptr(plan.padded_starts),
            _ptr(out), _ptr(done), plan.n_tiles, ntx, plan.tile_size, float(trans_eps),
            int(cull), c, g, pas, _stream(),
        )
        _launched(rc, "render vote" if pas == 1 else "render" if cull else "render_unculled")
    return g > 1


def _render(pack, plan, trans_eps, cull):
    dev = pack.device
    _check(pack, "pack", (torch.float32,), (plan.T_padded, PACK_COLS), dev)
    _check_plan(plan, dev)
    if not _dispatch(dev):
        return render_tiles_plain(pack, plan, trans_eps)
    from tpugs_torch.kernels.build import load_library

    nt, tspx = plan.n_tiles, plan.tile_size**2
    out = torch.empty((nt, tspx, RENDER_CHANNELS), dtype=torch.float32, device=dev)
    done = torch.empty((nt,), dtype=torch.int32, device=dev)
    if nt == 0:
        return out, done
    if launch_render(load_library(), pack, plan, trans_eps, cull, out, done):
        LAUNCHES.render_vote += 1
    if cull:
        LAUNCHES.render += 1
    else:
        LAUNCHES.render_unculled += 1
    return out, done


def render_tiles(
    pack: torch.Tensor, plan: Plan, trans_eps: float = TRANS_EPS
) -> Tuple[torch.Tensor, torch.Tensor]:
    """B1: per-tile images (n_tiles, ts*ts, 5) float32 and the number of
    128-Gaussian blocks each tile processed before its early exit. Where a
    tile outgrows one cluster (``render_cluster``), two launches: the exit
    vote (counted in ``LAUNCHES.render_vote``) and the walk."""
    return _render(pack, plan, trans_eps, True)


def render_tiles_unculled(
    pack: torch.Tensor, plan: Plan, trans_eps: float = TRANS_EPS
) -> Tuple[torch.Tensor, torch.Tensor]:
    """B1's instantiation without the cull, for the checks that hold it
    bit-equal to ``render_tiles``: every warp walks all 128 Gaussians of a
    block. Counted in ``LAUNCHES.render_unculled`` (its vote, where it
    votes, in ``render_vote``); never on a main path."""
    return _render(pack, plan, trans_eps, False)


# ----------------------------------------------------------- B2 adjoint


def _features_with_ones(feats: torch.Tensor, width: int) -> torch.Tensor:
    """(k, P, D) -> float32 (k, P, width): features, the ones-channel at
    column D, zeros after."""
    k, p, d = feats.shape
    out = torch.zeros((k, p, width), dtype=torch.float32, device=feats.device)
    out[..., :d] = feats.to(torch.float32)
    out[..., d] = 1.0
    return out


def adjoint_rows_plain(
    pack: torch.Tensor,
    feat_tiles: torch.Tensor,
    plan: Plan,
    trans_eps: float = TRANS_EPS,
    tiles: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """B2's twin. Contribution rows (T_padded, contrib_width(D)) in the
    features' dtype; with ``tiles`` only those tiles' spans are filled."""
    if tiles is None:
        tiles = _all_tiles(plan, pack.device)
    dtype = feat_tiles.dtype
    width = contrib_width(feat_tiles.shape[-1])
    out = torch.zeros((plan.T_padded, width), dtype=dtype, device=pack.device)
    fext = _features_with_ones(feat_tiles[tiles], width)

    def visit(st: BlockStep):
        in_img = (st.px < plan.width) & (st.py < plan.height)
        w = torch.where(in_img[..., None], st.w, torch.zeros_like(st.w))
        if dtype == torch.bfloat16:
            w = w.to(torch.bfloat16).to(torch.float32)
        contrib = torch.bmm(w.transpose(1, 2), fext[st.active])
        out[st.rows] = contrib.to(dtype)

    _walk_blocks(pack, plan, tiles, trans_eps, visit)
    return out


def _check_adjoint(pack: torch.Tensor, feat_tiles: torch.Tensor, plan: Plan) -> int:
    """Checks of B2 and B6; returns D."""
    dev = pack.device
    _check(pack, "pack", (torch.float32,), (plan.T_padded, PACK_COLS), dev)
    _check_plan(plan, dev)
    if feat_tiles.ndim != 3:
        raise ValueError(f"feat_tiles must be (n_tiles, ts*ts, D), got {tuple(feat_tiles.shape)}")
    D = feat_tiles.shape[-1]
    _check(feat_tiles, "feat_tiles", CONTRIB_DTYPES, (plan.n_tiles, plan.tile_size**2, D), dev)
    if D < 1:
        raise ValueError("feat_tiles needs at least one channel")
    return D


ADJOINT_GROUP = {torch.float32: 16, torch.bfloat16: 32}  # pixels per group of B2 and B6


def adjoint_groups(tile_size: int, dtype: torch.dtype) -> Tuple[int, int]:
    """(groups, P) of B2 and B6: a tile's ts*ts pixels in ceil(ts*ts / P)
    groups of P (``ADJOINT_GROUP``), the slots past ts*ts in the last group
    ghosts (T 0, zero features), all walked by one cluster of channel
    slices (``adjoint_cluster``), whose T lives in a scratch in device
    memory."""
    check_tile(tile_size)
    p = ADJOINT_GROUP[dtype]
    return cdiv(tile_size**2, p), p


def adjoint_cluster(width: int) -> Tuple[int, int]:
    """(C, gridDim.x) of B2 and B6 for contribution rows ``width`` wide:
    the S = width / CHANNEL_SLICE channel slices of a tile go to
    ceil(S / MAX_CLUSTER) clusters of C = ceil(S / ceil(S / MAX_CLUSTER))
    CTAs each, one CTA per slice; the CTAs past the last slice write no
    columns."""
    if width < 1 or width % CHANNEL_SLICE:
        raise ValueError(f"row width {width} is not a positive multiple of {CHANNEL_SLICE}")
    s = width // CHANNEL_SLICE
    per_tile = cdiv(s, MAX_CLUSTER)
    c = cdiv(s, per_tile)
    return c, c * per_tile


def _launch_adjoint(pack, feat_tiles, plan, trans_eps, out, dest) -> None:
    """B2 (``dest`` None: row r at out[r]) or B6 (row r at out[dest[r]]),
    with a scratch for every cluster's T."""
    from tpugs_torch.kernels.build import load_library

    check_tile(plan.tile_size)
    lib = load_library()
    c, grid_x = adjoint_cluster(out.shape[1])
    groups, p = adjoint_groups(plan.tile_size, feat_tiles.dtype)
    t = torch.empty((plan.n_tiles * (grid_x // c) * groups * p,), dtype=torch.float32,
                    device=pack.device)
    bf16 = feat_tiles.dtype == torch.bfloat16
    if dest is None:
        fn = lib.tpugs_adjoint_bf16 if bf16 else lib.tpugs_adjoint_f32
        extra = ()
    else:
        fn = lib.tpugs_adjoint_scatter_bf16 if bf16 else lib.tpugs_adjoint_scatter_f32
        extra = (_ptr(dest),)
    ntx, _ = plan.grid
    rc = fn(
        _ptr(pack), _ptr(plan.tile_starts), _ptr(plan.tile_ends),
        _ptr(plan.padded_starts), _ptr(feat_tiles), *extra, _ptr(out), _ptr(t),
        plan.n_tiles, ntx, plan.tile_size, plan.width, plan.height,
        feat_tiles.shape[-1], out.shape[1], float(trans_eps), c, grid_x, _stream(),
    )
    _launched(rc, "adjoint" if dest is None else "adjoint_scatter")


def adjoint_rows(
    pack: torch.Tensor,
    feat_tiles: torch.Tensor,
    plan: Plan,
    trans_eps: float = TRANS_EPS,
) -> torch.Tensor:
    """B2: contribution rows (T_padded, contrib_width(D)) in the features'
    dtype (float32 or bfloat16). Row r holds, for the intersection in
    padded slot r, sum_p w(p) * [features(p) | 1 | 0...]."""
    D = _check_adjoint(pack, feat_tiles, plan)
    WORK.lifted(plan)
    if not _dispatch(pack.device):
        return adjoint_rows_plain(pack, feat_tiles, plan, trans_eps)
    out = torch.empty((plan.T_padded, contrib_width(D)), dtype=feat_tiles.dtype,
                      device=pack.device)
    if plan.n_tiles == 0 or plan.T_padded == 0:
        return out
    _launch_adjoint(pack, feat_tiles, plan, trans_eps, out, None)
    LAUNCHES.adjoint += 1
    return out


# Limits of ``rows_error`` for B2 against its twin, (of column-group max, of
# row max). f32: summation order only. bf16: two roundings to bf16 of nearly
# equal f32 sums differ by at most one unit in the last place, 2^-7 of the
# value (7.8e-3); within a row a weight may also round the other way before
# the product, one more unit (2^-6 = 1.6e-2 of the row's largest value).
ROWS_TOL = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (1e-2, 2e-2)}


def rows_error(got: torch.Tensor, ref: torch.Tensor, feature_dim: int):
    """Scale-free distance of contribution rows ``got`` from ``ref``:
    (max abs error; the largest error of the feature columns [:D] over
    their largest magnitude, and likewise of the weight column D; the
    largest error within any row's features, or its weight, over that
    row's own largest magnitude). The weight column dwarfs the features
    (L2-normalised, about 0.04 of it at D = 512) and rows span orders of
    magnitude, so the last value is the one that sees a wrong product on a
    light row. A row's scale is at least the smallest normal float: deep
    in a tile, where T is far below ``trans_eps`` on some pixels, weights
    fall to subnormals, whose fixed spacing makes any relative error there
    meaningless. A row that is zero in one and normal in the other is
    wholly wrong (error 1)."""
    d = feature_dim
    got, ref = got[:, : d + 1].float(), ref[:, : d + 1].float()
    if ref.numel() == 0:
        return 0.0, 0.0, 0.0
    diff = (got - ref).abs()
    mag = torch.maximum(got.abs(), ref.abs())
    of_group, of_row = 0.0, 0.0
    for cols in (slice(0, d), slice(d, d + 1)):
        dg, mg = diff[:, cols], mag[:, cols]
        scale = float(mg.max())
        if scale > 0:
            of_group = max(of_group, float(dg.max()) / scale)
        row_scale = mg.amax(1).clamp_min(torch.finfo(torch.float32).tiny)
        row_err = dg.amax(1) / row_scale
        of_row = max(of_row, float(row_err.max()))
    return float(diff.max()), of_group, of_row


# ------------------------------------------------------------ B3 reduce


def reduce_rows_plain(
    rows: torch.Tensor,
    plan: Plan,
    n_cols: int,
    gaussians: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """B3's twin: per-Gaussian f32 sums of the first ``n_cols`` columns of
    each Gaussian's rows, added from 0 in increasing tile order — the
    reference stripe-sum's order. (N, n_cols), or (k, n_cols) for
    ``gaussians`` (k,) original indices."""
    dev = rows.device
    if gaussians is None:
        gaussians = torch.arange(plan.num_gaussians, device=dev)
    off = plan.gauss_offsets.long()
    start = off[gaussians]
    counts = off[gaussians + 1] - start
    acc = torch.zeros((gaussians.shape[0], n_cols), dtype=torch.float32, device=dev)
    n_steps = int(counts.max()) if counts.numel() else 0
    for k in range(n_steps):
        sel = torch.nonzero(counts > k).squeeze(1)
        pos = plan.gauss_pos[start[sel] + k].long()
        acc[sel] += rows[pos, :n_cols].to(torch.float32)
    return acc


def reduce_rows(rows: torch.Tensor, plan: Plan, n_cols: int) -> torch.Tensor:
    """B3: (N, n_cols) float32 per-Gaussian sums of their contribution
    rows, written straight to each Gaussian's original index."""
    dev = rows.device
    if rows.ndim != 2:
        raise ValueError(f"rows must be (T_padded, width), got {tuple(rows.shape)}")
    width = rows.shape[1]
    _check(rows, "rows", CONTRIB_DTYPES, (plan.T_padded, width), dev)
    _check_plan(plan, dev)
    if not 1 <= n_cols <= width or width % 2:
        raise ValueError(f"n_cols {n_cols} must lie in [1, {width}], width even")
    if not _dispatch(dev):
        return reduce_rows_plain(rows, plan, n_cols)
    from tpugs_torch.kernels.build import load_library

    lib = load_library()
    n = plan.num_gaussians
    out = torch.empty((n, n_cols), dtype=torch.float32, device=dev)
    if n == 0:
        return out
    fn = lib.tpugs_reduce_bf16 if rows.dtype == torch.bfloat16 else lib.tpugs_reduce_f32
    rc = fn(
        _ptr(rows), _ptr(plan.gauss_offsets), _ptr(plan.gauss_pos), _ptr(out),
        n, n_cols, width, _stream(),
    )
    _launched(rc, "reduce")
    LAUNCHES.reduce += 1
    return out


# ----------------------------------------- B6 scatter-write adjoint


def adjoint_scatter_rows_plain(
    pack: torch.Tensor,
    feat_tiles: torch.Tensor,
    plan: Plan,
    trans_eps: float = TRANS_EPS,
    tiles: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """B6's twin: B2's twin's rows, each moved to its striped row
    ``plan.slot_pos[r]``. The buffer starts as NaN, so a row that nothing
    writes, read by a sum, shows; padding slots all land on the trash row
    ``R_striped``."""
    rows = adjoint_rows_plain(pack, feat_tiles, plan, trans_eps, tiles)
    out = torch.full((plan.R_striped + 1, rows.shape[1]), float("nan"),
                     dtype=rows.dtype, device=rows.device)
    out[plan.slot_pos.long()] = rows
    return out


def adjoint_scatter_rows(
    pack: torch.Tensor,
    feat_tiles: torch.Tensor,
    plan: Plan,
    trans_eps: float = TRANS_EPS,
) -> torch.Tensor:
    """B6: B2's contribution rows written straight into the striped layout
    of a ``scatter=True`` plan: (R_striped + 1, contrib_width(D)) in the
    features' dtype, row ``plan.slot_pos[r]`` holding B2's row r. Striped
    rows past a column's kept count are never written (their contents are
    undefined, and ``reduce_striped`` never reads them); the last row is
    the trash row of the padding slots."""
    D = _check_adjoint(pack, feat_tiles, plan)
    dev = pack.device
    _check_scatter_plan(plan, dev)
    WORK.lifted(plan)
    if not _dispatch(dev):
        return adjoint_scatter_rows_plain(pack, feat_tiles, plan, trans_eps)
    out = torch.empty((plan.R_striped + 1, contrib_width(D)), dtype=feat_tiles.dtype,
                      device=dev)
    if plan.n_tiles == 0 or plan.T_padded == 0:
        return out
    _launch_adjoint(pack, feat_tiles, plan, trans_eps, out, plan.slot_pos)
    LAUNCHES.adjoint_scatter += 1
    return out


# ------------------------------------------------- B7 masked stripe sum


def reduce_striped_plain(
    striped: torch.Tensor,
    plan: Plan,
    n_cols: int,
    unpermute: bool = True,
    gaussians: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """B7's twin: for each column c, the f32 sum from 0 of striped rows
    ``stripe_base[j] + c`` for j = 0 .. culled[c] - 1, added stripe by
    stripe in j order (B3's order, so the sums are bit-equal to it on the
    same rows). (N, n_cols) in original Gaussian order, or in column order
    without ``unpermute``; (k, n_cols) for ``gaussians`` (k,) original
    indices."""
    dev = striped.device
    n = plan.num_gaussians
    cols = torch.arange(n, device=dev) if gaussians is None else scatter_columns(plan)[gaussians]
    culled = plan.culled.long()[cols]
    base = plan.stripe_base.long()
    acc = torch.zeros((cols.shape[0], n_cols), dtype=torch.float32, device=dev)
    for j in range(base.shape[0]):
        sel = torch.nonzero(culled > j).squeeze(1)
        acc[sel] += striped[base[j] + cols[sel], :n_cols].to(torch.float32)
    if gaussians is not None or not unpermute:
        return acc
    out = torch.empty_like(acc)
    out[plan.slot_order] = acc
    return out


def reduce_striped(
    striped: torch.Tensor, plan: Plan, n_cols: int, unpermute: bool = True
) -> torch.Tensor:
    """B7: (N, n_cols) float32 per-Gaussian sums of a striped buffer from
    ``adjoint_scatter_rows``, each written to the Gaussian's original index
    (``unpermute``, the reference's ``acc[inv]`` fused) or, without it, in
    column order (``plan.slot_order[c]`` is column c's Gaussian)."""
    dev = striped.device
    if striped.ndim != 2:
        raise ValueError(f"striped must be (R_striped + 1, width), got {tuple(striped.shape)}")
    width = striped.shape[1]
    _check(striped, "striped", CONTRIB_DTYPES, (plan.R_striped + 1, width), dev)
    _check_scatter_plan(plan, dev)
    if not 1 <= n_cols <= width or width % 2:
        raise ValueError(f"n_cols {n_cols} must lie in [1, {width}], width even")
    if not _dispatch(dev):
        return reduce_striped_plain(striped, plan, n_cols, unpermute)
    from tpugs_torch.kernels.build import load_library

    lib = load_library()
    n = plan.num_gaussians
    out = torch.empty((n, n_cols), dtype=torch.float32, device=dev)
    if n == 0:
        return out
    fn = (lib.tpugs_stripe_sum_bf16 if striped.dtype == torch.bfloat16
          else lib.tpugs_stripe_sum_f32)
    index = _ptr(plan.slot_order) if unpermute else ctypes.c_void_p(None)
    rc = fn(
        _ptr(striped), _ptr(plan.stripe_base), _ptr(plan.culled), index, _ptr(out),
        n, n_cols, width, _stream(),
    )
    _launched(rc, "stripe_sum")
    LAUNCHES.stripe_sum += 1
    return out

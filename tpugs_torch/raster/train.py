"""The differentiable render of the train step: two kernels, their plain
twins and the ``torch.autograd.Function`` around them. Counterparts in
``tpugs/raster/pallas_train.py``:

  ``pack_train``        <- ``pack_train`` (:98)
  B4 ``train_forward``  <- ``_forward_tiles`` (:229, kernel :134, ``pallas_call``
                           :250) and
                           ``_forward_impl`` (:258)
  B5 ``train_rows``     <- ``_backward_impl`` (:496, kernel :275); its
                           geometry-only launch ``train_geom_rows`` gives the
                           absgrad columns of renders wider than B5's rows
  ``RenderTrain``       <- ``_train_core`` and its VJP (:586-637)
  ``render_plan_train`` <- ``render_plan_train`` (:692)
  ``render_scene``      <- ``render_scene_pallas`` (:661)

B4 renders D channels and alpha with B1's weights and tile-wide early
exit, and reports the blocks each tile walked. B5 replays exactly those
blocks, rebuilds the blend state with ``_block_weights_full``'s semantics
and writes one gradient row per intersection:
``[d colour (D) | dmx dmy dca dcb dcc dop |dmx| |dmy| | 0 pad]``; B3's
``reduce_rows`` sums them per Gaussian. The packs are row-major: the
transposed ``(d_pad, T_padded)`` layout and the 128-lane row rounding of
the reference are Mosaic constraints. Wrappers follow ``kernels.py``:
checks, ``_dispatch`` (CPU tensors to the twin, CUDA tensors to the
kernel), one count per launch in ``LAUNCHES``.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from tpugs_torch.raster.binning import cdiv
from tpugs_torch.raster.colors import prepare_colors
from tpugs_torch.raster.kernels import (
    ALPHA_MAX,
    CONTRIB_DTYPES,
    LAUNCHES,
    TRANS_EPS,
    BlockStep,
    _all_tiles,
    _check,
    _check_plan,
    _dispatch,
    _launched,
    _ptr,
    _stream,
    _walk_blocks,
    reduce_rows,
)
from tpugs_torch.raster.plan import Plan, build_plan
from tpugs_torch.raster.projection import ProjectionConfig, project
from tpugs_torch.raster.tiles import image_to_tiles, tiles_to_image

GEOM_COLS = 8  # [mx, my, conic_a, conic_b, conic_c, opacity, 0, 0]
GEOM_GRADS = 8  # dmx dmy dca dcb dcc dop |dmx| |dmy|
MAX_CHANNELS = 512  # B5's one-CTA kernel keeps 32 Gaussians x D sums in shared memory
CLUSTER_MAX_CHANNELS = 256  # B5's cluster kernel keeps each rank's g in shared memory,
# B4's its image (of one channel slice) in wgmma accumulators
PIXELS_PER_RANK = 128  # pixels of a tile per CTA of the B4 and B5 cluster kernels
SLICE_CHANNELS = 256  # B4's widest channel slice (faster than 128 at D = 512: PERF.md)


def grad_row_width(channels: int) -> int:
    """Width of B5's rows: D colour gradients + 8 geometry columns, padded
    to a multiple of 4 (B3 reads column pairs)."""
    return cdiv(channels + GEOM_GRADS, 4) * 4


def pack_train(means2d, conics, opacities, colors, plan: Plan):
    """Per-intersection packs in plan order from original-order inputs:
    geometry (T_padded, 8) and colours (T_padded, D), float32; padding
    slots read an all-zero row (opacity 0, so alpha 0)."""
    n, d = colors.shape
    src = torch.cat([plan.order, plan.order.new_full((1,), n)])[plan.padded_gid.long()]
    geom = torch.cat([means2d, conics, opacities[:, None], opacities.new_zeros((n, 2))], 1)
    geom = torch.cat([geom, geom.new_zeros((1, GEOM_COLS))])[src]
    cols = torch.cat([colors, colors.new_zeros((1, d))])[src]
    return geom.float().contiguous(), cols.float().contiguous()


# ------------------------------------------------------------ B4 forward


def train_tiles_plain(
    geom: torch.Tensor,
    cols: torch.Tensor,
    plan: Plan,
    trans_eps: float = TRANS_EPS,
    tiles: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """B4's twin on the tile layout, for all tiles or ``tiles`` (k,):
    (image (k, ts*ts, D), alpha (k, ts*ts), blocks walked (k,) int32)."""
    if tiles is None:
        tiles = _all_tiles(plan, geom.device)
    k, d = tiles.shape[0], cols.shape[1]
    img = torch.zeros((k, plan.tile_size**2, d), dtype=torch.float32, device=geom.device)

    def visit(st: BlockStep):
        img[st.active] += torch.bmm(st.w, cols[st.rows])

    trans, done = _walk_blocks(geom, plan, tiles, trans_eps, visit)
    return img, 1.0 - trans, done


def train_forward_plain(geom, cols, plan: Plan, trans_eps: float = TRANS_EPS):
    """B4's twin: as ``train_forward``."""
    img, alpha, done = train_tiles_plain(geom, cols, plan, trans_eps)
    w, h, ts = plan.width, plan.height, plan.tile_size
    return tiles_to_image(img, w, h, ts), tiles_to_image(alpha[..., None], w, h, ts)[..., 0], done


def _check_packs(geom, cols, plan: Plan) -> int:
    dev = geom.device
    _check(geom, "geom", (torch.float32,), (plan.T_padded, GEOM_COLS), dev)
    if cols.ndim != 2 or cols.shape[1] < 1:
        raise ValueError(f"cols must be (T_padded, D >= 1), got {tuple(cols.shape)}")
    _check(cols, "cols", (torch.float32,), (plan.T_padded, cols.shape[1]), dev)
    _check_plan(plan, dev)
    return cols.shape[1]


def fwd_slices(channels: int, widest: int = SLICE_CHANNELS) -> Tuple[int, int]:
    """(S, Ns): B4's channels cut into S = ceil(D / widest) slices of Ns =
    16 ceil(D / 16 S) columns: the narrowest multiple of 16 whose S slices
    cover D, so the slices are balanced (the last holds the remainder)."""
    s = cdiv(channels, widest)
    return s, 16 * cdiv(channels, 16 * s)


def train_fwd_cluster(tile_size: int, channels: int) -> Optional[Tuple[int, int, int, int]]:
    """(C, P, S, Ns) of B4's cluster kernel: a tile's ts*ts pixels go to
    clusters of C = ts*ts / P CTAs of P = PIXELS_PER_RANK pixels each (8 at
    tile 32, 2 at tile 16), one cluster for each of the S channel slices of
    ``fwd_slices`` (a slice's image lives in wgmma accumulators, at most
    CLUSTER_MAX_CHANNELS columns a thread). None for tiles other than 16 and
    32 (their pixels do not split into ranks of P): those take the wide
    kernel. The C side refuses any other (C, P, S, Ns)."""
    if not 1 <= tile_size <= 32:
        raise ValueError(f"tile_size {tile_size}: B4 takes 1 to 32")
    if channels < 1:
        raise ValueError(f"{channels} channels: B4 takes at least 1")
    if tile_size not in (16, 32):
        return None
    return (tile_size**2 // PIXELS_PER_RANK, PIXELS_PER_RANK) + fwd_slices(channels)


def _launch_train_fwd(lib, geom, cols, plan: Plan, trans_eps: float, cluster):
    """One B4 launch into new outputs: the cluster kernel at ``cluster`` =
    (C, P, S, Ns), or the wide kernel for None; counts it in ``LAUNCHES``."""
    dev = geom.device
    nt, w, h, d = plan.n_tiles, plan.width, plan.height, cols.shape[1]
    img = torch.empty((h, w, d), dtype=torch.float32, device=dev)
    alpha = torch.empty((h, w), dtype=torch.float32, device=dev)
    done = torch.empty((nt,), dtype=torch.int32, device=dev)
    if nt == 0:
        return img, alpha, done
    if cols.data_ptr() % 16:
        raise ValueError("cols must be 16-byte aligned (the kernel copies 16-byte vectors)")
    ntx, _ = plan.grid
    fn = lib.tpugs_train_fwd_wide if cluster is None else lib.tpugs_train_fwd
    rc = fn(
        _ptr(geom), _ptr(cols), _ptr(plan.tile_starts), _ptr(plan.tile_ends),
        _ptr(plan.padded_starts), _ptr(img), _ptr(alpha), _ptr(done),
        nt, ntx, plan.tile_size, w, h, d, float(trans_eps), *(cluster or ()), _stream(),
    )
    if cluster is None:
        _launched(rc, "train_fwd_wide")
        LAUNCHES.train_fwd_wide += 1
    else:
        _launched(rc, "train_fwd")
        LAUNCHES.train_fwd += 1
    return img, alpha, done


def train_forward(
    geom: torch.Tensor, cols: torch.Tensor, plan: Plan, trans_eps: float = TRANS_EPS
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """B4: image (H, W, D) and alpha = 1 - T (H, W), float32, without a
    background, and the number of 128-Gaussian blocks each tile walked
    before its early exit (n_tiles,) int32. At tiles 16 and 32 the cluster
    kernel runs in channel slices (``train_fwd_cluster``), at other tiles
    the wide kernel."""
    d = _check_packs(geom, cols, plan)
    if not _dispatch(geom.device):
        return train_forward_plain(geom, cols, plan, trans_eps)
    from tpugs_torch.kernels.build import load_library

    cluster = train_fwd_cluster(plan.tile_size, d)
    return _launch_train_fwd(load_library(), geom, cols, plan, trans_eps, cluster)


# ----------------------------------------------------------- B5 backward


def train_cluster(tile_size: int, channels: int) -> Optional[Tuple[int, int]]:
    """(C, P) of B5's cluster kernel: a tile's ts*ts pixels go to a cluster
    of C = ts*ts / P CTAs of P = PIXELS_PER_RANK pixels each (8 at tile
    32, 2 at tile 16). None for more than CLUSTER_MAX_CHANNELS channels,
    whose g does not fit a CTA's shared memory: those take the one-CTA
    kernel. The C side refuses any other (C, P)."""
    if tile_size not in (16, 32):
        raise ValueError(f"tile_size {tile_size}: the kernels take 16 or 32")
    if not 1 <= channels <= MAX_CHANNELS:
        raise ValueError(f"{channels} channels: B5 takes 1 to {MAX_CHANNELS}")
    if channels > CLUSTER_MAX_CHANNELS:
        return None
    return tile_size**2 // PIXELS_PER_RANK, PIXELS_PER_RANK


def train_rows_plain(
    geom, cols, g_image, hterm, grem0, blocks_done, plan: Plan,
    contrib_dtype: torch.dtype = torch.float32,
    tiles: Optional[torch.Tensor] = None,
    magnitudes: bool = False,
    geometry_only: bool = False,
):
    """B5's twin: as ``train_rows``, or with ``geometry_only`` as
    ``train_geom_rows`` (rows of the GEOM_GRADS columns alone, at any D);
    with ``tiles`` only those tiles' spans are filled. Per block, with u = g . colour (a product over
    channels), an inclusive prefix of w*u along the block (``cumsum``, not
    the reference's doubling scan) and the per-pixel carry ``grem``:

        d_alpha = texc * T * u - (grem - prefix + hterm) / max(1 - alpha, 1e-6)

    With ``magnitudes`` it returns (rows, mags): ``mags`` (f32, the rows'
    shape) holds for every entry the same sums taken over the absolute
    values of every factor and term (|g|, |colour|, |grem| + prefix of
    w*|u|, |hterm|, ...). That bounds the entry and scales its rounding
    error, which cancellation in the sums over pixels and in ``v`` leaves
    far above the entry itself (``grad_rows_error``)."""
    dev = geom.device
    if tiles is None:
        tiles = _all_tiles(plan, dev)
    d = cols.shape[1]
    ts = plan.tile_size
    lead = 0 if geometry_only else d  # colour columns before the geometry
    width = GEOM_GRADS if geometry_only else grad_row_width(d)
    out = torch.zeros((plan.T_padded, width), dtype=contrib_dtype, device=dev)
    g_t = image_to_tiles(g_image, ts)[tiles]
    h_t = image_to_tiles(hterm[..., None], ts)[tiles][..., 0]
    grem = image_to_tiles(grem0[..., None], ts)[tiles][..., 0].clone()
    mags = torch.zeros(out.shape, dtype=torch.float32, device=dev) if magnitudes else None
    grem_m = grem.abs() if magnitudes else None

    def visit(st: BlockStep):
        t = st.terms
        alpha = t["alpha"]
        incl = torch.cumprod(1.0 - alpha, dim=-1)
        texc = torch.cat([torch.ones_like(incl[..., :1]), incl[..., :-1]], dim=-1)
        g_a = g_t[st.active]
        u = torch.bmm(g_a, cols[st.rows].transpose(1, 2))  # (ka, P, BLOCK)
        cs = torch.cumsum(st.w * u, dim=-1)
        v = grem[st.active][..., None] - cs
        d_alpha = texc * st.trans[..., None] * u - (
            v + h_t[st.active][..., None]) / torch.clamp(1.0 - alpha, min=1e-6)
        zero = torch.zeros_like(d_alpha)
        d_araw = torch.where(t["keep"] & (t["alpha_raw"] < ALPHA_MAX), d_alpha, zero)
        op = st.geo[:, None, :, 5]
        d_sig = torch.where(t["sigma"] > 0.0, -d_araw * op * t["e"], zero)
        dx, dy = t["dx"], t["dy"]
        ca, cb, cc = (st.geo[:, None, :, j] for j in (2, 3, 4))
        dm_x = d_sig * -(ca * dx + cb * dy)
        dm_y = d_sig * -(cc * dy + cb * dx)
        geo_grads = torch.stack([
            dm_x, dm_y, d_sig * (0.5 * dx * dx), d_sig * (dx * dy), d_sig * (0.5 * dy * dy),
            d_araw * t["e"], dm_x.abs(), dm_y.abs(),
        ], dim=-1).sum(1)  # (ka, BLOCK, 8)
        parts = [geo_grads] if geometry_only else [
            torch.bmm(st.w.transpose(1, 2), g_a), geo_grads]  # d col (ka, BLOCK, D)
        out[st.rows, : lead + GEOM_GRADS] = torch.cat(parts, -1).to(contrib_dtype)
        grem[st.active] = grem[st.active] - cs[..., -1]
        if mags is None:
            return
        g_m = g_a.abs()
        u_m = torch.bmm(g_m, cols[st.rows].abs().transpose(1, 2))
        cs_m = torch.cumsum(st.w * u_m, dim=-1)
        da_m = texc * st.trans[..., None] * u_m + (
            grem_m[st.active][..., None] + cs_m + h_t[st.active].abs()[..., None]
        ) / torch.clamp(1.0 - alpha, min=1e-6)
        da_m = torch.where(t["keep"] & (t["alpha_raw"] < ALPHA_MAX), da_m, zero)
        sig_m = torch.where(t["sigma"] > 0.0, da_m * op * t["e"], zero)
        mx_m = sig_m * (ca * dx + cb * dy).abs()
        my_m = sig_m * (cc * dy + cb * dx).abs()
        geo_m = torch.stack([
            mx_m, my_m, sig_m * (0.5 * dx * dx), sig_m * (dx * dy).abs(),
            sig_m * (0.5 * dy * dy), da_m * t["e"], mx_m, my_m,
        ], dim=-1).sum(1)
        parts = [geo_m] if geometry_only else [torch.bmm(st.w.transpose(1, 2), g_m), geo_m]
        mags[st.rows, : lead + GEOM_GRADS] = torch.cat(parts, -1)
        grem_m[st.active] = grem_m[st.active] + cs_m[..., -1]

    _walk_blocks(geom, plan, tiles, 0.0, visit, n_blocks=blocks_done[tiles])
    return (out, mags) if magnitudes else out


def _check_bwd(geom, cols, g_image, hterm, grem0, blocks_done, plan: Plan) -> int:
    d = _check_packs(geom, cols, plan)
    dev = geom.device
    h, w = plan.height, plan.width
    _check(g_image, "g_image", (torch.float32,), (h, w, d), dev)
    _check(hterm, "hterm", (torch.float32,), (h, w), dev)
    _check(grem0, "grem0", (torch.float32,), (h, w), dev)
    _check(blocks_done, "blocks_done", (torch.int32,), (plan.n_tiles,), dev)
    return d


def _launch_train_bwd(fn, geom, cols, g_image, hterm, grem0, blocks_done, plan: Plan,
                      out: torch.Tensor, cluster=None) -> int:
    """One B5 launch of ``fn`` into ``out`` (T_padded, row width); the
    CUDA error code."""
    ntx, _ = plan.grid
    return fn(
        _ptr(geom), _ptr(cols), _ptr(g_image), _ptr(hterm), _ptr(grem0),
        _ptr(plan.tile_starts), _ptr(plan.tile_ends), _ptr(plan.padded_starts),
        _ptr(blocks_done), _ptr(out), plan.n_tiles, ntx, plan.tile_size, plan.width,
        plan.height, cols.shape[1], out.shape[1], *(cluster or ()), _stream(),
    )


def train_rows(
    geom: torch.Tensor,
    cols: torch.Tensor,
    g_image: torch.Tensor,
    hterm: torch.Tensor,
    grem0: torch.Tensor,
    blocks_done: torch.Tensor,
    plan: Plan,
    contrib_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """B5: gradient rows (T_padded, grad_row_width(D)) in ``contrib_dtype``
    (float32, or bfloat16 cast at the store). Inputs: the packs, the image
    cotangent ``g_image`` (H, W, D), ``hterm`` = h * T_final and ``grem0``
    = g . (image without background) per pixel (H, W), and B4's
    ``blocks_done``. Rows of blocks the forward skipped are zero. Up to
    CLUSTER_MAX_CHANNELS channels the cluster kernel runs, above it the
    one-CTA kernel: chosen by width alone (``train_cluster``)."""
    d = _check_bwd(geom, cols, g_image, hterm, grem0, blocks_done, plan)
    dev = geom.device
    if contrib_dtype not in CONTRIB_DTYPES:
        raise TypeError(f"contrib_dtype {contrib_dtype} not in {CONTRIB_DTYPES}")
    if d > MAX_CHANNELS:
        raise ValueError(f"{d} channels exceed the backward kernel's {MAX_CHANNELS}")
    if not _dispatch(dev):
        return train_rows_plain(geom, cols, g_image, hterm, grem0, blocks_done, plan,
                                contrib_dtype)
    from tpugs_torch.kernels.build import load_library

    lib = load_library()
    out = torch.empty((plan.T_padded, grad_row_width(d)), dtype=contrib_dtype, device=dev)
    if plan.n_tiles == 0 or plan.T_padded == 0:
        return out
    bf16 = contrib_dtype == torch.bfloat16
    cluster = train_cluster(plan.tile_size, d)
    if cluster is None:
        fn = lib.tpugs_train_bwd_wide_bf16 if bf16 else lib.tpugs_train_bwd_wide_f32
    else:
        fn = lib.tpugs_train_bwd_bf16 if bf16 else lib.tpugs_train_bwd_f32
    rc = _launch_train_bwd(fn, geom, cols, g_image, hterm, grem0, blocks_done, plan, out,
                           cluster)
    if cluster is None:
        _launched(rc, "train_bwd_wide")
        LAUNCHES.train_bwd_wide += 1
    else:
        _launched(rc, "train_bwd")
        LAUNCHES.train_bwd += 1
    return out


def train_geom_rows(
    geom: torch.Tensor,
    cols: torch.Tensor,
    g_image: torch.Tensor,
    hterm: torch.Tensor,
    grem0: torch.Tensor,
    blocks_done: torch.Tensor,
    plan: Plan,
) -> torch.Tensor:
    """B5's geometry-only launch: f32 rows (T_padded, GEOM_GRADS) of
    ``train_rows``' geometry columns (dmx dmy dca dcb dcc dop |dmx| |dmy|),
    with the same inputs, at any number of channels D (the one-CTA kernel
    without its colour gradients, whose shared memory caps ``train_rows``
    at MAX_CHANNELS). Its twin is ``train_rows_plain(...,
    geometry_only=True)``. ``RenderTrain`` takes the absgrad columns of a
    render wider than MAX_CHANNELS from it."""
    _check_bwd(geom, cols, g_image, hterm, grem0, blocks_done, plan)
    dev = geom.device
    if not _dispatch(dev):
        return train_rows_plain(geom, cols, g_image, hterm, grem0, blocks_done, plan,
                                geometry_only=True)
    if plan.tile_size not in (16, 32):
        raise ValueError(f"tile_size {plan.tile_size}: the kernels take 16 or 32")
    from tpugs_torch.kernels.build import load_library

    out = torch.empty((plan.T_padded, GEOM_GRADS), dtype=torch.float32, device=dev)
    if plan.n_tiles == 0 or plan.T_padded == 0:
        return out
    rc = _launch_train_bwd(load_library().tpugs_train_bwd_geom_f32, geom, cols, g_image, hterm,
                           grem0, blocks_done, plan, out)
    _launched(rc, "train_bwd_geom")
    LAUNCHES.train_bwd_geom += 1
    return out


# Limits of ``grad_rows_error`` for B5 (and B3's sums of its rows) against
# the twin, (of column-group max, of the entry's own magnitude). f32:
# summation order (u over D, the prefix of w*u, the sums over pixels).
# bf16: two roundings of nearly equal f32 values differ by one unit in the
# last place, at most 2^-7 of the value (7.8e-3), and no entry exceeds its
# magnitude.
GRAD_ROWS_TOL = {torch.float32: (3e-4, 1e-4), torch.bfloat16: (1e-2, 1e-2)}


def grad_rows_error(got: torch.Tensor, ref: torch.Tensor, channels: int,
                    mags: torch.Tensor):
    """(max abs error; the largest error of a column group over that
    group's largest magnitude; the largest error of any entry over its own
    magnitude ``mags``) between B5 rows, or their per-Gaussian sums, with
    ``mags`` from ``train_rows_plain(..., magnitudes=True)`` (summed like
    the rows for the sums). The groups are the D colour gradients, then
    each geometry column on its own (their scales differ by orders of
    magnitude). The last value sees a wrong or missing light row, which
    the group maximum hides: Gaussians late in a span, at small T, have
    gradients orders of magnitude below it. An entry's own value is no
    scale for it, because ``v = grem - prefix`` and the sums over pixels
    cancel; its magnitude is. It is at least the smallest normal float, as
    in ``rows_error``."""
    d = channels
    got, ref = got[:, : d + GEOM_GRADS].float(), ref[:, : d + GEOM_GRADS].float()
    if ref.numel() == 0:
        return 0.0, 0.0, 0.0
    diff = (got - ref).abs()
    mag = torch.maximum(got.abs(), ref.abs())
    worst = 0.0
    colour = [slice(0, d)] if d else []  # 0 channels: train_geom_rows' rows
    for cols in colour + [slice(d + j, d + j + 1) for j in range(GEOM_GRADS)]:
        scale = float(mag[:, cols].max())
        if scale > 0:
            worst = max(worst, float(diff[:, cols].max()) / scale)
    own = mags[:, : d + GEOM_GRADS].float().clamp_min(torch.finfo(torch.float32).tiny)
    return float(diff.max()), worst, float((diff / own).max())


# -------------------------------------------------- autograd Function


def _no_mark(name: str) -> None:
    pass


def channel_chunks(channels: int):
    """[start, end) column ranges of at most MAX_CHANNELS each, B5's widest
    launch: a wider render runs B4 and B5 once per chunk."""
    return [(a, min(a + MAX_CHANNELS, channels)) for a in range(0, channels, MAX_CHANNELS)]


class RenderTrain(torch.autograd.Function):
    """(image (H, W, D), alpha (H, W)) of one camera, differentiable in
    means2d, conics, opacities, colours and the background. The backward
    is B5 then B3. ``abs_probe`` (N, 2) never touches the render; its
    gradient is the absgrad statistic, sum over pixels of |d means2d|.

    Above MAX_CHANNELS channels B4 and B5 run once per chunk of
    ``channel_chunks``: alpha and the walked blocks do not depend on the
    colours (the first chunk's are kept), and the alpha adjoint is linear in
    the per-channel terms u and V, so each chunk's B5 gets its own channels'
    ``grem0``, only the first gets the background/alpha term ``hterm``, and
    the chunks' geometry gradients are summed. The absgrad columns, sums
    over pixels of the absolute per-pixel screen gradient, are not linear
    in the chunks: when the probe needs a gradient, B5's geometry-only
    launch (``train_geom_rows``) runs once over all channels and B3 sums
    its columns 6:8. ``record`` takes at most MAX_CHANNELS channels."""

    @staticmethod
    def forward(ctx, means2d, conics, opacities, colors, background, abs_probe,
                plan, trans_eps, contrib_dtype, mark, record):
        chunks = channel_chunks(colors.shape[1])
        if len(chunks) > 1 and record is not None:
            raise ValueError(f"{colors.shape[1]} channels render in chunks of {MAX_CHANNELS}: "
                             "record takes at most that many")
        geom, cols = pack_train(means2d, conics, opacities, colors, plan)
        mark("pack")
        outs = [train_forward(geom, cols[:, a:b].contiguous(), plan, trans_eps)
                for a, b in chunks]
        image = torch.cat([o[0] for o in outs], -1) if len(outs) > 1 else outs[0][0]
        _, alpha, done = outs[0]
        if record is not None:
            record.update(geom=geom, cols=cols, plan=plan, trans_eps=trans_eps,
                          image=image.detach(), alpha=alpha.detach(), blocks_done=done)
        if background is not None:
            image = image + (1.0 - alpha)[..., None] * background
        mark("render")
        ctx.save_for_backward(geom, cols, image, alpha, done, background)
        ctx.plan, ctx.contrib_dtype, ctx.mark, ctx.record = plan, contrib_dtype, mark, record
        return image, alpha

    @staticmethod
    def backward(ctx, g_image, g_alpha):
        geom, cols, image, alpha, done, background = ctx.saved_tensors
        plan, mark = ctx.plan, ctx.mark
        chunks = channel_chunks(cols.shape[1])
        g_image = g_image.float().contiguous()
        transs = 1.0 - alpha
        h = -g_alpha.float()
        d_bg = None
        img_nobg = image
        if background is not None:
            h = h + g_image @ background
            d_bg = torch.einsum("hw,hwd->d", transs, g_image)
            img_nobg = image - transs[..., None] * background
        hterm = (h * transs).contiguous()
        col_grads, geo_grads = [], None
        for i, (a, b) in enumerate(chunks):
            g_c = g_image[..., a:b].contiguous()
            grem0 = (g_c * img_nobg[..., a:b]).sum(-1).contiguous()
            rows = train_rows(geom, cols[:, a:b].contiguous(), g_c,
                              hterm if i == 0 else torch.zeros_like(hterm), grem0, done, plan,
                              ctx.contrib_dtype)
            if ctx.record is not None:
                ctx.record.update(g_image=g_image, hterm=hterm, grem0=grem0,
                                  contrib_dtype=ctx.contrib_dtype, rows=rows)
            mark("B5 rows")
            sums = reduce_rows(rows, plan, b - a + GEOM_GRADS)
            mark("B3 reduce")
            col_grads.append(sums[:, : b - a])
            gg = sums[:, b - a:]
            geo_grads = gg if geo_grads is None else geo_grads + gg
        d_col = torch.cat(col_grads, 1) if len(col_grads) > 1 else col_grads[0]
        gg = geo_grads
        d_abs = None
        if ctx.needs_input_grad[5]:
            d_abs = gg[:, 6:8]
            if len(chunks) > 1:  # |per-pixel sum over all channels|, not a sum over chunks
                grem0 = (g_image * img_nobg).sum(-1).contiguous()
                rows = train_geom_rows(geom, cols, g_image, hterm, grem0, done, plan)
                mark("B5 rows")
                d_abs = reduce_rows(rows, plan, GEOM_GRADS)[:, 6:8]
                mark("B3 reduce")
        return (gg[:, 0:2], gg[:, 2:5], gg[:, 5], d_col, d_bg, d_abs,
                None, None, None, None, None)


def render_plan_train(
    means2d: torch.Tensor,  # (N, 2) original order
    conics: torch.Tensor,  # (N, 3)
    opacities: torch.Tensor,  # (N,) validity-masked
    colors: torch.Tensor,  # (N, D) any channel count
    plan: Plan,
    background: Optional[torch.Tensor] = None,  # (D,)
    trans_eps: float = TRANS_EPS,
    abs_probe: Optional[torch.Tensor] = None,  # (N, 2) zeros
    contrib_dtype: torch.dtype = torch.float32,
    on_stage: Optional[Callable[[str], None]] = None,
    record: Optional[dict] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Differentiable render of one camera: (image (H, W, D), alpha (H, W)).
    ``on_stage(name)`` is called after "pack" and "render" in the forward
    and after "B5 rows" and "B3 reduce" in the backward. ``record``, a
    dict, receives B4's inputs and outputs (geom, cols, plan, trans_eps,
    image, alpha, blocks_done) and B5's further inputs and rows (g_image,
    hterm, grem0, contrib_dtype, rows)."""
    return RenderTrain.apply(means2d, conics, opacities, colors, background, abs_probe,
                             plan, trans_eps, contrib_dtype, on_stage or _no_mark, record)


def render_scene(
    scene,  # GaussianScene
    viewmat: torch.Tensor,
    K: torch.Tensor,
    width: int,
    height: int,
    sh_degree: Optional[int] = None,
    proj_config: ProjectionConfig = ProjectionConfig(),
    tile_size: int = 16,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """RGB render of one camera through B4 (no gradient): (image (H, W, 3),
    alpha (H, W)), on the scene's device."""
    deg = scene.sh_degree if sh_degree is None else sh_degree
    with torch.no_grad():
        proj = project(scene.means, scene.quats, scene.scales, scene.opacities,
                       viewmat, K, width, height, proj_config)
        plan = build_plan(proj, width, height, tile_size)
        opac = torch.where(proj.valid, proj.opacities, torch.zeros_like(proj.opacities))
        colors = prepare_colors(scene.means, scene.colors_all, viewmat, deg)
        geom, cols = pack_train(proj.means2d, proj.conics, opac, colors, plan)
        image, alpha, _ = train_forward(geom, cols, plan, TRANS_EPS)
    return image, alpha

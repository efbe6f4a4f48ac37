"""Each CUDA kernel against its plain twin on the card. A CUDA kernel has
no CPU mode, so without a card these skip (``python -m pytest
tests/test_torch_kernels_cuda.py`` on the H100 runs them).

Tolerances: B1 within 1e-4 of max|twin| (sum order, FMA outside the
alpha clip), and its culled walk bit-equal (image and blocks_done) to its
unculled instantiation, at tiles 16 and 32; B2 rows within ``ROWS_TOL``
of the twin, measured by ``rows_error`` against each column group's largest value and each row's
own (f32: 1e-4, summation order; bf16: one or two bf16 units in the last
place); B3 bit-equal on the same rows. B4 within 1e-4 of max|twin|; B5
rows, and B3's sums of them, within ``GRAD_ROWS_TOL`` of each column
group's largest value and of each entry's own magnitude
(``grad_rows_error``), in f32 and bf16, at widths of B5's cluster kernel
(D = 3, 20, 131, 256) and of its colour slices plus geometry kernel
(D = 300, 512, 600), each of those two launches also alone against its
twin's columns; two B5 launches bit-equal; the colour slices' columns
bit-equal to the cluster kernel's where both take the width (their
weights are the same instructions). B4 at the same widths and at 600
launches its cluster kernel in the channel slices its width selects
(``train_fwd_cluster``: one slice up to 256 channels, two at 300 and 512,
three at 600); its alpha and exit blocks are bit-equal to B1's on the same
geometry (the same weights; the wide kernel they were once held to is
gone), and two B4 launches give the same outputs bit for bit. B6's live striped rows within
``ROWS_TOL`` of its twin and bit-equal to B2's rows through ``slot_pos``,
also at D = 200, 300, 600, 1100 (B2's clusters of 2, 3, 5, 5 CTAs);
B7 bit-equal to its twin and to B3 on the same rows. S1's rows within one
bf16 unit of the twin's (they are expected bit-equal) and scattered to
``pos``; its probe reads 19. The tiled path's regime, ``trans_eps`` = 0
(every block walked): B4 and B5 at D = 3 and 4, and B2 with one zero
channel, held by the same limits. B5's geometry launch at D = 5, 515, 700
(P = 64 pixels a rank, one pixel group), 1030 (P = 32: one group at tile
16, two at tile 32), 2051 (P = 16: one group, four) and 4096 (P = 8: two,
eight; ``geom_cluster``), against the twin by ``GRAD_ROWS_TOL`` (f32), two
launches bit-equal, and its columns 0:6 against the sums of B5's rows'
geometry over 512-channel chunks of the colours. B2 at
D = 1024 (DINO's width) in f32 and bf16 by ``ROWS_TOL``, B6 bit-equal.
At tiles 8, 12, 24 and 64 (ghost pixel slots; at 64 pixel groups, B1's
and B4's exit vote): B1 by the same limits and
bit-equal to its unculled walk, its exit blocks equal to the twin's; B2 by
``ROWS_TOL``, B6's live rows bit-equal to B2's, B3 and B7 bit-equal to
their twins and each other; B4's cluster kernel within 1e-4, its exit
blocks the twin's; B5 at D = 131 and 515 (f32 and bf16) and its
geometry kernel at D = 4097 by ``GRAD_ROWS_TOL``. B2 and B6 on a view of
69,632 tiles (272 x 256 at tile 1, past the 65,535 of a grid's y) by the
same limits. A plan of tile 0 raises a ``ValueError`` in every
tile-dependent wrapper, with no launch.

The encoders have no kernel of their own; they are held on the card
against the CPU in f32 (TF32 off): a reduced LSeg network through
``LSegEncoder.__call__`` and ``staged_apply``, a reduced DINO ViT, a
reduced CLIP text tower (1e-4 of the output's max), and ``resize`` in each
method and direction the encoders use on inputs in [0, 1] (3e-5: the
card's antialiased kernel differs from the CPU's by 1.24e-5 on the
840x1296 -> 480^2 case).
"""

import pytest
import torch

from tpugs_torch.encoders.base import LinearRGBEncoder
from tpugs_torch.experiments import scatter_write as S1
from tpugs_torch.raster import kernels as K
from tpugs_torch.raster.colors import prepare_colors
from tpugs_torch.raster.pack import pack_isect_all
from tpugs_torch.raster.plan import build_plan, with_scatter_extras
from tpugs_torch.raster.projection import project
from tpugs_torch.raster import train as T
from tpugs_torch.raster.tiles import image_to_tiles
from tpugs_torch.utils.synthetic import orbit_cameras, random_scene

W, H = 200, 136


@pytest.fixture(scope="module", params=[16, 32])
def view(request):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    tile = request.param
    scene = random_scene(6000, seed=1, extent=0.6, scale_range=(0.01, 0.12), device="cuda")
    cams = orbit_cameras(1, W, H, radius=3.0, device="cuda")
    vm, Km = cams.viewmats[0], cams.Ks[0]
    proj = project(scene.means, scene.quats, scene.scales, scene.opacities, vm, Km, W, H)
    plan = build_plan(proj, W, H, tile)
    pack = pack_isect_all(proj, prepare_colors(scene.means, scene.colors_all, vm, 3), plan)
    img, _ = K.render_tiles(pack, plan)
    feats = LinearRGBEncoder(40, seed=2, device="cuda")(img[..., :3]).contiguous()
    return plan, pack, feats


def _rel(got, ref):
    return float((got.float() - ref.float()).abs().max() / ref.float().abs().max())


def test_render_kernel_matches_twin(view):
    plan, pack, _ = view
    got, _ = K.render_tiles(pack, plan)
    torch.cuda.synchronize()
    ref, _ = K.render_tiles_plain(pack, plan)
    assert _rel(got, ref) <= 1e-4


def test_render_cull_is_bit_equal_to_the_unculled_kernel(view):
    """B1's per-warp cull skips only pairs whose alpha is 0 at every pixel
    of the warp: the image and blocks_done equal the unculled
    instantiation's bit for bit, each instantiation counts its own
    launches, and two launches give the same bits."""
    plan, pack, _ = view
    K.LAUNCHES.reset()
    img, done = K.render_tiles(pack, plan)
    img_u, done_u = K.render_tiles_unculled(pack, plan)
    img2, done2 = K.render_tiles(pack, plan)
    torch.cuda.synchronize()
    assert (K.LAUNCHES.render, K.LAUNCHES.render_unculled) == (2, 1)
    assert torch.equal(img, img_u) and torch.equal(done, done_u)
    assert torch.equal(img, img2) and torch.equal(done, done2)
    ref, done_t = K.render_tiles_plain(pack, plan)
    assert _rel(img_u, ref) <= 1e-4
    nb = (plan.tile_ends - plan.tile_starts + 127) // 128
    assert bool((done <= nb).all()) and bool((done_t <= nb).all())


def test_render_kernel_resident_clusters():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    from tpugs_torch.kernels.build import load_library

    lib = load_library()
    for ts in (16, 32):
        for cull in (0, 1):
            assert lib.tpugs_render_max_clusters(ts, cull) > 0, (ts, cull)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_adjoint_kernel_matches_twin(view, dtype):
    plan, pack, feats = view
    f = feats.to(dtype)
    got = K.adjoint_rows(pack, f, plan)
    torch.cuda.synchronize()
    _, of_group, of_row = K.rows_error(got, K.adjoint_rows_plain(pack, f, plan), f.shape[-1])
    group_tol, row_tol = K.ROWS_TOL[dtype]
    assert of_group <= group_tol and of_row <= row_tol, (of_group, of_row)


@pytest.mark.parametrize("extra", [0, 300])
def test_adjoint_kernel_weights_match_twin_per_pixel(view, extra):
    """With one-hot pixel features each f32 row holds its intersection's
    per-pixel weights. No (pixel, Gaussian) pair may be kept by one side of
    the 1/255 alpha clip and dropped by the other (a step of (1/255)*T),
    and normal weights agree to 1e-4 (transmittance products in another
    order). Subnormal weights, of pixels whose T has all but vanished, are
    left out. The tile's pixels, and so its weights and its exit, are split
    over the ranks of a cluster: S = 3 or 5 slices (tile 16), 9 or 11
    (tile 32: two clusters per tile, one CTA without columns); a rank that
    exits alone, or late, shows as whole wrong blocks."""
    plan, pack, _ = view
    tspx = plan.tile_size**2
    eye = torch.zeros((plan.n_tiles, tspx, tspx + extra), device="cuda")
    eye[:, :, :tspx] = torch.eye(tspx, device="cuda")
    got = K.adjoint_rows(pack, eye, plan)[:, :tspx]
    torch.cuda.synchronize()
    ref = K.adjoint_rows_plain(pack, eye, plan)[:, :tspx]
    normal = torch.maximum(got.abs(), ref.abs()) >= torch.finfo(torch.float32).tiny
    assert not ((got == 0) != (ref == 0))[normal].any()
    both = normal & (ref != 0)
    assert float(((got - ref).abs() / ref.abs())[both].max()) <= 1e-4


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [200, 300, 600, 1100])
def test_adjoint_clusters_match_twin_and_b6(view, d, dtype):
    """B2 with S = 2, 3, 5, 9 channel slices (clusters of C = 2, 3, 5, 5
    CTAs; at S = 9 two clusters per tile and one CTA without columns)
    against its twin by ``rows_error``; B6 bit-equal to B2."""
    plan, pack, feats = view
    img, _ = K.render_tiles(pack, plan)
    f = LinearRGBEncoder(d, seed=4, device="cuda")(img[..., :3]).to(dtype).contiguous()
    got = K.adjoint_rows(pack, f, plan)
    splan = with_scatter_extras(plan)
    striped = K.adjoint_scatter_rows(pack, f, splan)
    torch.cuda.synchronize()
    _, of_group, of_row = K.rows_error(got, K.adjoint_rows_plain(pack, f, plan), d)
    group_tol, row_tol = K.ROWS_TOL[dtype]
    assert of_group <= group_tol and of_row <= row_tol, (of_group, of_row)
    real = splan.gauss_pos.long()
    assert torch.equal(striped[splan.slot_pos.long()[real]], got[real])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_reduce_kernel_bit_equal_to_twin(view, dtype):
    plan, pack, feats = view
    rows = K.adjoint_rows(pack, feats.to(dtype), plan)
    got = K.reduce_rows(rows, plan, feats.shape[-1] + 1)
    torch.cuda.synchronize()
    assert torch.equal(got, K.reduce_rows_plain(rows, plan, feats.shape[-1] + 1))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_adjoint_scatter_kernel_matches_twin_and_b2(view, dtype):
    plan, pack, feats = view
    f = feats.to(dtype)
    splan = with_scatter_extras(plan)
    got = K.adjoint_scatter_rows(pack, f, splan)
    rows = K.adjoint_rows(pack, f, plan)
    torch.cuda.synchronize()
    real = splan.gauss_pos.long()
    live = splan.slot_pos.long()[real]
    ref = K.adjoint_scatter_rows_plain(pack, f, splan)
    _, of_group, of_row = K.rows_error(got[live], ref[live], f.shape[-1])
    group_tol, row_tol = K.ROWS_TOL[dtype]
    assert of_group <= group_tol and of_row <= row_tol, (of_group, of_row)
    assert torch.equal(got[live], rows[real])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_stripe_sum_kernel_bit_equal_to_twin_and_b3(view, dtype):
    plan, pack, feats = view
    f = feats.to(dtype)
    splan = with_scatter_extras(plan)
    striped = K.adjoint_scatter_rows(pack, f, splan)
    n_cols = f.shape[-1] + 1
    got = K.reduce_striped(striped, splan, n_cols)
    cols = K.reduce_striped(striped, splan, n_cols, unpermute=False)
    b3 = K.reduce_rows(K.adjoint_rows(pack, f, plan), plan, n_cols)
    torch.cuda.synchronize()
    assert torch.equal(got, K.reduce_striped_plain(striped, splan, n_cols))
    assert torch.equal(got, b3)
    assert torch.equal(cols, got[splan.slot_order])


@pytest.mark.parametrize("iters", [0, 16, 48])
def test_scatter_write_kernel_matches_twin(iters):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    pos = S1.permutation(64 * 128).cuda()
    contig = S1.run_variant(pos, False, iters)
    scatter = S1.run_variant(pos, True, iters)
    torch.cuda.synchronize()
    ref = S1.scatter_write_plain(torch.empty_like(contig), None, iters)
    assert _rel(contig, ref) <= 2.0**-7
    assert torch.equal(scatter[pos.long()], contig)


def test_async_copy_probe_reads_19():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    assert int(S1.async_copy_probe(torch.arange(64, dtype=torch.int32, device="cuda"), 2)) == 19


# B4's and B5's cluster kernels at D = 3, 20, 131, 256 (clusters of 2 CTAs at
# tile 16, 8 at tile 32); above, B4 in 2 or 3 channel slices and B5 in 3, 4
# or 5 colour slices plus its geometry kernel
@pytest.fixture(scope="module", params=[3, 20, 131, 256, 300, 512, 600])
def train_packs(view, request):
    plan, pack, _ = view
    d = request.param
    gen = torch.Generator(device="cuda").manual_seed(d)
    geom = pack[:, :8].contiguous()
    cols = torch.rand((plan.T_padded, d), device="cuda", generator=gen)
    return plan, geom, cols, gen


def test_train_fwd_kernel_matches_twin(train_packs):
    plan, geom, cols, _ = train_packs
    K.LAUNCHES.reset()
    img, alpha, done = T.train_forward(geom, cols, plan)
    torch.cuda.synchronize()
    assert (K.LAUNCHES.train_fwd, K.LAUNCHES.train_fwd_vote) == (1, 0)
    d = cols.shape[1]
    assert T.train_fwd_cluster(plan.tile_size, d)[3] == (1 if d <= 256 else 2 if d <= 512 else 3)
    img_t, alpha_t, done_t = T.train_forward_plain(geom, cols, plan)
    assert _rel(img, img_t) <= 1e-4 and _rel(alpha, alpha_t) <= 1e-4
    assert torch.equal(done, done_t)


def test_train_fwd_cluster_kernel_matches_the_wide_kernel(train_packs):
    """The wide kernel is gone. The cluster kernel computes every weight
    with B1's instructions in its order (pair_alpha, the sequential texc
    and T products), in every channel slice: alpha and the exit blocks are
    bit-equal to B1's 1 - T and blocks_done on the same geometry."""
    plan, geom, cols, _ = train_packs
    img, alpha, done = T.train_forward(geom, cols, plan)
    pack16 = torch.zeros((plan.T_padded, 16), device="cuda")
    pack16[:, :8] = geom
    K.LAUNCHES.reset()
    tiles, done_b1 = K.render_tiles(pack16, plan)
    torch.cuda.synchronize()
    assert (K.LAUNCHES.train_fwd, K.LAUNCHES.render) == (0, 1)
    ts = plan.tile_size
    inside = image_to_tiles(torch.ones((plan.height, plan.width, 1), device="cuda"), ts) > 0
    alpha_t = image_to_tiles(alpha[..., None], ts)
    assert torch.equal(torch.where(inside, alpha_t, 0.0),
                       torch.where(inside, tiles[..., 4:5], 0.0))
    assert torch.equal(done, done_b1)


def test_train_fwd_kernel_is_deterministic(train_packs):
    """Two launches give the same image, alpha and exit blocks bit for bit,
    on a view with an empty tile and a tile that exits early."""
    plan, geom, cols, _ = train_packs
    first = T.train_forward(geom, cols, plan)
    second = T.train_forward(geom, cols, plan)
    torch.cuda.synchronize()
    spans = plan.tile_ends - plan.tile_starts
    assert bool((spans == 0).any()), "an empty tile"
    assert bool((first[2] < (spans + 127) // 128).any()), "a tile that exits early"
    assert all(torch.equal(a, b) for a, b in zip(first, second))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_train_bwd_kernel_matches_twin(train_packs, dtype):
    plan, geom, cols, gen = train_packs
    d = cols.shape[1]
    img, alpha, done = T.train_forward(geom, cols, plan)
    g = torch.randn(img.shape, device="cuda", generator=gen)
    hterm = torch.randn(alpha.shape, device="cuda", generator=gen) * (1.0 - alpha)
    grem0 = (g * img).sum(-1)
    args = (geom, cols, g, hterm, grem0, done, plan, dtype)
    K.LAUNCHES.reset()
    rows = T.train_rows(*args)
    sums = K.reduce_rows(rows, plan, d + T.GEOM_GRADS)
    torch.cuda.synchronize()
    wide = T.train_cluster(plan.tile_size, d) is None
    launched = K.LAUNCHES.train_bwd, K.LAUNCHES.train_bwd_colour, K.LAUNCHES.train_bwd_geom
    assert launched == ((0, 1, 1) if wide else (1, 0, 0))
    rows_t, mags = T.train_rows_plain(*args, magnitudes=True)
    group_tol, entry_tol = T.GRAD_ROWS_TOL[dtype]
    _, of_group, of_entry = T.grad_rows_error(rows, rows_t, d, mags)
    assert of_group <= group_tol and of_entry <= entry_tol, (of_group, of_entry)
    _, of_group, of_entry = T.grad_rows_error(
        sums, K.reduce_rows_plain(rows_t, plan, d + 8), d, K.reduce_rows_plain(mags, plan, d + 8))
    assert of_group <= group_tol and of_entry <= entry_tol, (of_group, of_entry)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_train_bwd_kernel_is_deterministic(train_packs, dtype):
    """Two launches give the same rows bit for bit (no atomics; the
    cluster's partial rows are summed in rank order), on a view with an
    empty tile and a tile that exits early."""
    plan, geom, cols, gen = train_packs
    img, alpha, done = T.train_forward(geom, cols, plan)
    spans = plan.tile_ends - plan.tile_starts
    assert bool((spans == 0).any()), "an empty tile"
    assert bool((done < (spans + 127) // 128).any()), "a tile that exits early"
    g = torch.randn(img.shape, device="cuda", generator=gen)
    hterm = torch.randn(alpha.shape, device="cuda", generator=gen) * (1.0 - alpha)
    args = (geom, cols, g, hterm, (g * img).sum(-1), done, plan, dtype)
    first = T.train_rows(*args)
    second = T.train_rows(*args)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


def _launch_alone(fn, args, layout, d, dtype):
    """One of ``train_rows``' two launches above 256 channels, alone, into
    zero rows: the colour slices' entry ``fn``, or with ``fn`` None the
    geometry kernel."""
    from tpugs_torch.kernels.build import load_library

    geom, cols, g, hterm, grem0, done, plan = args[:7]
    out = torch.zeros((plan.T_padded, T.grad_row_width(d)), dtype=dtype, device="cuda")
    if fn is None:
        T._launch_geom(load_library(), geom, cols, g, hterm, grem0, done, plan, out, layout)
    else:
        assert T._launch_train_bwd(fn, geom, cols, g, hterm, grem0, done, plan, out,
                                   layout) == 0
    torch.cuda.synchronize()
    return out


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_train_bwd_colour_and_geometry_launches_alone(train_packs, dtype):
    """Above 256 channels: the colour slices alone against the colour-only
    twin (columns 0:D; the others stay 0), the geometry kernel alone against
    the twin's geometry and pad columns (it writes the colour columns only of
    the skipped blocks' rows, 0), each within GRAD_ROWS_TOL and bit-equal over two launches.
    Where the cluster kernel also takes the width (D <= 256, one slice),
    the colour slices' columns equal its columns bit for bit."""
    from tpugs_torch.kernels.build import load_library

    plan, geom, cols, gen = train_packs
    d = cols.shape[1]
    img, alpha, done = T.train_forward(geom, cols, plan)
    g = torch.randn(img.shape, device="cuda", generator=gen)
    hterm = torch.randn(alpha.shape, device="cuda", generator=gen) * (1.0 - alpha)
    args = (geom, cols, g, hterm, (g * img).sum(-1), done, plan, dtype)
    lib = load_library()
    bf16 = dtype == torch.bfloat16
    colour_fn = lib.tpugs_train_bwd_colour_bf16 if bf16 else lib.tpugs_train_bwd_colour_f32
    colour = T.rank_groups(plan.tile_size) + T.fwd_slices(d, T.COLOUR_SLICE_CHANNELS)
    rows_c = _launch_alone(colour_fn, args, colour, d, dtype)
    assert torch.equal(rows_c, _launch_alone(colour_fn, args, colour, d, dtype))
    assert not rows_c[:, d:].any()
    group_tol, entry_tol = T.GRAD_ROWS_TOL[dtype]
    if d <= T.CLUSTER_MAX_CHANNELS:
        assert torch.equal(rows_c[:, :d], T.train_rows(*args)[:, :d])
        return
    ref_c, mags_c = T.train_rows_plain(*args, magnitudes=True, colour_only=True)
    _, of_group, of_entry = T.grad_rows_error(rows_c[:, :d], ref_c, d, mags_c)
    assert of_group <= group_tol and of_entry <= entry_tol, (of_group, of_entry)
    layout = T.geom_cluster(plan.tile_size, d)
    rows_g = _launch_alone(None, args, layout, d, dtype)
    assert torch.equal(rows_g, _launch_alone(None, args, layout, d, dtype))
    assert not rows_g[:, :d].any()  # skipped blocks' rows are written 0, whole
    rows_t, mags = T.train_rows_plain(*args, magnitudes=True)
    _, of_group, of_entry = T.grad_rows_error(rows_g[:, d:], rows_t[:, d:], 0, mags[:, d:])
    assert of_group <= group_tol and of_entry <= entry_tol, (of_group, of_entry)
    assert not rows_g[:, d + T.GEOM_GRADS:].any()


# B5's geometry launch at each pixels-per-rank width of ``geom_cluster``
# (GEOM_WIDTHS: 64 up to 700 channels, 32, 16, 8) and so one to eight
# pixel groups, at trans_eps 0 (render_tiled's regime) and the default
@pytest.mark.parametrize("d, trans_eps", [(5, 0.0), (515, 0.0), (1030, T.TRANS_EPS),
                                          (700, T.TRANS_EPS), (2051, T.TRANS_EPS),
                                          (4096, 0.0)])
def test_train_geom_rows_match_twin_and_the_chunked_geometry(view, d, trans_eps):
    """``train_geom_rows`` (8 geometry columns, any D up to the cap) within
    GRAD_ROWS_TOL (f32) of ``train_rows_plain(..., geometry_only=True)``,
    rows and B3's sums, counting only its own launch; its columns 0:6
    summed per Gaussian equal the sums of ``train_rows``' geometry over
    512-channel chunks of the colours (``hterm`` in the first only) within
    the same limits; two launches bit-equal."""
    plan, pack, _ = view
    gen = torch.Generator(device="cuda").manual_seed(d)
    geom = pack[:, :8].contiguous()
    cols = torch.rand((plan.T_padded, d), device="cuda", generator=gen)
    img, alpha, done = T.train_forward(geom, cols, plan, trans_eps)
    g = torch.randn(img.shape, device="cuda", generator=gen)
    hterm = torch.randn(alpha.shape, device="cuda", generator=gen) * (1.0 - alpha)
    args = (geom, cols, g, hterm, (g * img).sum(-1), done, plan)
    K.LAUNCHES.reset()
    rows = T.train_geom_rows(*args)
    torch.cuda.synchronize()
    grouped = int(T.geom_cluster(plan.tile_size, d)[2] > 1)  # the group-order add
    assert K.LAUNCHES.snapshot() == {**{k: 0 for k in K.LAUNCHES.snapshot()},
                                     "train_bwd_geom": 1, "train_bwd_groups": grouped}
    assert rows.shape == (plan.T_padded, T.GEOM_GRADS) and rows.dtype == torch.float32
    assert torch.equal(rows, T.train_geom_rows(*args))
    sums = K.reduce_rows(rows, plan, T.GEOM_GRADS)
    rows_t, mags = T.train_rows_plain(*args, magnitudes=True, geometry_only=True)
    sums_m = K.reduce_rows_plain(mags, plan, T.GEOM_GRADS)
    group_tol, entry_tol = T.GRAD_ROWS_TOL[torch.float32]
    _, of_group, of_entry = T.grad_rows_error(rows, rows_t, 0, mags)
    assert of_group <= group_tol and of_entry <= entry_tol, (of_group, of_entry)
    _, of_group, of_entry = T.grad_rows_error(
        sums, K.reduce_rows_plain(rows_t, plan, T.GEOM_GRADS), 0, sums_m)
    assert of_group <= group_tol and of_entry <= entry_tol, (of_group, of_entry)
    chunked = 0.0
    for i, (a, b) in enumerate((a, min(a + 512, d)) for a in range(0, d, 512)):
        g_c = g[..., a:b].contiguous()
        rows_c = T.train_rows(geom, cols[:, a:b].contiguous(), g_c,
                              hterm if i == 0 else torch.zeros_like(hterm),
                              (g_c * img[..., a:b]).sum(-1), done, plan)
        chunked = chunked + K.reduce_rows(rows_c, plan, b - a + T.GEOM_GRADS)[:, b - a:]
    chunked[:, 6:] = sums[:, 6:]  # the absolute columns do not add over chunks
    _, of_group, of_entry = T.grad_rows_error(sums, chunked, 0, sums_m)
    assert of_group <= group_tol and of_entry <= entry_tol, (of_group, of_entry)


# The tiled path's regime (render_tiled, backproject_tiled): no early exit,
# B4 and B5 at D = 3 and 4 (RGB, RGB + depth), B2 with one zero channel.
@pytest.mark.parametrize("d", [3, 4])
def test_train_kernels_without_early_exit_match_twins(view, d):
    """At trans_eps = 0 a tile walks all its blocks unless T underflows to
    0 at every pixel (each exit test is a strict T > trans_eps): B4 within
    1e-4 of its twin, B5's f32 rows and B3's sums of them within
    GRAD_ROWS_TOL."""
    plan, pack, _ = view
    gen = torch.Generator(device="cuda").manual_seed(11 + d)
    geom = pack[:, :8].contiguous()
    cols = torch.rand((plan.T_padded, d), device="cuda", generator=gen)
    K.LAUNCHES.reset()
    img, alpha, done = T.train_forward(geom, cols, plan, 0.0)
    torch.cuda.synchronize()
    assert K.LAUNCHES.train_fwd == 1
    img_t, alpha_t, done_t = T.train_forward_plain(geom, cols, plan, 0.0)
    assert _rel(img, img_t) <= 1e-4 and _rel(alpha, alpha_t) <= 1e-4
    assert int(done.sum()) > int(T.train_forward(geom, cols, plan)[2].sum())
    # A tile stops early only once T is 0 at all its pixels (f32 underflow,
    # alpha 1), and the twin's products underflow in another order: where
    # the walks end apart, both alphas are 1.
    inside = image_to_tiles(torch.ones_like(alpha)[..., None], plan.tile_size)[..., 0] > 0

    def opaque(a):
        return ((image_to_tiles(a[..., None], plan.tile_size)[..., 0] == 1.0) | ~inside).all(1)

    short = done < (plan.tile_ends - plan.tile_starts + 127) // 128
    assert bool(opaque(alpha)[short].all())
    apart = done != done_t
    assert bool((opaque(alpha) & opaque(alpha_t))[apart].all())
    g = torch.randn(img.shape, device="cuda", generator=gen)
    hterm = torch.randn(alpha.shape, device="cuda", generator=gen) * (1.0 - alpha)
    args = (geom, cols, g, hterm, (g * img).sum(-1), done, plan, torch.float32)
    rows = T.train_rows(*args)
    sums = K.reduce_rows(rows, plan, d + T.GEOM_GRADS)
    torch.cuda.synchronize()
    rows_t, mags = T.train_rows_plain(*args, magnitudes=True)
    group_tol, entry_tol = T.GRAD_ROWS_TOL[torch.float32]
    _, of_group, of_entry = T.grad_rows_error(rows, rows_t, d, mags)
    assert of_group <= group_tol and of_entry <= entry_tol, (of_group, of_entry)
    _, of_group, of_entry = T.grad_rows_error(
        sums, K.reduce_rows_plain(rows_t, plan, d + 8), d, K.reduce_rows_plain(mags, plan, d + 8))
    assert of_group <= group_tol and of_entry <= entry_tol, (of_group, of_entry)


def test_adjoint_kernel_one_zero_channel_without_early_exit(view):
    """``backproject_tiled`` without features: B2 on one zero channel at
    trans_eps = 0, whose ones-column carries the weights (within ROWS_TOL
    of the twin), and B3's sums of it bit-equal to the twin's."""
    plan, pack, _ = view
    feats = torch.zeros((plan.n_tiles, plan.tile_size**2, 1), device="cuda")
    rows = K.adjoint_rows(pack, feats, plan, 0.0)
    torch.cuda.synchronize()
    ref = K.adjoint_rows_plain(pack, feats, plan, 0.0)
    _, of_group, of_row = K.rows_error(rows, ref, 1)
    group_tol, row_tol = K.ROWS_TOL[torch.float32]
    assert of_group <= group_tol and of_row <= row_tol, (of_group, of_row)
    early = K.adjoint_rows(pack, feats, plan)  # the default trans_eps skips blocks
    assert int((rows[:, 1] != 0).sum()) > int((early[:, 1] != 0).sum())
    sums = K.reduce_rows(rows, plan, 2)
    torch.cuda.synchronize()
    assert torch.equal(sums, K.reduce_rows_plain(rows, plan, 2))
    assert bool((sums[:, 0] == 0).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_adjoint_kernel_at_dino_width(view, dtype):
    plan, pack, _ = view
    img, _ = K.render_tiles(pack, plan)
    f = LinearRGBEncoder(1024, seed=6, device="cuda")(img[..., :3]).to(dtype).contiguous()
    got = K.adjoint_rows(pack, f, plan)
    splan = with_scatter_extras(plan)
    striped = K.adjoint_scatter_rows(pack, f, splan)
    torch.cuda.synchronize()
    _, of_group, of_row = K.rows_error(got, K.adjoint_rows_plain(pack, f, plan), 1024)
    group_tol, row_tol = K.ROWS_TOL[dtype]
    assert of_group <= group_tol and of_row <= row_tol, (of_group, of_row)
    real = splan.gauss_pos.long()
    assert torch.equal(striped[splan.slot_pos.long()[real]], got[real])


def _card_and_cpu(build):
    """(module on the card, the same module on the CPU), seeded weights."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from tpugs_torch.encoders.vit import init_flax_like_

    cpu = init_flax_like_(build("cpu"), seed=5)
    card = build("cuda")
    card.load_state_dict(cpu.state_dict())
    return card, cpu


def _close(got, ref, frac=1e-4):
    ref = ref.float()
    err = float((got.float().cpu() - ref).abs().max())
    assert err <= frac * float(ref.abs().max()), err


def test_lseg_encoder_on_the_card_matches_the_cpu():
    from tpugs_torch.encoders.lseg import LSegEncoder, LSegNet
    from tpugs_torch.encoders.vit import ViTConfig

    cfg = ViTConfig(image_size=64, patch_size=16, width=64, layers=4, heads=4)
    card, cpu = _card_and_cpu(lambda dev: LSegNet(
        features=32, out_dim=48, vit_cfg=cfg, hooks=(0, 1, 2, 3),
        layer_channels=(16, 32, 64, 64), device=dev))
    enc_card = LSegEncoder.from_net(card, crop_size=64)
    enc_cpu = LSegEncoder.from_net(cpu, crop_size=64)
    rgbs = torch.rand((2, 70, 90, 3), generator=torch.Generator().manual_seed(0))
    _close(enc_card(rgbs[0].cuda()), enc_cpu(rgbs[0]))
    staged = enc_card.staged_apply(rgbs.cuda())
    assert staged.dtype == torch.bfloat16 and staged.shape == (2, 70, 90, 48)
    _close(staged, enc_cpu.staged_apply(rgbs).float(), 2.0**-7)


def test_dino_vit_on_the_card_matches_the_cpu():
    from tpugs_torch.encoders.dino import DinoEncoder
    from tpugs_torch.encoders.vit import DINOV2_VIT_L14_REG, VisionTransformer
    import dataclasses

    cfg = dataclasses.replace(DINOV2_VIT_L14_REG, image_size=56, width=64, heads=4, layers=3)
    card, cpu = _card_and_cpu(lambda dev: VisionTransformer(cfg, device=dev))
    img = torch.rand((50, 60, 3), generator=torch.Generator().manual_seed(1))
    _close(DinoEncoder.from_vit(card, 70)(img.cuda()), DinoEncoder.from_vit(cpu, 70)(img))


def test_clip_text_tower_on_the_card_matches_the_cpu():
    from tpugs_torch.encoders.clip_text import CLIPTextTower

    card, cpu = _card_and_cpu(lambda dev: CLIPTextTower(
        vocab_size=300, context_length=77, width=64, heads=4, layers=3, embed_dim=32,
        device=dev))
    tokens = torch.randint(1, 299, (3, 77), generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        _close(card(tokens.cuda()), cpu(tokens))


@pytest.mark.parametrize("method, size, out", [
    ("bilinear", (840, 1296), (480, 480)), ("bilinear", (240, 240), (840, 1296)),
    ("cubic", (37, 37), (64, 64)), ("cubic", (64, 64), (37, 37)),
    ("nearest", (64, 64), (840, 1296))])
def test_resize_on_the_card_matches_the_cpu(method, size, out):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from tpugs_torch.encoders.resize import resize

    x = torch.rand((1, 8, *size), generator=torch.Generator().manual_seed(3))
    got = resize(x.cuda(), out, method)
    ref = resize(x, out, method)
    assert float((got.cpu() - ref).abs().max()) <= 3e-5


def test_train_step_after_a_refine_matches_twins():
    """The trainer refines a small scene on the card (strategy "default",
    every Gaussian grows, N padded to a multiple of 256); no padded row is
    valid in ``project``; the next step's recorded B4, B5 and B3 inputs
    give the kernels' outputs within the limits above (B3 bit-equal)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    from tpugs_torch.train.config import TrainConfig
    from tpugs_torch.train.trainer import Trainer

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = TrainConfig(strategy="default", feature_dim=8, feature_out_dim=4, sh_degree=1,
                      random_bkgd=False, grow_grad2d=1e-12, refine_start_iter=1,
                      refine_every=1, capacity_multiple=256)
    scene = random_scene(1500, seed=3, extent=0.8, scale_range=(0.01, 0.05), device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(4)
    scene = scene.replace(features=torch.randn((1500, 8), device="cuda", generator=gen) * 0.1,
                          feature_proj=torch.randn((8, 4), device="cuda", generator=gen))
    cams = orbit_cameras(2, W, H, radius=2.5, device="cuda")
    staged = {"images": torch.rand((2, H, W, 3), device="cuda", generator=gen),
              "viewmats": cams.viewmats, "Ks": cams.Ks}
    tr = Trainer(cfg, scene, 1.0, teacher=LinearRGBEncoder(4, device="cuda"), width=W,
                 height=H, device="cuda")
    tr.train_chunk(staged, 2, [0, 1])
    info = tr.refine()
    n = tr.scene.num_gaussians
    assert info["alive"] > 1500 and n % 256 == 0 and n - 256 < info["alive"] <= n
    s = tr.scene
    proj = project(s.means.detach(), s.quats.detach(), s.scales.detach(), s.opacities.detach(),
                   cams.viewmats[0], cams.Ks[0], W, H)
    assert not bool(proj.valid[info["alive"]:].any()) and bool(proj.valid.any())
    tr.record = seen = {}
    K.LAUNCHES.reset()
    out = tr.train_chunk(staged, 1, [0])
    torch.cuda.synchronize()
    assert bool(torch.isfinite(torch.as_tensor(out["loss"])).all())
    assert min(K.LAUNCHES.train_fwd, K.LAUNCHES.train_bwd, K.LAUNCHES.reduce) >= 1
    geom, cols, plan, eps, img, alpha, done, g, hterm, grem0, dtype, rows = (seen[k] for k in (
        "geom", "cols", "plan", "trans_eps", "image", "alpha", "blocks_done", "g_image",
        "hterm", "grem0", "contrib_dtype", "rows"))
    assert plan.num_gaussians == n
    img_t, alpha_t, done_t = T.train_forward_plain(geom, cols, plan, eps)
    assert _rel(img, img_t) <= 1e-4 and _rel(alpha, alpha_t) <= 1e-4
    assert torch.equal(done, done_t)
    d = cols.shape[1]
    rows_t, mags = T.train_rows_plain(geom, cols, g, hterm, grem0, done, plan, dtype,
                                      magnitudes=True)
    group_tol, entry_tol = T.GRAD_ROWS_TOL[dtype]
    _, of_group, of_entry = T.grad_rows_error(rows, rows_t, d, mags)
    assert of_group <= group_tol and of_entry <= entry_tol, (of_group, of_entry)
    assert torch.equal(K.reduce_rows(rows, plan, d + T.GEOM_GRADS),
                       K.reduce_rows_plain(rows, plan, d + T.GEOM_GRADS))


# Tiles other than 16 and 32: the kernels' ranks and pixel groups with
# ghost slots (B1, B2/B6, B4, B5), the same limits as above; at 64 pixel
# groups, B1's and B4's exit vote.
@pytest.fixture(scope="module", params=[8, 12, 24, 64])
def tile_view(request):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    tile = request.param
    scene = random_scene(6000, seed=1, extent=0.6, scale_range=(0.01, 0.12), device="cuda")
    cams = orbit_cameras(1, W, H, radius=3.0, device="cuda")
    vm, Km = cams.viewmats[0], cams.Ks[0]
    proj = project(scene.means, scene.quats, scene.scales, scene.opacities, vm, Km, W, H)
    plan = build_plan(proj, W, H, tile)
    pack = pack_isect_all(proj, prepare_colors(scene.means, scene.colors_all, vm, 3), plan)
    img, _ = K.render_tiles(pack, plan)
    feats = LinearRGBEncoder(40, seed=2, device="cuda")(img[..., :3]).contiguous()
    return plan, pack, feats


def test_render_kernel_at_other_tiles(tile_view):
    """B1 with ghost rectangles within 1e-4 of its twin, its exit blocks
    the twin's, its culled walk bit-equal to the unculled one, one launch
    each (and one vote each where a tile is pixel groups); its clusters
    fit."""
    from tpugs_torch.kernels.build import load_library

    plan, pack, _ = tile_view
    voted = int(K.render_cluster(plan.tile_size)[2] > 1)
    K.LAUNCHES.reset()
    img, done = K.render_tiles(pack, plan)
    img_u, done_u = K.render_tiles_unculled(pack, plan)
    torch.cuda.synchronize()
    assert (K.LAUNCHES.render, K.LAUNCHES.render_unculled, K.LAUNCHES.render_vote) == (
        1, 1, 2 * voted)
    assert torch.equal(img, img_u) and torch.equal(done, done_u)
    ref, done_t = K.render_tiles_plain(pack, plan)
    assert _rel(img, ref) <= 1e-4 and torch.equal(done, done_t)
    assert load_library().tpugs_render_max_clusters(plan.tile_size, 1) > 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_adjoint_scatter_and_reduces_at_other_tiles(tile_view, dtype):
    """B2 with a ghost-padded last pixel group within ROWS_TOL of its twin;
    B6's live rows bit-equal to B2's; B3 and B7 bit-equal to their twins
    and to each other."""
    plan, pack, feats = tile_view
    f = feats.to(dtype)
    d = f.shape[-1]
    rows = K.adjoint_rows(pack, f, plan)
    splan = with_scatter_extras(plan)
    striped = K.adjoint_scatter_rows(pack, f, splan)
    sums = K.reduce_rows(rows, plan, d + 1)
    stripes = K.reduce_striped(striped, splan, d + 1)
    torch.cuda.synchronize()
    _, of_group, of_row = K.rows_error(rows, K.adjoint_rows_plain(pack, f, plan), d)
    group_tol, row_tol = K.ROWS_TOL[dtype]
    assert of_group <= group_tol and of_row <= row_tol, (of_group, of_row)
    real = splan.gauss_pos.long()
    assert torch.equal(striped[splan.slot_pos.long()[real]], rows[real])
    assert torch.equal(sums, K.reduce_rows_plain(rows, plan, d + 1))
    assert torch.equal(stripes, K.reduce_striped_plain(striped, splan, d + 1))
    assert torch.equal(stripes, sums)


@pytest.mark.parametrize("d", [131, 515])
def test_train_kernels_at_other_tiles(tile_view, d):
    """B4's cluster kernel (one launch, and the vote where a tile is pixel
    groups) within 1e-4 of its twin, its exit blocks the twin's; B5 (its
    cluster kernel at 131, colour slices plus the geometry kernel at 515,
    with ghost ranks and pixel groups) within GRAD_ROWS_TOL, rows and B3's
    sums, f32 and bf16."""
    plan, pack, _ = tile_view
    gen = torch.Generator(device="cuda").manual_seed(d)
    geom = pack[:, :8].contiguous()
    cols = torch.rand((plan.T_padded, d), device="cuda", generator=gen)
    K.LAUNCHES.reset()
    img, alpha, done = T.train_forward(geom, cols, plan)
    torch.cuda.synchronize()
    voted = int(T.train_fwd_cluster(plan.tile_size, d)[2] > 1)
    assert (K.LAUNCHES.train_fwd, K.LAUNCHES.train_fwd_vote) == (1, voted)
    img_t, alpha_t, done_t = T.train_forward_plain(geom, cols, plan)
    assert _rel(img, img_t) <= 1e-4 and _rel(alpha, alpha_t) <= 1e-4
    assert torch.equal(done, done_t)
    g = torch.randn(img.shape, device="cuda", generator=gen)
    hterm = torch.randn(alpha.shape, device="cuda", generator=gen) * (1.0 - alpha)
    args = (geom, cols, g, hterm, (g * img).sum(-1), done, plan)
    for dtype in (torch.float32, torch.bfloat16):
        rows = T.train_rows(*args, dtype)
        sums = K.reduce_rows(rows, plan, d + T.GEOM_GRADS)
        torch.cuda.synchronize()
        rows_t, mags = T.train_rows_plain(*args, dtype, magnitudes=True)
        group_tol, entry_tol = T.GRAD_ROWS_TOL[dtype]
        _, of_group, of_entry = T.grad_rows_error(rows, rows_t, d, mags)
        assert of_group <= group_tol and of_entry <= entry_tol, (dtype, of_group, of_entry)
        _, of_group, of_entry = T.grad_rows_error(
            sums, K.reduce_rows_plain(rows_t, plan, d + T.GEOM_GRADS), d,
            K.reduce_rows_plain(mags, plan, d + T.GEOM_GRADS))
        assert of_group <= group_tol and of_entry <= entry_tol, (dtype, of_group, of_entry)


def test_train_geom_rows_above_4096_channels(tile_view):
    """The geometry kernel at D = 4097 (8 pixels a rank in pixel groups,
    the absgrad columns included) within GRAD_ROWS_TOL (f32) of its twin,
    one launch."""
    plan, pack, _ = tile_view
    d = 4097
    gen = torch.Generator(device="cuda").manual_seed(d)
    geom = pack[:, :8].contiguous()
    cols = torch.rand((plan.T_padded, d), device="cuda", generator=gen)
    img, alpha, done = T.train_forward(geom, cols, plan)
    g = torch.randn(img.shape, device="cuda", generator=gen)
    hterm = torch.randn(alpha.shape, device="cuda", generator=gen) * (1.0 - alpha)
    args = (geom, cols, g, hterm, (g * img).sum(-1), done, plan)
    K.LAUNCHES.reset()
    rows = T.train_geom_rows(*args)
    torch.cuda.synchronize()
    assert K.LAUNCHES.train_bwd_geom == 1
    rows_t, mags = T.train_rows_plain(*args, magnitudes=True, geometry_only=True)
    group_tol, entry_tol = T.GRAD_ROWS_TOL[torch.float32]
    _, of_group, of_entry = T.grad_rows_error(rows, rows_t, 0, mags)
    assert of_group <= group_tol and of_entry <= entry_tol, (of_group, of_entry)


def test_a_tile_past_the_cap_raises_before_any_launch():
    """Tiles have no cap above any more; a plan of tile 0 is refused: every
    tile-dependent wrapper raises a ValueError, and no kernel launches."""
    import dataclasses

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    scene = random_scene(2000, seed=1, extent=0.6, scale_range=(0.01, 0.12), device="cuda")
    cams = orbit_cameras(1, W, H, radius=3.0, device="cuda")
    vm, Km = cams.viewmats[0], cams.Ks[0]
    proj = project(scene.means, scene.quats, scene.scales, scene.opacities, vm, Km, W, H)
    plan16 = build_plan(proj, W, H, 16)
    pack = pack_isect_all(proj, prepare_colors(scene.means, scene.colors_all, vm, 3), plan16)
    plan = dataclasses.replace(plan16, tile_size=0)
    splan = dataclasses.replace(with_scatter_extras(plan16), tile_size=0)
    feats = torch.zeros((plan16.n_tiles, 0, 8), device="cuda")
    geom, cols = pack[:, :8].contiguous(), torch.zeros((plan.T_padded, 5), device="cuda")
    z = torch.zeros((H, W), device="cuda")
    bwd = (geom, cols, torch.zeros((H, W, 5), device="cuda"), z, z,
           torch.zeros((plan16.n_tiles,), dtype=torch.int32, device="cuda"), plan)
    K.LAUNCHES.reset()
    for call in (lambda: K.render_tiles(pack, plan), lambda: K.adjoint_rows(pack, feats, plan),
                 lambda: K.adjoint_scatter_rows(pack, feats, splan),
                 lambda: T.train_forward(geom, cols, plan), lambda: T.train_rows(*bwd),
                 lambda: T.train_geom_rows(*bwd)):
        with pytest.raises(ValueError, match="at least 1 pixel"):
            call()
    torch.cuda.synchronize()
    assert sum(K.LAUNCHES.snapshot().values()) == 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_adjoint_past_65535_tiles(dtype):
    """B2 and B6 on a 272 x 256 view at tile 1: 69,632 tiles, past the
    65,535 that a grid's y takes, at D = 4; rows by ROWS_TOL, B6's live
    rows bit-equal to B2's, B3 bit-equal to its twin."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    w, h, d = 272, 256, 4
    scene = random_scene(3000, seed=5, extent=0.6, scale_range=(0.01, 0.08), device="cuda")
    cams = orbit_cameras(1, w, h, radius=3.0, device="cuda")
    vm, Km = cams.viewmats[0], cams.Ks[0]
    proj = project(scene.means, scene.quats, scene.scales, scene.opacities, vm, Km, w, h)
    plan = build_plan(proj, w, h, 1)
    assert plan.n_tiles == 69_632
    pack = pack_isect_all(proj, prepare_colors(scene.means, scene.colors_all, vm, 3), plan)
    img, _ = K.render_tiles(pack, plan)
    f = LinearRGBEncoder(d, seed=6, device="cuda")(img[..., :3]).to(dtype).contiguous()
    K.LAUNCHES.reset()
    rows = K.adjoint_rows(pack, f, plan)
    splan = with_scatter_extras(plan)
    striped = K.adjoint_scatter_rows(pack, f, splan)
    torch.cuda.synchronize()
    assert (K.LAUNCHES.adjoint, K.LAUNCHES.adjoint_scatter) == (1, 1)
    _, of_group, of_row = K.rows_error(rows, K.adjoint_rows_plain(pack, f, plan), d)
    group_tol, row_tol = K.ROWS_TOL[dtype]
    assert of_group <= group_tol and of_row <= row_tol, (of_group, of_row)
    real = splan.gauss_pos.long()
    assert torch.equal(striped[splan.slot_pos.long()[real]], rows[real])
    assert torch.equal(K.reduce_rows(rows, plan, d + 1), K.reduce_rows_plain(rows, plan, d + 1))

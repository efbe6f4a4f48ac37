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
(D = 3, 20, 131, 256) and of its one-CTA kernel (D = 300, 512); two B5
launches bit-equal; D = 600 is refused. B4 at the same widths and at 600
launches its cluster kernel in the channel slices its width selects
(``train_fwd_cluster``: one slice up to 256 channels, two at 300 and 512,
three at 600); its alpha and exit blocks are bit-equal to the wide
kernel's on the same inputs, and two B4 launches give the same outputs
bit for bit. B6's live striped rows within
``ROWS_TOL`` of its twin and bit-equal to B2's rows through ``slot_pos``,
also at D = 200, 300, 600, 1100 (B2's clusters of 2, 3, 5, 5 CTAs);
B7 bit-equal to its twin and to B3 on the same rows. S1's rows within one
bf16 unit of the twin's (they are expected bit-equal) and scattered to
``pos``; its probe reads 19. The tiled path's regime, ``trans_eps`` = 0
(every block walked): B4 and B5 at D = 3 and 4, and B2 with one zero
channel, held by the same limits. B5's geometry-only launch at D = 5, 515
and 1030 against its twin by ``GRAD_ROWS_TOL`` (f32), and its columns
0:6 against the sums of the chunked B5 launches' geometry. B2 at
D = 1024 (DINO's width) in f32 and bf16 by ``ROWS_TOL``, B6 bit-equal.

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
# tile 16, 8 at tile 32); above, B4 in 2 or 3 channel slices and B5's
# one-CTA kernel (up to MAX_CHANNELS = 512)
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
    assert (K.LAUNCHES.train_fwd, K.LAUNCHES.train_fwd_wide) == (1, 0)
    d = cols.shape[1]
    assert T.train_fwd_cluster(plan.tile_size, d)[2] == (1 if d <= 256 else 2 if d <= 512 else 3)
    img_t, alpha_t, done_t = T.train_forward_plain(geom, cols, plan)
    assert _rel(img, img_t) <= 1e-4 and _rel(alpha, alpha_t) <= 1e-4
    assert torch.equal(done, done_t)


def test_train_fwd_cluster_kernel_matches_the_wide_kernel(train_packs):
    """The cluster kernel computes every weight with the wide kernel's
    instructions in its order, in every channel slice: alpha and the exit
    blocks are bit-equal to the wide kernel's on the same inputs (the image
    differs by the sum order and 3xTF32, within 1e-4)."""
    from tpugs_torch.kernels.build import load_library

    plan, geom, cols, _ = train_packs
    img, alpha, done = T.train_forward(geom, cols, plan)
    K.LAUNCHES.reset()
    img_w, alpha_w, done_w = T._launch_train_fwd(load_library(), geom, cols, plan,
                                                 K.TRANS_EPS, None)
    torch.cuda.synchronize()
    assert (K.LAUNCHES.train_fwd, K.LAUNCHES.train_fwd_wide) == (0, 1)
    assert torch.equal(alpha, alpha_w) and torch.equal(done, done_w)
    assert _rel(img, img_w) <= 1e-4


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
    if d > T.MAX_CHANNELS:  # RenderTrain chunks such widths; B5 itself refuses them
        with pytest.raises(ValueError, match="exceed"):
            T.train_rows(*args)
        assert (K.LAUNCHES.train_bwd, K.LAUNCHES.train_bwd_wide) == (0, 0)
        return
    rows = T.train_rows(*args)
    sums = K.reduce_rows(rows, plan, d + T.GEOM_GRADS)
    torch.cuda.synchronize()
    wide = T.train_cluster(plan.tile_size, d) is None
    assert (K.LAUNCHES.train_bwd, K.LAUNCHES.train_bwd_wide) == ((0, 1) if wide else (1, 0))
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
    if cols.shape[1] > T.MAX_CHANNELS:  # refused: test_train_bwd_kernel_matches_twin
        return
    first = T.train_rows(*args)
    second = T.train_rows(*args)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


# B5's geometry-only launch: above the colour kernels' 512 channels, and at
# trans_eps 0 (render_tiled's regime) and the default
@pytest.mark.parametrize("d, trans_eps", [(5, 0.0), (515, 0.0), (1030, T.TRANS_EPS)])
def test_train_geom_rows_match_twin_and_the_chunked_geometry(view, d, trans_eps):
    """``train_geom_rows`` (8 geometry columns, any D) within GRAD_ROWS_TOL
    (f32) of ``train_rows_plain(..., geometry_only=True)``, rows and B3's
    sums, counting only its own launches; its columns 0:6 summed per
    Gaussian equal the sums of the chunked ``train_rows`` launches'
    geometry (chunks of MAX_CHANNELS, ``hterm`` in the first only) within
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
    assert K.LAUNCHES.snapshot() == {**{k: 0 for k in K.LAUNCHES.snapshot()},
                                     "train_bwd_geom": 1}
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
    for i, (a, b) in enumerate(T.channel_chunks(d)):
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

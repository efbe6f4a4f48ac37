"""The port's two reduce experiments on the CPU (their plain twins).

* S1 (``experiments/scatter_write.py``): contig and scatter write the same
  rows, scatter at ``pos`` (exact); the rows of every block differ; the
  twin's f64 steps round as one f32 multiply-add (exact against a direct
  f64 emulation of ``fmaf``, a multiple of 1/64 times 1.000001f plus 0.5 is
  exact in f64); the probe reads 19; bad calls raise.
* S2 (``experiments/reduce_tail.py``): on one small view's real rows, the
  gather puts every live row where B6 would, and stripe + unpermute and
  scatter-acc are bit-equal to B3's twin, in f32 and bf16.
* The encoder's post step (``experiments/encoder_post.py``): its two
  variants, antialiased and plain upsample, agree to one bf16 unit, and
  the plain one is ``LSegEncoder.post``.
"""

import numpy as np
import pytest
import torch

from tpugs_torch.encoders.base import LinearRGBEncoder
from tpugs_torch.experiments import encoder_post
from tpugs_torch.experiments import reduce_tail as S2
from tpugs_torch.experiments import scatter_write as S1
from tpugs_torch.lift.batch import run_view
from tpugs_torch.raster import kernels as K
from tpugs_torch.raster.plan import with_scatter_extras
from tpugs_torch.utils.synthetic import orbit_cameras, random_scene

NB = 3


@pytest.mark.parametrize("iters", [0, 2, 17])
def test_s1_scatter_writes_the_contig_rows_at_pos(iters):
    pos = S1.permutation(NB * S1.BLOCK_ROWS)
    contig = S1.run_variant(pos, False, iters)
    scatter = S1.run_variant(pos, True, iters)
    assert contig.shape == (NB * 128, 1024) and contig.dtype == torch.bfloat16
    assert torch.equal(scatter[pos.long()], contig)
    same_multiset = torch.equal(torch.sort(contig.float().sum(1)).values,
                                torch.sort(scatter.float().sum(1)).values)
    assert same_multiset
    assert torch.unique(contig.float(), dim=0).shape[0] == NB * 128, "rows repeat"
    assert torch.isfinite(contig.float()).all()


def test_s1_twin_steps_are_one_rounding():
    """One step of the twin against an exact emulation of fmaf: the f64
    product and sum of these values are exact, so rounding once to f32 is
    fmaf's result; the twin agrees bit for bit."""
    blocks = torch.arange(2)
    x0 = S1._block_sums(blocks, 0)  # sums of the start values
    x1 = S1._block_sums(blocks, 1)
    a = np.float32(1.000001)
    m = np.arange(S1.COMPUTE_ELEMS, dtype=np.int64)
    idx = (blocks.numpy()[:, None] * 65536 + m[None, :]) & 0xFFFFFFFF
    start = (((idx * 2654435761) & 0xFFFFFFFF) >> 22).astype(np.float64) / 64.0
    step = (start * np.float64(a) + 0.5).astype(np.float32)
    ref = np.zeros((2, 4, 256), np.float32)
    chains = step.reshape(2, 256, 256)
    for k in range(256):
        ref[:, k % 4] += chains[:, k]
    np.testing.assert_array_equal(x1.numpy(), ref.reshape(2, 1024))
    assert not torch.equal(x0, x1)


def test_s1_probe_reads_19():
    src = torch.arange(64, dtype=torch.int32)
    assert int(S1.async_copy_probe(src, 2)) == 19
    assert int(S1.async_copy_probe(src, 7)) == 59


S1_BAD = {
    "f32 rows": (lambda: S1.scatter_write(torch.zeros((128, 1024)), None, 0), TypeError),
    "ragged rows": (lambda: S1.scatter_write(
        torch.zeros((100, 1024), dtype=torch.bfloat16), None, 0), ValueError),
    "narrow rows": (lambda: S1.scatter_write(
        torch.zeros((128, 512), dtype=torch.bfloat16), None, 0), ValueError),
    "int64 pos": (lambda: S1.scatter_write(
        torch.zeros((128, 1024), dtype=torch.bfloat16), torch.arange(128), 0), TypeError),
    "short pos": (lambda: S1.scatter_write(
        torch.zeros((128, 1024), dtype=torch.bfloat16),
        torch.arange(64, dtype=torch.int32), 0), ValueError),
    "too many iterations": (lambda: S1.scatter_write(
        torch.zeros((128, 1024), dtype=torch.bfloat16), None, 65), ValueError),
    "probe past the end": (lambda: S1.async_copy_probe(
        torch.arange(16, dtype=torch.int32), 2), ValueError),
    "probe int64": (lambda: S1.async_copy_probe(torch.arange(64), 2), TypeError),
}


@pytest.mark.parametrize("case", sorted(S1_BAD))
def test_s1_rejects_what_the_kernel_does_not_take(case):
    call, exc = S1_BAD[case]
    with pytest.raises(exc):
        call()


@pytest.fixture(scope="module", params=[torch.float32, torch.bfloat16])
def view(request):
    scene = random_scene(400, seed=3, extent=0.8, scale_range=(0.02, 0.1), device="cpu")
    cams = orbit_cameras(1, 96, 64, radius=2.5, device="cpu")
    r = run_view(scene, cams.viewmats[0], cams.Ks[0], 96, 64,
                 LinearRGBEncoder(20, seed=1, device="cpu"), 16, contrib_dtype=request.param)
    return r, with_scatter_extras(r.plan)


def test_s2_gather_places_rows_where_b6_writes_them(view):
    r, plan = view
    gathered = r.rows[S2.stripe_sources(plan)]
    striped = K.adjoint_scatter_rows(r.packed, r.feat_tiles, plan)
    live = plan.slot_pos.long()[plan.gauss_pos.long()]
    assert gathered.shape == striped.shape
    assert torch.equal(gathered[live], striped[live])


def test_s2_unpermuted_stripe_is_b3(view):
    r, plan = view
    fns = S2.passes(r.rows, plan, 21)
    full = fns["full"]()
    assert torch.equal(full, r.sums)
    assert torch.equal(fns["stripe+unpermute"](), full)
    assert torch.equal(fns["scatter-acc"](), full)
    assert torch.equal(fns["stripe"](), full[plan.slot_order])


def test_s2_accounts_for_every_pass(view):
    r, plan = view
    fns = S2.passes(r.rows, plan, 21)
    nbytes = S2.pass_bytes(plan, r.rows.shape[1], 21, r.rows.element_size())
    assert list(fns) == ["gather-only", "stripe", "stripe+unpermute", "scatter-acc", "full"]
    assert set(nbytes) == set(fns) and all(v > 0 for v in nbytes.values())
    assert nbytes["gather-only"] < nbytes["stripe"] < nbytes["stripe+unpermute"]
    assert set(S2.NOT_APPLICABLE) == {"bf16-unperm"}


def test_encoder_post_variants_agree():
    feats = torch.randn((1, 16, 12, 15), generator=torch.Generator().manual_seed(0))
    fns = encoder_post.variants((40, 44))
    a, b = fns["antialiased"](feats), fns["plain"](feats)
    assert a.shape == b.shape == (1, 40, 44, 16) and b.dtype == torch.bfloat16
    assert b.is_contiguous()
    np.testing.assert_allclose(b.float().numpy(), a.float().numpy(), rtol=2.0**-7, atol=1e-6)


@pytest.mark.parametrize("module", [S1, S2, encoder_post])
def test_experiments_need_a_card(module):
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    with pytest.raises(SystemExit, match="CUDA"):
        module.main([])

"""B4's kernel choice and its phases tool's tables, on the CPU.

* ``train_fwd_cluster`` gives (C, P, G, S, Ns) = (ts*ts / 128, 128, 1, S,
  Ns) at tiles 16 and 32 at every width, so a tile's pixels split into
  whole ranks (8 at tile 32, 2 at tile 16) and its channels into S =
  ceil(D / SLICE_CHANNELS) slices of Ns columns, a multiple of 16 at most
  ``CLUSTER_MAX_CHANNELS``, the narrowest multiple of 16 whose S slices
  cover D, every slice holding at least one channel; other tiles take the
  same kernel with ghost ranks, past 8 ranks in pixel groups (tile 33: two
  of 5, tile 64: four of 8); widths below 1 and tile 0 raise. It takes
  every width B5 takes, up to ``GEOM_MAX_CHANNELS``, and beyond.
* Every pattern of the tool's ``cluster`` table occurs exactly once in the
  tree's ``train_fwd.cu``, so each variant builds from the tree's kernel;
  the ``4d5fa2f`` table is held to that commit's source, whose wide kernel
  the tree no longer has: none of its patterns but the shared prelude is a
  line of the tree.
  The CPU half of B4 on the card is the twin, which
  ``test_torch_train_render.py`` and ``test_torch_train.py`` hold against
  tpugs.
"""

from pathlib import Path

import pytest
import torch

from tpugs_torch.experiments import adjoint_phases, train_fwd_phases
from tpugs_torch.raster import kernels as K
from tpugs_torch.raster import train as T
from tpugs_torch.raster.train import (
    CLUSTER_MAX_CHANNELS, GEOM_MAX_CHANNELS, PIXELS_PER_RANK, SLICE_CHANNELS, fwd_slices,
    train_fwd_cluster)

SOURCE = Path(adjoint_phases.__file__).resolve().parents[1] / "csrc" / "train_fwd.cu"
TABLE = train_fwd_phases.TABLES["cluster"]


@pytest.mark.parametrize("d", [1, 3, 20, 131, 144, 250, 256, 257, 300, 512, 600])
@pytest.mark.parametrize("ts", [16, 32])
def test_train_fwd_cluster_geometry(ts, d):
    c, p, g, s, ns = train_fwd_cluster(ts, d)
    assert p == PIXELS_PER_RANK == 128 and g == 1
    assert c * p == ts * ts
    assert c == {16: 2, 32: 8}[ts]
    assert s == -(-d // SLICE_CHANNELS) and (s == 1) == (d <= CLUSTER_MAX_CHANNELS)
    assert ns % 16 == 0 and ns <= CLUSTER_MAX_CHANNELS
    assert (s - 1) * ns < d <= s * ns, "every slice holds a channel"
    assert s * (ns - 16) < d, "balanced: the narrowest multiple of 16 that covers D"


@pytest.mark.parametrize("d, widest, want", [
    (512, 256, (2, 256)), (512, 128, (4, 128)), (600, 256, (3, 208)), (600, 128, (5, 128)),
    (257, 256, (2, 144)), (515, 256, (3, 176)), (131, 256, (1, 144)), (3, 256, (1, 16))])
def test_fwd_slices_balance_the_channels(d, widest, want):
    assert fwd_slices(d, widest) == want


@pytest.mark.parametrize("ts", [1, 4, 8, 24])
def test_train_fwd_cluster_sends_other_tiles_to_the_wide_kernel(ts):
    """The wide kernel is gone: other tiles take the cluster kernel, one
    rank of 128 slots at tiles 1 to 8 (ghosts past ts*ts), 5 at tile 24."""
    assert train_fwd_cluster(ts, 3) == ({24: 5}.get(ts, 1), PIXELS_PER_RANK, 1, 1, 16)


@pytest.mark.parametrize("ts, d", [(33, 3), (64, 3), (0, 3), (32, 0), (16, -1)])
def test_train_fwd_cluster_refuses(ts, d):
    """Tile 0 and widths below 1 raise; tiles 33 and 64 (past the old cap
    of 32) take pixel groups: two of 5 ranks and four of 8."""
    if ts in (33, 64):
        assert train_fwd_cluster(ts, d) == {33: (5, 128, 2, 1, 16), 64: (8, 128, 4, 1, 16)}[ts]
        return
    with pytest.raises(ValueError):
        train_fwd_cluster(ts, d)


def test_wide_widths_are_not_bounded_by_the_backward():
    assert train_fwd_cluster(32, 600)[3:] == (3, 208)
    assert train_fwd_cluster(32, 4096)[3:] == (16, 256)
    assert train_fwd_cluster(16, 4097)[3:] == (17, 256)
    assert train_fwd_cluster(32, GEOM_MAX_CHANNELS)[3:] == (149, 256)
    assert train_fwd_cluster(16, GEOM_MAX_CHANNELS + 1)[3:] == (149, 256)


PATTERNS = [
    pytest.param(phase, old, id=f"{phase}-{k}")
    for phase, subs in TABLE.items()
    for k, (old, _) in enumerate(subs)
]


@pytest.mark.parametrize("phase, old", PATTERNS)
def test_phase_pattern_occurs_once_in_the_tree_source(phase, old):
    assert SOURCE.read_text().count(old) == 1, (phase, old)


def test_every_variant_of_the_tree_source_builds_its_text():
    """No substitution consumes another's pattern, and each variant differs
    from the full source."""
    text = SOURCE.read_text()
    found = adjoint_phases.variants(TABLE, train_fwd_phases.VARIANTS)
    assert {phase for _, phases in found for phase in phases} == set(TABLE)
    for name, phases in found:
        cut = adjoint_phases.variant_source(text, TABLE, phases)
        assert (cut == text) == (not phases), name


@pytest.mark.parametrize("table", sorted(train_fwd_phases.TABLES))
def test_variant_names_make_plain_file_names(table):
    """Each variant is compiled from ``<name>.cu``: no character that the
    CUDA toolchain's argument parsing takes apart (commas, equals signs)."""
    for name, _ in adjoint_phases.variants(train_fwd_phases.TABLES[table],
                                           train_fwd_phases.VARIANTS):
        assert not set(name) & set(",=;:/"), name


def test_old_table_names_the_wide_kernels_lines():
    """The commit-4d5fa2f kernel lived on as the wide kernel, which the tree
    has deleted: none of its phase patterns (but the shared prelude) is a
    line of the tree's source any more, and the table names its walk, its
    colour staging and its grid of 32-channel slices."""
    text = SOURCE.read_text()
    table = train_fwd_phases.TABLES["4d5fa2f"]
    assert set(table) == {"slices", "product", "staging", "exit"}
    for phase, subs in table.items():
        for old, _ in subs:
            if old != adjoint_phases._DONE_GLOBAL[0]:
                assert text.count(old) == 0, (phase, old)
    assert "tpugs::kSliceC" in table["slices"][0][0]


def test_phases_tool_refuses_an_unknown_table():
    with pytest.raises(SystemExit):
        train_fwd_phases.main(["--run", "nonesuch"])


def test_cpu_tensors_count_no_b4_launch():
    """On the CPU ``train_forward`` is the twin whatever the width: neither
    B4 counter moves."""
    plan_args = _tiny_plan()
    K.LAUNCHES.reset()
    for d in (3, 300):
        geom, cols, plan = plan_args(d)
        img, alpha, done = T.train_forward(geom, cols, plan)
        assert img.shape == (plan.height, plan.width, d)
    assert (K.LAUNCHES.train_fwd, K.LAUNCHES.train_fwd_vote) == (0, 0)


def _tiny_plan():
    from tpugs_torch.raster.plan import build_plan
    from tpugs_torch.raster.projection import project
    from tpugs_torch.utils.synthetic import orbit_cameras, random_scene

    w, h = 40, 24
    scene = random_scene(200, seed=3, extent=0.6, scale_range=(0.02, 0.1), device="cpu")
    cams = orbit_cameras(1, w, h, radius=3.0, device="cpu")
    proj = project(scene.means, scene.quats, scene.scales, scene.opacities,
                   cams.viewmats[0], cams.Ks[0], w, h)
    plan = build_plan(proj, w, h, 16)
    opac = torch.where(proj.valid, proj.opacities, torch.zeros_like(proj.opacities))

    def make(d):
        colors = torch.rand((scene.num_gaussians, d), generator=torch.Generator().manual_seed(d))
        geom, cols = T.pack_train(proj.means2d, proj.conics, opac, colors, plan)
        return geom, cols, plan
    return make

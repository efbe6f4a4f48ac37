"""B4's kernel choice and its phases tool's tables, on the CPU.

* ``train_fwd_cluster`` gives (C, P, S, Ns) = (ts*ts / 128, 128, S, Ns)
  at tiles 16 and 32 at every width, so a tile's pixels split into whole
  ranks (8 at tile 32, 2 at tile 16) and its channels into S = ceil(D /
  SLICE_CHANNELS) slices of Ns columns, a multiple of 16 at most
  ``CLUSTER_MAX_CHANNELS``, the narrowest multiple of 16 whose S slices
  cover D, every slice holding at least one channel; None (the wide kernel) for
  other tiles; widths below 1 and tiles over 32 raise. It does not stop at
  B5's ``MAX_CHANNELS``.
* Every pattern of the tool's ``cluster`` table occurs exactly once in the
  tree's ``train_fwd.cu``, so each variant builds from the tree's kernel;
  the ``4d5fa2f`` table is held to that commit's source, which the tree no
  longer has, only in so far as its patterns name the wide kernel's lines.
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
    CLUSTER_MAX_CHANNELS, MAX_CHANNELS, PIXELS_PER_RANK, SLICE_CHANNELS, fwd_slices,
    train_fwd_cluster)

SOURCE = Path(adjoint_phases.__file__).resolve().parents[1] / "csrc" / "train_fwd.cu"
TABLE = train_fwd_phases.TABLES["cluster"]


@pytest.mark.parametrize("d", [1, 3, 20, 131, 144, 250, 256, 257, 300, 512, 600])
@pytest.mark.parametrize("ts", [16, 32])
def test_train_fwd_cluster_geometry(ts, d):
    c, p, s, ns = train_fwd_cluster(ts, d)
    assert p == PIXELS_PER_RANK == 128
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
    assert train_fwd_cluster(ts, 3) is None


@pytest.mark.parametrize("ts, d", [(33, 3), (64, 3), (0, 3), (32, 0), (16, -1)])
def test_train_fwd_cluster_refuses(ts, d):
    with pytest.raises(ValueError):
        train_fwd_cluster(ts, d)


def test_wide_widths_are_not_bounded_by_the_backward():
    assert MAX_CHANNELS < 600 and train_fwd_cluster(32, 600)[2:] == (3, 208)


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
    """The commit-4d5fa2f kernel lives on as the wide kernel: its phase
    patterns, but for the launch grid of the old entry point, are lines of
    the tree's source too."""
    text = SOURCE.read_text()
    for phase, subs in train_fwd_phases.TABLES["4d5fa2f"].items():
        for old, _ in subs:
            if phase != "slices" and old != adjoint_phases._DONE_GLOBAL[0]:
                assert text.count(old) == 1, (phase, old)


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
    assert (K.LAUNCHES.train_fwd, K.LAUNCHES.train_fwd_wide) == (0, 0)


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

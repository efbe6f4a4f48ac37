"""B5's cluster geometry and the phases tools' tables, on the CPU.

* ``train_cluster`` gives (C, P, G) = (ts*ts / 128, 128, 1) up to
  ``CLUSTER_MAX_CHANNELS`` channels, so a tile's pixels split into whole
  ranks (8 at tile 32, 2 at tile 16), and None above it, where
  ``train_layout`` gives the colour slices (the same ranks) and the
  geometry kernel, up to ``GEOM_MAX_CHANNELS``; a tile of 8 has one rank,
  a tile of 64 four pixel groups of 8; widths past the cap raise.
* Every pattern of every phase table that targets a source of this tree
  (adjoint's ``cluster``, train_bwd's ``cluster``, ``colour`` and ``geom``)
  occurs exactly once in
  that source, so each variant builds from the tree's kernel; tables of
  older commits (``pr3``, ``d4ac1ba``, ``old``) are exempt. The CPU half of B5 on
  the card is the twin, which ``test_torch_train.py`` and
  ``test_torch_train_render.py`` hold against tpugs.
"""

from pathlib import Path

import pytest

from tpugs_torch.experiments import adjoint_phases, train_bwd_phases
from tpugs_torch.raster.train import (
    CLUSTER_MAX_CHANNELS, GEOM_MAX_CHANNELS, PIXELS_PER_RANK, train_cluster, train_layout)

CSRC = Path(adjoint_phases.__file__).resolve().parents[1] / "csrc"


@pytest.mark.parametrize("d", [1, 3, 20, 131, 250, 256, 257, 300, 512, 1027])
@pytest.mark.parametrize("ts", [16, 32])
def test_train_cluster_geometry(ts, d):
    got = train_cluster(ts, d)
    if d > CLUSTER_MAX_CHANNELS:
        assert got is None
        c, p, g = train_layout(ts, d)["colour"][:3]  # the colour slices keep the ranks
        assert (c, p, g) == (ts * ts // PIXELS_PER_RANK, PIXELS_PER_RANK, 1)
        return
    c, p, g = got
    assert g == 1
    assert p == PIXELS_PER_RANK == 128
    assert c * p == ts * ts
    assert c == {16: 2, 32: 8}[ts]


@pytest.mark.parametrize("ts, d", [(8, 3), (64, 3), (32, 0), (16, GEOM_MAX_CHANNELS + 1)])
def test_train_cluster_refuses(ts, d):
    """No channels and widths past GEOM_MAX_CHANNELS raise, naming the
    cap; a tile of 8 takes one rank of 128 pixel slots, 64 of them ghosts,
    and a tile of 64 (past the old cap of 32) four pixel groups of 8 ranks."""
    if 1 <= d <= GEOM_MAX_CHANNELS:
        assert train_cluster(ts, d) == {8: (1, PIXELS_PER_RANK, 1),
                                        64: (8, PIXELS_PER_RANK, 4)}[ts]
        return
    with pytest.raises(ValueError, match="GEOM_MAX_CHANNELS"):
        train_cluster(ts, d)


TREE_TABLES = [
    (adjoint_phases.TABLES["cluster"], "adjoint.cu"),
    (train_bwd_phases.TABLES["cluster"], "train_bwd.cu"),
    (train_bwd_phases.TABLES["colour"], "train_bwd.cu"),
    (train_bwd_phases.TABLES["geom"], "train_bwd.cu"),
]
TREE_IDS = ["adjoint", "train_bwd", "train_bwd-colour", "train_bwd-geom"]
PATTERN_IDS = ["adjoint.cu", "train_bwd.cu", "train_bwd.cu-colour", "train_bwd.cu-geom"]
PATTERNS = [
    pytest.param(table, source, phase, old, id=f"{tid}-{phase}-{k}")
    for (table, source), tid in zip(TREE_TABLES, PATTERN_IDS)
    for phase, subs in table.items()
    for k, (old, _) in enumerate(subs)
]


@pytest.mark.parametrize("table, source, phase, old", PATTERNS)
def test_phase_pattern_occurs_once_in_the_tree_source(table, source, phase, old):
    assert (CSRC / source).read_text().count(old) == 1, (phase, old)


@pytest.mark.parametrize("table, source", TREE_TABLES, ids=TREE_IDS)
def test_every_variant_of_the_tree_source_builds_its_text(table, source):
    """Cutting several phases out of one copy: no substitution consumes
    another's pattern, and each variant differs from the full source."""
    text = (CSRC / source).read_text()
    variant_list = (adjoint_phases.VARIANTS if source == "adjoint.cu"
                    else train_bwd_phases.VARIANTS)
    found = adjoint_phases.variants(table, variant_list)
    assert {phase for _, phases in found for phase in phases} == set(table)
    for name, phases in found:
        cut = adjoint_phases.variant_source(text, table, phases)
        assert (cut == text) == (not phases), name


def test_phases_tool_refuses_an_unknown_table():
    with pytest.raises(SystemExit):
        train_bwd_phases.main(["--run", "nonesuch"])

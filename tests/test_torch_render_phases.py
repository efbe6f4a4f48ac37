"""B1's cluster geometry and its phases tool's tables, on the CPU.

* ``render_cluster`` gives (C, P, G) = (ts*ts / 256, 256, 1) at tiles 16
  and 32 (4 CTAs at tile 32, 1 at tile 16), so a tile's pixels split into
  whole ranks of ``RENDER_THREADS`` pixels, each rank into whole 8 x 4 warp
  rectangles; tiles 8, 24 and 33 take one cluster of 1, 3 and 6 CTAs (with
  ghost slots), tile 64 two pixel groups of 8; tile 0 raises.
* Every pattern of the tool's ``cluster`` table occurs exactly once in the
  tree's ``render.cu``, so each variant builds from the tree's kernel, and
  no substitution consumes another's pattern; the prelude and epilogue
  go in once. The ``55f8844`` table's patterns are lines of that commit's
  kernel, which the tree no longer has: they are held here only to name
  the parent's one-CTA walk (a 1024-thread tile and its vote).
* Variant names make plain file names (the CUDA toolchain took a comma
  apart once).
"""

from pathlib import Path

import pytest

from tpugs_torch.experiments import adjoint_phases, render_phases
from tpugs_torch.raster import kernels as K

SOURCE = Path(render_phases.__file__).resolve().parents[1] / "csrc" / "render.cu"
TABLE = render_phases.TABLES["cluster"]


@pytest.mark.parametrize("ts, c", [(16, 1), (32, 4)])
def test_render_cluster_geometry(ts, c):
    assert K.render_cluster(ts) == (c, K.RENDER_THREADS, 1)
    assert c * K.RENDER_THREADS == ts * ts
    rank_rows = K.RENDER_THREADS // ts
    assert rank_rows % K.RECT_H == 0 and ts % K.RECT_W == 0
    assert (rank_rows // K.RECT_H) * (ts // K.RECT_W) * 32 == K.RENDER_THREADS


@pytest.mark.parametrize("ts", [0, 8, 24, 33, 64])
def test_render_cluster_refuses_other_tiles(ts):
    """Tile 0 raises; tiles 8, 24 and 33 take the CTAs their warp
    rectangles fill (1, 3 and 6), ghost slots beyond; tile 64's 16 CTAs
    form two pixel groups, whose exit is the vote's."""
    if ts >= 1:
        assert K.render_cluster(ts) == {8: (1, 256, 1), 24: (3, 256, 1), 33: (6, 256, 1),
                                        64: (8, 256, 2)}[ts]
        return
    with pytest.raises(ValueError, match="at least 1 pixel"):
        K.render_cluster(ts)


PATTERNS = [
    pytest.param(phase, old, id=f"{phase}-{k}")
    for phase, subs in TABLE.items()
    for k, (old, _) in enumerate(subs)
]


@pytest.mark.parametrize("phase, old", PATTERNS)
def test_phase_pattern_occurs_once_in_the_tree_source(phase, old):
    assert SOURCE.read_text().count(old) == 1, (phase, old)


def test_every_variant_of_the_tree_source_builds_its_text():
    text = render_phases.copy_source(SOURCE.read_text(), "cluster")
    assert text.count(render_phases.PRELUDE) == 1
    assert text.endswith(render_phases.EPILOGUES["cluster"])
    found = adjoint_phases.variants(TABLE, render_phases.VARIANTS)
    assert {phase for _, phases in found for phase in phases} == set(TABLE)
    for name, phases in found:
        cut = adjoint_phases.variant_source(text, TABLE, phases)
        assert (cut == text) == (not phases), name


def test_parent_table_names_the_one_cta_walk():
    """The parent's kernel was one 1024-thread CTA per tile with a
    tile-wide __syncthreads_or; its table takes apart the tile split, the
    tile order, the alphas, the shared loads, the staging and the vote."""
    parent = render_phases.TABLES["55f8844"]
    assert set(parent) == {"heavy", "light", "order", "walk", "loads", "staging", "exit"}
    assert render_phases._55_EXIT.strip() == "keep = __syncthreads_or(trans > trans_eps);"
    assert render_phases._55_TILE.strip() == "const int tile = blockIdx.x;"


@pytest.mark.parametrize("table", sorted(render_phases.TABLES))
def test_variant_names_make_plain_file_names(table):
    for name, _ in adjoint_phases.variants(render_phases.TABLES[table], render_phases.VARIANTS):
        assert not set(name) & set(",=;:/"), name


def test_copy_source_needs_one_include():
    with pytest.raises(ValueError):
        render_phases.copy_source("int x;\n", "cluster")


def test_phases_tool_refuses_an_unknown_table():
    with pytest.raises(SystemExit):
        render_phases.main(["--run", "nonesuch"])


def test_no_table_names_a_phase_twice():
    """A dict literal keeps the last of two equal keys without a word: every
    dict literal of the tool has distinct keys."""
    import ast

    tree = ast.parse(Path(render_phases.__file__).read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Dict):
            keys = [ast.literal_eval(k) for k in node.keys if k is not None]
            assert len(keys) == len(set(keys)), keys

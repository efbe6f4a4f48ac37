"""B2's rows past each tile's early exit on the card, and ``WORK``'s counts
of them (``python -m pytest tests/test_torch_work_cuda.py`` on the H100;
without a card it skips: the kernels have no CPU mode).

On a dense lift view at tile 32 (LSeg's 512 channels in bf16, as the lift
runs), every row B2 writes at a slot at or past ``padded_start + BLOCK x
blocks_done`` of its tile is zero in every column, the ones-channel
included, so ``WORK.walked_slots`` bounds the rows that can carry weight;
the view has such rows, and rows before them that carry weight.
"""

import pytest
import torch

from tpugs_torch.encoders.base import LinearRGBEncoder
from tpugs_torch.lift.batch import run_view
from tpugs_torch.raster.kernels import WORK
from tpugs_torch.raster.plan import BLOCK
from tpugs_torch.utils.synthetic import orbit_cameras, random_scene

W, H, D, TILE = 320, 208, 512, 32


@pytest.fixture(scope="module")
def lifted():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    scene = random_scene(200000, seed=5, extent=0.6, scale_range=(0.01, 0.12), device="cuda")
    cams = orbit_cameras(1, W, H, radius=3.0, device="cuda")
    WORK.reset()
    r = run_view(scene, cams.viewmats[0], cams.Ks[0], W, H,
                 LinearRGBEncoder(D, seed=2, device="cuda"), TILE)
    return r, WORK.snapshot()


def test_rows_past_each_tiles_exit_are_zero(lifted):
    r, _ = lifted
    plan = r.plan
    padded = torch.diff(plan.padded_starts.long(),
                        append=torch.tensor([plan.T_padded], device="cuda"))
    tile = torch.repeat_interleave(torch.arange(plan.n_tiles, device="cuda"), padded)
    walked_end = plan.padded_starts.long()[tile] + BLOCK * r.blocks_done.long()[tile]
    past = torch.arange(plan.T_padded, device="cuda") >= walked_end
    assert r.rows.shape[0] == plan.T_padded and 0 < int(past.sum()) < plan.T_padded
    assert int(r.rows[past].count_nonzero()) == 0
    assert int(r.rows[~past][:, D].count_nonzero()) > 0  # the ones-channel's weights


def test_work_counts_the_view(lifted):
    r, work = lifted
    assert work == {"calls": 1, "slots": r.plan.T_padded, "isects": r.plan.n_isects,
                    "walked_slots": BLOCK * int(r.blocks_done.sum())}
    assert work["walked_slots"] < work["slots"]

"""The distribution (``tpugs_torch/dist``) on 4 gloo ranks on the CPU, at
tpugs' ``tests/test_dist.py`` sizes (128 Gaussians, 48x32, its 96-point
trainer). One spawn of 4 ranks runs every case (``dist/cases.py::
dist_cases``) and returns arrays; each test asserts on them:

* the mesh is row-major; wrong sizes raise ValueError before any
  collective; ``make_mesh`` without a group raises;
* the sharded lift on meshes (4, 1), (2, 2) and (1, 4), reassembled from
  the gauss shards, and ``pad_cameras`` (5 cameras to 8), against the
  port's single-process lift and tpugs' unsharded ``backproject_views``
  (atol 1e-4), and against tpugs' sharded lift on (2, 2) (atol 1e-4);
* the train step (SGD at lr 0.1) on the three meshes, without features
  (with both regularisers), with pose and appearance, and on the "tiled"
  engine, against the port's (1, 1) step to tpugs' ``test_dist.py``
  tolerances (loss rtol 1e-5, leaves 2e-5, ``feature_proj`` 1e-7, grad2d
  1e-5, pose and appearance 1e-6, vis equal); the "tiled" (2, 2) step
  against tpugs' sharded step on (2, 2), to the tolerances of
  ``test_torch_train_tiled.py`` (loss rtol 1e-4, updates over lr as
  gradients 3e-4 of max + 1e-8, plus the float32 spacing that reading a
  gradient from a leaf's update costs); the (1, 1) step bit-equal to
  ``Trainer._step_on``;
* the exchange cap at 0, 48 (every local row) and 4: 48 lossless (loss
  rtol 1e-6, leaves 1e-6), 4 dropping exactly the survivors beyond it;
* the chunk against its steps (losses rtol 1e-6, leaves 1e-6); the refine
  cycle against (1, 1); the oracle step lowers its loss; the dry run; the
  single-device tool's parity;
* a rank that raises fails ``run_ranks`` at once, well inside its timeout.

tpugs' sharded programs run twice: its lift and its train step on (2, 2).
"""

import time

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tpugs.dist.mesh import make_mesh as j_make_mesh
from tpugs.dist.shard import backproject_views_sharded as j_lift_sharded
from tpugs.dist.shard import make_trainer_step_sharded as j_step_sharded
from tpugs.encoders.base import LinearRGBEncoder as JLinear
from tpugs.lift.batch import backproject_views as j_backproject_views
from tpugs.lift.batch import estimate_sizes
from tpugs.train.config import TrainConfig as JTrainConfig
from tpugs.train.trainer import Trainer as JTrainer
from tpugs.train.trainer import init_scene_random as j_init_random
from tpugs.utils.synthetic import orbit_cameras as j_orbit
from tpugs.utils.synthetic import random_scene as j_random_scene
from tpugs_torch.dist import cases
from tpugs_torch.dist.mesh import make_mesh, pad_cameras
from tpugs_torch.dist.spawn import run_ranks
from tpugs_torch.lift.batch import backproject_views

W, H = cases.W, cases.H


@pytest.fixture(scope="module")
def ranks():
    return run_ranks(cases.dist_cases, 4, timeout=300)


@pytest.fixture(scope="module")
def solo(ranks):
    return ranks[0]["solo"]


def _full(ranks, case, key, gauss_n):
    """A per-Gaussian result reassembled from ranks 0..gauss_n-1 (camera
    coordinate 0), after checking that every camera row holds the same."""
    rows = [np.concatenate([ranks[c * gauss_n + j][case][key] for j in range(gauss_n)])
            for c in range(4 // gauss_n)]
    for r in rows[1:]:
        np.testing.assert_array_equal(r, rows[0], err_msg=f"{case} {key} across camera rows")
    return rows[0]


def _replicated(ranks, case, key):
    ref = ranks[0][case][key]
    for r in ranks[1:]:
        if isinstance(ref, dict):
            assert r[case][key] == ref, (case, key)
        else:
            np.testing.assert_array_equal(r[case][key], ref, err_msg=f"{case} {key}")
    return ref


@pytest.fixture(scope="module")
def lift_ref():
    """The port's single-process lift (8 views, and the first 5) and tpugs'
    unsharded ``backproject_views`` on the same inputs."""
    scene, cams, enc = cases.lift_inputs()
    port = backproject_views(scene, cams.viewmats, cams.Ks, W, H, enc, device="cpu",
                             **cases.LIFT_KW)
    five = backproject_views(scene, cams.viewmats[:5], cams.Ks[:5], W, H, enc, device="cpu",
                             **cases.LIFT_KW)
    js = j_random_scene(128, seed=0, extent=0.8, scale_range=(0.02, 0.1))
    jc = j_orbit(8, W, H, radius=2.5)
    jenc, sizes = JLinear(feature_dim=4), estimate_sizes(js, jc)
    ref = j_backproject_views(js, jc.viewmats, jc.Ks, W, H, jenc, sizes)
    j22 = j_lift_sharded(js, jc.viewmats, jc.Ks, jnp.ones((8,)), W, H, jenc, sizes,
                         j_make_mesh((2, 2), ("cam", "gauss"), devices=jax.devices()[:4]))
    return {"port": [t.numpy() for t in port], "five": [t.numpy() for t in five],
            "tpugs": [np.asarray(a) for a in ref], "tpugs (2, 2)": [np.asarray(a) for a in j22]}


@pytest.mark.parametrize("shape", cases.MESHES)
def test_mesh_is_row_major(ranks, shape):
    for rank, r in enumerate(ranks):
        np.testing.assert_array_equal(r["coords"][str(shape)], divmod(rank, shape[1]))


def test_sizes_that_do_not_split_raise(ranks):
    errors = ranks[0]["errors"]
    assert "mesh (3, 1) != 4 ranks" in errors["mesh (3, 1)"]
    assert "pad_cameras" in errors["7 cameras"]
    assert "N = 130" in errors["N = 130 on (1, 4)"]
    with pytest.raises(RuntimeError, match="init_ranks"):
        make_mesh(device="cpu")


@pytest.mark.parametrize("shape", cases.MESHES)
def test_sharded_lift_matches_single(ranks, lift_ref, shape):
    num = _full(ranks, f"lift {shape}", "num", shape[1])
    den = _full(ranks, f"lift {shape}", "den", shape[1])
    for ref in (lift_ref["port"], lift_ref["tpugs"]):
        np.testing.assert_allclose(num, ref[0], atol=1e-4)
        np.testing.assert_allclose(den, ref[1], atol=1e-4)
    assert (den > 0).sum() > 100


def test_lift_matches_tpugs_sharded(ranks, lift_ref):
    j_num, j_den = lift_ref["tpugs (2, 2)"]
    np.testing.assert_allclose(_full(ranks, "lift (2, 2)", "num", 2), j_num, atol=1e-4)
    np.testing.assert_allclose(_full(ranks, "lift (2, 2)", "den", 2), j_den, atol=1e-4)


def test_pad_cameras_weights(ranks, lift_ref):
    vms, ks, w = pad_cameras(torch.eye(4).repeat(5, 1, 1), 2 * torch.eye(3).repeat(5, 1, 1), 8)
    assert vms.shape == (8, 4, 4) and ks.shape == (8, 3, 3)
    assert torch.equal(vms[5:], torch.eye(4).expand(3, 4, 4)) and torch.equal(ks[7], ks[0])
    np.testing.assert_array_equal(ranks[0]["pad"]["weights"], [1, 1, 1, 1, 1, 0, 0, 0])
    got = _assembled(ranks, "pad")  # gauss axis of size 1: every rank holds all rows
    np.testing.assert_allclose(got["num"], lift_ref["five"][0], atol=1e-5)
    np.testing.assert_allclose(got["den"], lift_ref["five"][1], atol=1e-5)


def _leaves(d):
    return {k: v for k, v in d.items() if k.startswith(("scene.", "pose", "app."))}


PER_GAUSSIAN = ("vis", "grad2d", "grad2d2", "sh0", "sh0_before")


def _assembled(ranks, case, gauss_n=2) -> dict:
    """A case's results as one process would hold them: per-Gaussian arrays
    reassembled, the rest checked equal on every rank."""
    return {k: _full(ranks, case, k, gauss_n)
            if k in PER_GAUSSIAN or (k.startswith("scene.") and k != "scene.feature_proj")
            else _replicated(ranks, case, k) for k in ranks[0][case]}


def _match(got, ref, leaf_tol=2e-5):
    """tpugs' ``test_dist.py`` tolerances."""
    np.testing.assert_allclose(got["loss"], ref["loss"], rtol=1e-5)
    np.testing.assert_array_equal(got["vis"], ref["vis"])
    np.testing.assert_allclose(got["grad2d"], ref["grad2d"], atol=1e-5)
    assert got["xover"] == 0
    for k, v in _leaves(ref).items():
        tol = (1e-7 if k == "scene.feature_proj" else leaf_tol if k.startswith("scene.")
               else 1e-6)
        np.testing.assert_allclose(got[k], v, atol=tol, err_msg=k)


@pytest.mark.parametrize("shape", cases.MESHES)
def test_train_step_matches_single(ranks, solo, shape):
    _match(_assembled(ranks, f"step {shape}", shape[1]), solo["step"])


@pytest.mark.parametrize("case", ["tiled", "nofeat", "pose_app"])
def test_train_step_cases_match_single(ranks, solo, case):
    """The "tiled" engine; no feature field (with opacity_reg and scale_reg,
    which the port counts once however many camera shards); pose and
    appearance (replicated, their gradients summed over both axes)."""
    got = _assembled(ranks, case)
    _match(got, solo[case])
    if case == "nofeat":
        before = cases.make_trainer(feature=False).scene.sh0.detach().numpy()
        assert not np.allclose(got["scene.sh0"], before)


def test_train_step_matches_tpugs_sharded(ranks):
    """The port's (2, 2) step on the "tiled" engine against tpugs' (2, 2)
    step on its pure-JAX tiled engine (its CPU default), both with SGD."""
    B = cases.B
    cfg = JTrainConfig(max_steps=10, init_num_pts=96, init_extent=0.6, sh_degree=1,
                       feature_dim=8, feature_out_dim=16, strategy="none", reset_every=0,
                       random_bkgd=False, batch_size=B, seed=5)
    tr = JTrainer(cfg, j_init_random(cfg), width=W, height=H)
    f_rng = np.random.default_rng(11)
    tr.scene = tr.scene.replace(features=jnp.asarray(
        f_rng.normal(0, 0.3, tr.scene.features.shape).astype(np.float32)))
    tr._sizes = (64, 4)
    tr.optimizer = optax.sgd(cases.LR)
    tr.opt_state = tr.optimizer.init(tr.scene)
    before = {f"scene.{k}": np.asarray(getattr(tr.scene, k)) for k in (
        "means", "quats", "log_scales", "logit_opacities", "sh0", "shN", "features",
        "feature_proj")}
    vms, ks, images, teachers, bkgds, ids = (jnp.asarray(t.numpy())
                                             for t in cases.batch_inputs(0))
    step = j_step_sharded(tr, j_make_mesh((2, 2), ("cam", "gauss"), devices=jax.devices()[:4]),
                          batch_size=B)
    scene, _, _, loss, grad2d, vis, xover = step(tr.scene, tr.opt_state, tr.module_state(),
                                                 vms, ks, images, teachers, bkgds,
                                                 ids.astype(jnp.int32))
    assert float(xover) == 0
    got = _assembled(ranks, "tiled")
    np.testing.assert_allclose(got["loss"], float(loss), rtol=1e-4)
    np.testing.assert_array_equal(got["vis"], np.asarray(vis))
    ref_g2d = np.asarray(grad2d)
    assert np.abs(got["grad2d"] - ref_g2d).max() <= 3e-4 * np.abs(ref_g2d).max() + 1e-8
    for k, b in before.items():
        # the update over lr is the gradient, read to two float32 spacings of the leaf
        floor = 2 * np.spacing(np.abs(b).max()) / cases.LR
        ref = (np.asarray(getattr(scene, k[6:])) - b) / cases.LR
        err = np.abs((got[k] - b) / cases.LR - ref).max()
        assert err <= 3e-4 * np.abs(ref).max() + 1e-8 + floor, (k, err, np.abs(ref).max())


def test_step_on_equals_the_11_step(solo):
    """At batch 1 on a (1, 1) mesh with the trainer's Adam, the sharded
    step is ``Trainer._step_on`` bit for bit."""
    r = solo["vs _step_on"]
    assert r["loss"] == r["ref_loss"]
    for k, v in r["ref_state"].items():
        np.testing.assert_array_equal(r["state"][k], v, err_msg=k)


def test_exchange_cap(ranks):
    """Cap 48 holds every local row (lossless); cap 4 drops, per view and
    shard, every survivor beyond 4: the uncapped survivors less 4 x 4 views
    x 2 shards, counted on every rank."""
    _match(_assembled(ranks, "cap 48"), _assembled(ranks, "cap 0"), leaf_tol=1e-6)
    survivors = _full(ranks, "cap 0", "vis", 2).sum()
    assert _replicated(ranks, "cap 4", "xover") == survivors - 4 * cases.B * 2 > 0
    assert np.isfinite(_replicated(ranks, "cap 4", "loss"))


def test_chunk_matches_stepwise(ranks):
    got, ref = _assembled(ranks, "chunk"), _assembled(ranks, "stepwise")
    np.testing.assert_allclose(got["loss"], ref["loss"], rtol=1e-6)
    for k, v in _leaves(ref).items():
        np.testing.assert_allclose(got[k], v, atol=1e-6, err_msg=k)
    assert got["vis"].sum() > 0


def test_refine_cycle_matches_single(ranks, solo):
    got, ref = _assembled(ranks, "refine"), solo["refine"]
    assert got["info"] == ref["info"] and ref["info"]["split"] + ref["info"]["duplicated"] > 0
    assert 2 * got["n_local"] == ref["n_local"] == ref["info"]["alive"]
    for k, v in _leaves(ref).items():
        np.testing.assert_allclose(got[k], v, atol=2e-5, err_msg=k)
    np.testing.assert_allclose(got["loss2"], ref["loss2"], rtol=1e-5)
    assert got["grad2d2"].shape == (ref["n_local"],)


def test_oracle_step_lowers_its_loss(ranks, solo):
    got = _assembled(ranks, "oracle")
    assert np.isfinite(got["loss"]).all() and got["loss"][-1] < got["loss"][0]
    np.testing.assert_allclose(got["loss"][0], solo["oracle"]["loss"][0], rtol=1e-6)
    assert not np.allclose(got["sh0"], got["sh0_before"])


def test_dryrun_and_singlechip_tool(ranks, solo):
    d = ranks[0]["dryrun"]
    assert tuple(d["mesh"]) == (2, 2) and d["features"] == (128, 8)
    assert d["n_after_refine"] % 2 == 0 and d["n_after_refine"] > 128
    assert np.isfinite([d["loss"], d["loss_after_refine"], *d["chunk_losses"]]).all()
    tool = solo["singlechip"]
    assert tool["backproject"]["bit_equal"] and tool["backproject"]["ok"]
    assert tool["train"]["ok"] and tool["train"]["rel_diff"] == 0.0


def test_a_rank_that_raises_fails_within_the_timeout():
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="rank 1 raised") as e:
        run_ranks(cases.raise_on_rank, 2, (1,), timeout=60)
    assert "fails on purpose" in str(e.value)
    assert time.monotonic() - t0 < 30

"""The port's interactive apps (``tpugs_torch.apps``: viewer,
click_and_segment, viewer_llm, llm_backend, download_dataset) against
tpugs' on the CPU, at tpugs' own test sizes (48x32, at most 80
Gaussians).

* ``ViewerState`` (dolly, canonical views, orbit), ``estimate_scene_frame``
  and the ``Viewer``'s key and mouse handling: viewmats equal to tpugs';
* ``render_frame`` (B4 with early exit) against both of tpugs' engines
  (its "pallas" in interpret mode), plain, anaglyph and with the axes
  overlay: within 1 uint8 unit;
* the ``PromptSession`` flow of ``tests/test_interactive.py`` on one
  field handed to both: the RGB+ED and feature renders within 1e-5 of
  tpugs', equal masks, panes within 1 uint8 unit, the same marker
  removed;
* ``parse_rule_based`` and ``Assistant`` on tpugs' phrases: equal dicts;
  ``SceneEditor.apply`` for each command: scene fields equal to tpugs';
* ``make_backend``'s specs; the tiny random GPT-2 (transformers) answers
  as tpugs' does and leaves the global generator alone;
* ``download_dataset.main``'s commands equal to tpugs' with
  ``subprocess.run`` recorded, and its errors.
"""

import subprocess

import numpy as np
import pytest
import torch

import tpugs.apps.click_and_segment as jclick
import tpugs.apps.download_dataset as jdl
import tpugs.apps.viewer as jviewer
import tpugs.apps.viewer_llm as jllm
from tpugs.utils.synthetic import orbit_cameras, random_scene
from tpugs_torch.apps import click_and_segment as tclick
from tpugs_torch.apps import download_dataset as tdl
from tpugs_torch.apps import viewer as tviewer
from tpugs_torch.apps import viewer_llm as tllm
from tpugs_torch.convert import SCENE_FIELDS, scene_from_numpy

W, H = 48, 32


def _port_scene(js):
    return scene_from_numpy({k: np.asarray(getattr(js, k)) for k in SCENE_FIELDS},
                            device="cpu")


def _within_one(got, ref):
    ref = np.asarray(ref)
    assert got.dtype == np.uint8 and got.shape == ref.shape
    assert np.abs(got.astype(int) - ref.astype(int)).max() <= 1


STATE_MOVES = [
    ("dolly", [("dolly", "w"), ("dolly", "a"), ("dolly", "s"), ("dolly", "d"), ("dolly", "w")]),
    ("canonical", [("set_canonical", "top"), ("dolly", "w"), ("set_canonical", "right"),
                   ("set_canonical", "front")]),
    ("orbit", [("orbit", (30.0, 10.0)), ("dolly", "d"), ("orbit", (-12.5, 40.0))]),
]


@pytest.mark.parametrize("moves", [m for _, m in STATE_MOVES], ids=[n for n, _ in STATE_MOVES])
def test_viewer_state_equals_tpugs(moves):
    frame = jviewer.estimate_scene_frame(np.asarray(orbit_cameras(6, W, H, radius=3.0).viewmats))
    t, j = tviewer.ViewerState(), jviewer.ViewerState()
    np.testing.assert_array_equal(t.viewmat(), j.viewmat())
    for op, arg in moves:
        for s in (t, j):
            if op == "set_canonical":
                s.set_canonical(arg, frame, dist=2.0)
            elif op == "orbit":
                s.orbit(*arg)
            else:
                s.dolly(arg)
        np.testing.assert_array_equal(t.viewmat(), j.viewmat())
        assert dataclass_fields(t) == dataclass_fields(j)
    with pytest.raises(ValueError):
        t.set_canonical("left", frame)


def dataclass_fields(s):
    return (s.roll, s.pitch, s.yaw, s.x, s.y, s.z, s.scale, s.base.tolist())


@pytest.mark.parametrize("rig", ["orbit6", "orbit1", "axis"])
def test_estimate_scene_frame_equals_tpugs(rig):
    if rig == "axis":  # every camera looks down the mean "down": the fallbacks
        vms = np.tile(np.eye(4, dtype=np.float32), (3, 1, 1))
        vms[:, 1, :3] = [0, 0, 1]
        vms[:, 2, :3] = [0, 0, 1]
    else:
        vms = np.asarray(orbit_cameras(6 if rig == "orbit6" else 1, W, H, radius=3.0).viewmats)
    got = tviewer.estimate_scene_frame(vms)
    np.testing.assert_array_equal(got, jviewer.estimate_scene_frame(vms))
    if rig != "axis":
        np.testing.assert_allclose(got @ got.T, np.eye(3), atol=1e-5)


def test_viewer_keys_and_mouse_equal_tpugs():
    js = random_scene(10, seed=0)
    jc = orbit_cameras(2, W, H)
    K, vms = np.asarray(jc.Ks[0]), np.asarray(jc.viewmats)
    t = tviewer.Viewer(_port_scene(js), K, W, H, viewmats=vms, device="cpu")
    j = jviewer.Viewer(js, K, W, H, viewmats=vms)
    for key in "wasd123gxg":
        assert t.handle_key(key) == j.handle_key(key)
        np.testing.assert_array_equal(t.state.viewmat(), j.state.viewmat())
        assert t.anaglyph == j.anaglyph
    for ev in [("move", 5, 5), ("down", 10, 12), ("move", 50, -8), ("move", 52, -9),
               ("up", 52, -9), ("move", 0, 0)]:
        t.handle_mouse(*ev)
        j.handle_mouse(*ev)
        np.testing.assert_array_equal(t.state.viewmat(), j.state.viewmat())
    assert not t.handle_key("q") and not j.handle_key("q")
    assert not t.handle_key("\x1b")
    bare = tviewer.Viewer(_port_scene(js), K, W, H, device="cpu")
    np.testing.assert_array_equal(bare.frame, np.eye(3))


@pytest.fixture(scope="module")
def frame_setup():
    js = random_scene(60, seed=0, extent=0.8, scale_range=(0.02, 0.1))
    jc = orbit_cameras(1, W, H, radius=2.5)
    return js, _port_scene(js), np.asarray(jc.viewmats[0]), np.asarray(jc.Ks[0])


@pytest.mark.parametrize("engine", ["tiled", "pallas"])
@pytest.mark.parametrize("kw", [{}, {"anaglyph": True}, {"axes_overlay": True}],
                         ids=["plain", "anaglyph", "axes"])
def test_render_frame_equals_tpugs(frame_setup, engine, kw):
    js, ts, vm, K = frame_setup
    if kw.get("axes_overlay"):
        pytest.importorskip("cv2")
        vm = np.array(vm, copy=True)
        vm[:3, :3] = np.eye(3, dtype=np.float32)  # the origin's axes in front of the camera
        vm[:3, 3] = [0.0, 0.0, 2.0]
    got = tviewer.render_frame(ts, vm, K, W, H, device="cpu", **kw)
    _within_one(got, jviewer.render_frame(js, vm, K, W, H, engine=engine, **kw))
    if kw.get("anaglyph"):
        plain = tviewer.render_frame(ts, vm, K, W, H, device="cpu")
        assert not np.array_equal(got, plain)
        np.testing.assert_array_equal(got[..., 0], plain[..., 0])


def test_render_frame_auto_is_pallas_and_rejects_unknown_engines(frame_setup):
    """The frame is ``render_scene``'s (the reference's "pallas" engine,
    B4 with early exit) on any device; there is no engine to choose."""
    from tpugs_torch.raster.train import render_scene
    from tpugs_torch.viz.common import to_uint8

    _, ts, vm, K = frame_setup
    img, _ = render_scene(ts, torch.tensor(vm), torch.tensor(K), W, H)
    np.testing.assert_array_equal(tviewer.render_frame(ts, vm, K, W, H, device="cpu"),
                                  to_uint8(img))
    with pytest.raises(TypeError, match="engine"):
        tviewer.render_frame(ts, vm, K, W, H, engine="tiled", device="cpu")


def test_viewer_render_uses_its_state(frame_setup):
    js, ts, vm, K = frame_setup
    t = tviewer.Viewer(ts, K, W, H, viewmats=vm[None], device="cpu")
    j = jviewer.Viewer(js, K, W, H, viewmats=vm[None])
    for key in "wg":
        t.handle_key(key)
        j.handle_key(key)
    _within_one(t.render(), j.render())


def test_unproject_project_roundtrip_equals_tpugs():
    jc = orbit_cameras(1, W, H, radius=3.0)
    vm, K = np.asarray(jc.viewmats[0]), np.asarray(jc.Ks[0])
    for x, y, d in ((20.0, 15.0, 2.5), (0.0, 31.0, 4.0), (47.5, 0.5, 0.7)):
        p = tclick.unproject_pixel(x, y, d, vm, K)
        np.testing.assert_array_equal(p, jclick.unproject_pixel(x, y, d, vm, K))
        assert tclick.project_point(p, vm, K) == jclick.project_point(p, vm, K)
    assert tclick.project_point(np.array([0.0, 0.0, -10.0]), np.eye(4), K) is None


@pytest.fixture(scope="module")
def sessions():
    """tpugs' ``_session`` (80 Gaussians, 2 views, a 6-d field from its
    eager lift) and the port's on the same scene and field."""
    from tpugs.encoders.base import LinearRGBEncoder
    from tpugs.lift.backproject import create_feature_field

    js = random_scene(80, seed=0, extent=0.8, scale_range=(0.02, 0.1))
    jc = orbit_cameras(2, W, H, radius=2.5)
    feats = np.array(create_feature_field(js, jc, LinearRGBEncoder(feature_dim=6),
                                          verbose=False))
    vm, K = np.asarray(jc.viewmats[0]), np.asarray(jc.Ks[0])
    j = jclick.PromptSession(js, feats)
    t = tclick.PromptSession(_port_scene(js), feats, device="cpu")
    return j, t, vm, K, j.render_rgbd_features(vm, K, W, H), t.render_rgbd_features(vm, K, W, H)


def test_prompt_session_renders_equal_tpugs(sessions):
    _, _, _, _, (j_rgbd, j_feat), (t_rgbd, t_feat) = sessions
    assert t_rgbd.shape == (H, W, 4) and t_feat.shape == (H, W, 6)
    assert t_rgbd.device.type == "cpu" and t_feat.dtype == torch.float32
    np.testing.assert_allclose(t_rgbd.numpy(), j_rgbd, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(t_feat.numpy(), j_feat, rtol=1e-5, atol=1e-5)


def test_prompt_session_click_mask_and_panes_equal_tpugs(sessions):
    j, t, vm, K, (j_rgbd, j_feat), (t_rgbd, t_feat) = sessions
    j.prompts.clear()
    t.prompts.clear()
    assert t.mask3d() is None
    a = j_rgbd[..., 3]
    y, x = np.unravel_index(np.argmax(np.isfinite(a) * (a > 0) * 1.0), a.shape)
    for (px, py, positive) in ((int(x), int(y), True), (0, 0, False)):
        pj = j.add_click(px, py, j_rgbd, j_feat, vm, K, positive=positive)
        pt = t.add_click(px, py, t_rgbd, t_feat, vm, K, positive=positive)
        np.testing.assert_allclose(pt.anchor, pj.anchor, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(pt.feature, pj.feature, rtol=1e-5, atol=1e-5)
        assert pt.positive == positive
    mask = t.mask3d()
    assert mask.dtype == torch.bool and mask.shape == (80,)
    np.testing.assert_array_equal(mask.numpy(), j.mask3d())
    pane = t.three_pane(vm, K, W, H)
    assert pane.shape == (H, 3 * W, 3)
    _within_one(pane, j.three_pane(vm, K, W, H))


def test_prompt_session_without_a_mask_and_with_other_feature(sessions):
    j, t, vm, K, (j_rgbd, j_feat), (t_rgbd, t_feat) = sessions
    j.prompts.clear()
    t.prompts.clear()
    _within_one(t.three_pane(vm, K, W, H), j.three_pane(vm, K, W, H))  # no mask: blank pane
    j.add_click(20, 14, j_rgbd, j_feat, vm, K)
    t.add_click(20, 14, t_rgbd, t_feat, vm, K)
    other = -np.asarray(j_feat[14, 20])
    j.other_feature, t.other_feature = other, other
    try:
        np.testing.assert_array_equal(t.mask3d().numpy(), j.mask3d())
    finally:
        j.other_feature = t.other_feature = None


def test_prompt_removal_equals_tpugs(sessions):
    j, t, vm, K, (j_rgbd, j_feat), (t_rgbd, t_feat) = sessions
    j.prompts.clear()
    t.prompts.clear()
    for xy in ((24, 16), (5, 5), (40, 28)):
        j.add_click(*xy, j_rgbd, j_feat, vm, K)
        t.add_click(*xy, t_rgbd, t_feat, vm, K)
    for xy in ((25, 17), (100, 100), (6, 4)):
        assert t.remove_nearest(*xy, vm, K) == j.remove_nearest(*xy, vm, K)
        assert len(t.prompts) == len(j.prompts)
    assert len(t.prompts) < 3


PHRASES = [
    "show me the top view", "segment out the table", "make the vase red",
    "undo the segmentation", "quit", "blargh", "look from the left",
    "reset the colour", "restore the original", "please paint the old chair blue",
    "isolate the plant", "highlight it", "turn the lamp pink", "clear segmentation",
    "camera back", "view bottom please", "extract the red vase", "bye",
]


def test_parse_rule_based_equals_tpugs():
    for p in PHRASES:
        assert tllm.parse_rule_based(p) == jllm.parse_rule_based(p), p
    assert tllm.COLOR_TO_RGB == jllm.COLOR_TO_RGB and tllm.VIEWS == jllm.VIEWS
    assert tllm.FEW_SHOT_PROMPT == jllm.FEW_SHOT_PROMPT


LLMS = {
    "json in noise": lambda prompt: 'noise {"command": "exit"} trailing',
    "not json": lambda prompt: "not json at all",
    "json without command": lambda prompt: '{"view": "top"}',
    "broken json": lambda prompt: '{"command": "segment", }',
    "echo": lambda prompt: prompt[-40:],
}


@pytest.mark.parametrize("name", sorted(LLMS))
def test_assistant_equals_tpugs(name):
    t, j = tllm.Assistant(llm=LLMS[name]), jllm.Assistant(llm=LLMS[name])
    for p in ("quit", "segment the chair", "whatever"):
        assert t.ask(p) == j.ask(p)
    assert tllm.Assistant().ask("quit") == jllm.Assistant().ask("quit")


def test_scene_editor_apply_equals_tpugs():
    import jax.numpy as jnp

    js = random_scene(40, seed=1)
    feats = np.random.default_rng(0).normal(size=(40, 6)).astype(np.float32)
    j = jllm.SceneEditor(js, jnp.asarray(feats), exemplar_lookup=lambda name: feats[0])
    t = tllm.SceneEditor(_port_scene(js), torch.from_numpy(feats),
                         exemplar_lookup=lambda name: feats[0])
    commands = [
        {"command": "segment", "object": "table"},
        {"command": "change_color", "object": "table", "color": "red"},
        {"command": "change_color", "object": "table", "color": "mauve"},
        {"command": "reset_segmentation"},
        {"command": "reset_color"},
        {"command": "change_view", "view": "top"},
        {"command": "change_view"},
        {"command": "dance"},
        {"command": "exit"},
    ]
    for cmd in commands:
        assert t.apply(cmd) == j.apply(cmd), cmd
        for k in SCENE_FIELDS:
            np.testing.assert_allclose(getattr(t.scene, k).numpy(), np.asarray(getattr(j.scene, k)),
                                       rtol=1e-6, atol=1e-6, err_msg=f"{cmd} {k}")
        assert t.view == j.view
    np.testing.assert_array_equal(t.last_mask.numpy(), j.last_mask)
    assert t.last_mask.sum() > 0
    for k in ("logit_opacities", "sh0", "shN"):  # the resets restore the original tensors
        assert getattr(t.scene, k) is getattr(t.original, k)
    bare_t, bare_j = tllm.SceneEditor(t.original, feats), jllm.SceneEditor(js, jnp.asarray(feats))
    none_t = tllm.SceneEditor(t.original, feats, exemplar_lookup=lambda name: None)
    for cmd in commands[:2]:
        assert bare_t.apply(cmd) == bare_j.apply(cmd) == {"status": "no-query-backend"}
        assert none_t.apply(cmd) == {"status": "no-query-backend"}


def test_scene_editor_text_encoder_equals_tpugs():
    import jax.numpy as jnp

    js = random_scene(30, seed=2)
    feats = np.random.default_rng(1).normal(size=(30, 5)).astype(np.float32)
    q = np.random.default_rng(2).normal(size=(2, 5)).astype(np.float32)
    j = jllm.SceneEditor(js, jnp.asarray(feats), text_encoder=lambda prompts: jnp.asarray(q))
    t = tllm.SceneEditor(_port_scene(js), feats, text_encoder=lambda prompts: q)
    cmd = {"command": "segment", "object": "vase"}
    assert t.apply(cmd) == j.apply(cmd)
    np.testing.assert_array_equal(t.last_mask.numpy(), j.last_mask)


def test_make_backend_specs():
    from tpugs_torch.apps.llm_backend import make_backend

    assert make_backend("", device="cpu") is None and make_backend("none") is None
    with pytest.raises(ValueError, match="unknown llm backend"):
        make_backend("bogus", device="cpu")


@pytest.fixture(scope="module")
def tiny_llms():
    pytest.importorskip("transformers")
    pytest.importorskip("tokenizers")
    from tpugs.apps.llm_backend import make_backend as j_make
    from tpugs_torch.apps.llm_backend import make_backend as t_make

    torch.manual_seed(1234)
    before = torch.get_rng_state()
    t = t_make("tiny-random", device="cpu")
    unchanged = torch.equal(before, torch.get_rng_state())
    return t, j_make("tiny-random"), unchanged


def test_tiny_random_backend_answers_as_tpugs(tiny_llms):
    t, j, unchanged = tiny_llms
    assert unchanged  # the weights were drawn under fork_rng
    for q in ("make the chair blue", "show me the top view"):
        raw = t(jllm.FEW_SHOT_PROMPT.replace("{query}", q))
        assert isinstance(raw, str) and raw == j(jllm.FEW_SHOT_PROMPT.replace("{query}", q))
    out = tllm.Assistant(llm=t).ask("show me the top view")
    assert out == jllm.Assistant(llm=j).ask("show me the top view")
    assert out == {"command": "change_view", "view": "top"}


class _Recorder:
    def __init__(self, fail_first=False):
        self.calls, self.fail_first = [], fail_first

    def __call__(self, cmd, check=False):
        self.calls.append(list(cmd))
        if self.fail_first and len(self.calls) == 1:
            raise subprocess.CalledProcessError(4, cmd)


@pytest.mark.parametrize("dataset", sorted(jdl.DATASETS))
def test_download_dataset_commands_equal_tpugs(dataset, tmp_path, monkeypatch, capsys):
    assert tdl.DATASETS == jdl.DATASETS
    calls = {}
    for name, mod in (("port", tdl), ("tpugs", jdl)):
        rec = _Recorder()
        monkeypatch.setattr(subprocess, "run", rec)
        mod.main(save_dir=str(tmp_path / "data"), dataset=dataset)
        calls[name] = rec.calls
    assert calls["port"] == calls["tpugs"] and len(calls["port"]) == 2
    assert calls["port"][0][:2] == ["wget", "-c"] and calls["port"][1][0] == "unzip"
    assert "Extracted to" in capsys.readouterr().out


def test_download_dataset_errors(tmp_path, monkeypatch):
    with pytest.raises(ValueError, match="unknown dataset"):
        tdl.main(save_dir=str(tmp_path), dataset="bogus")
    rec = _Recorder(fail_first=True)
    monkeypatch.setattr(subprocess, "run", rec)
    with pytest.raises(RuntimeError, match="no network"):
        tdl.main(save_dir=str(tmp_path))
    assert len(rec.calls) == 1

"""The trainer's evaluation and files, the dataset, normalisation,
trajectories and the live viewer, against tpugs on the CPU (64x48, 120
Gaussians; tpugs' trainer on its Pallas engine in interpret mode):

* ``evaluate`` with LPIPS (``random_lpips_params("alex", 0)``) on two
  views: PSNR, SSIM and LPIPS within 1e-5 relative of tpugs';
* ``eval_compression`` on the split and without one: the same compressed
  bytes, PSNR against the uncompressed renders within 1e-5 relative;
* tpugs' ``load_scene_npz`` reads the port's ``save_checkpoint``;
* ``save_checkpoint_full`` / ``load_checkpoint_full`` after densification
  (with pose and appearance optimisation): a fresh trainer restores every
  tensor bit for bit (scene, Adam moments and step counts, pose and
  appearance params and states, the step) and takes a finite step;
* ``stage_dataset`` equal to tpugs' (depth points padded and masked);
* ``normalize.py`` and ``traj.py`` within 1e-6 of tpugs';
* ``Parser`` / ``Dataset`` against tpugs' on a COLMAP model of 6 pinhole
  views with per-image 3D points (normalised, depths loaded) and on one
  OPENCV-distorted view as ``tests/test_undistort.py`` builds one;
* the viewer's HTTP surface as ``tests/test_viewer_live.py`` drives it,
  and ``orbit_viewmat`` equal to tpugs'.
"""

import json
import os
import urllib.error
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpugs.io import checkpoints as jck
from tpugs.io.colmap import ColmapCamera, ColmapImage, ColmapPoint3D, rotmat_to_qvec
from tpugs.io.colmap import write_sparse_model
from tpugs.train import dataset as jd
from tpugs.train import normalize as jn
from tpugs.train import traj as jtraj
from tpugs.train import viewer as jv
from tpugs.train.config import TrainConfig as JTrainConfig
from tpugs.train.lpips import random_lpips_params as j_random_lpips
from tpugs.train.trainer import Trainer as JTrainer
from tpugs.train.trainer import init_scene_from_points as j_init
from tpugs.utils.synthetic import orbit_cameras
from tpugs_torch.convert import scene_to_numpy
from tpugs_torch.train import dataset as td
from tpugs_torch.train import normalize as tn
from tpugs_torch.train import traj as ttraj
from tpugs_torch.train import viewer as tv
from tpugs_torch.train.config import TrainConfig
from tpugs_torch.train.lpips import random_lpips_params
from tpugs_torch.train.trainer import Trainer, init_scene_from_points

W, H, N = 64, 48, 120
KW = dict(max_steps=8, sh_degree=1, feature_dim=0, strategy="none", random_bkgd=False,
          pallas_trans_eps=0.0)


@pytest.fixture(scope="module")
def trainers():
    rng = np.random.default_rng(11)
    pts = rng.uniform(-0.8, 0.8, (N, 3)).astype(np.float32)
    rgbs = rng.uniform(0, 1, (N, 3)).astype(np.float32)
    cams = orbit_cameras(3, W, H, radius=2.5)
    jt = JTrainer(JTrainConfig(raster_engine="pallas", **KW), j_init(pts, rgbs, JTrainConfig(**KW)),
                  1.0, width=W, height=H, n_cameras=3,
                  lpips_params=j_random_lpips("alex", 0))
    pt = Trainer(TrainConfig(**KW), init_scene_from_points(pts, rgbs, TrainConfig(**KW),
                                                           device="cpu"),
                 1.0, width=W, height=H, n_cameras=3,
                 lpips_params=random_lpips_params("alex", 0), device="cpu")
    views = []
    for c in range(3):  # targets near the renders, so that SSIM and LPIPS are not at an end
        vm, K = np.array(cams.viewmats[c]), np.array(cams.Ks[c])
        img = np.asarray(jt.render_eval(jnp.asarray(vm), jnp.asarray(K))[0])
        img = np.clip(img + rng.normal(0, 0.05, img.shape), 0, 1).astype(np.float32)
        views.append({"viewmat": vm, "K": K, "image": img, "image_id": c})
    return jt, pt, views


def test_evaluate_matches_tpugs(trainers):
    jt, pt, views = trainers
    ref = jt.evaluate(views[:2])
    got = pt.evaluate(views[:2])
    assert set(got) == set(ref) and got["num_GS"] == ref["num_GS"] == N
    for k in ("psnr", "ssim", "lpips"):
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-5, err_msg=k)
    assert got["ellipse_time"] > 0
    assert pt.evaluate(views, max_images=1)["psnr"] == pytest.approx(
        pt.evaluate(views[:1])["psnr"])


def test_eval_compression_matches_tpugs(trainers):
    pytest.importorskip("imageio")
    jt, pt, views = trainers
    for ds in (views[:2], None):
        ref = jt.eval_compression(ds)
        got = pt.eval_compression(ds)
        # the same PNG pixels (test_torch_io.py); cv2's zlib is not Pillow's
        assert 0 < got["compressed_bytes"] <= 1.1 * ref["compressed_bytes"]
        np.testing.assert_allclose(got["psnr_vs_uncompressed"], ref["psnr_vs_uncompressed"],
                                   rtol=1e-5)


def test_tpugs_reads_the_port_checkpoint(trainers, tmp_path):
    _, pt, _ = trainers
    path = str(tmp_path / "ckpts" / "ckpt_0.npz")
    pt.save_checkpoint(path)
    loaded = jck.load_scene_npz(path)
    for k, v in scene_to_numpy(pt.scene).items():
        np.testing.assert_array_equal(np.asarray(getattr(loaded, k)), v, err_msg=k)
    pt.save_stats({"psnr": 1.5}, str(tmp_path / "stats" / "s.json"))
    assert json.loads((tmp_path / "stats" / "s.json").read_text()) == {"psnr": 1.5}


def _state_tensors(tr):
    """Every tensor of the trainer's state, by name."""
    out = {f"scene.{k}": v for k, v in scene_to_numpy(tr.scene).items()}
    opts = {"opt": tr.optimizer, "pose_opt": tr.pose_optimizer, "app_opt": tr.app_optimizer}
    for name, opt in opts.items():
        for idx, st in opt.state_dict()["state"].items():
            for k, v in st.items():
                out[f"{name}.{idx}.{k}"] = torch.as_tensor(v).numpy()
    out["pose"] = tr.pose_params.detach().numpy()
    for k, v in tr.app_module.state_dict().items():
        out[f"app.{k}"] = v.numpy()
    return out


def test_full_checkpoint_round_trip_after_densification(trainers, tmp_path):
    _, _, views = trainers
    kw = {**KW, "feature_dim": 4, "feature_out_dim": 2, "strategy": "default",
          "refine_start_iter": 1, "refine_every": 2, "refine_stop_iter": 100,
          "grow_grad2d": 1e-12, "prune_opa": -1.0, "capacity_multiple": 64,
          "pose_opt": True, "app_opt": True}
    rng = np.random.default_rng(12)
    pts = rng.uniform(-0.8, 0.8, (N, 3)).astype(np.float32)
    rgbs = rng.uniform(0, 1, (N, 3)).astype(np.float32)

    def fresh():
        return Trainer(TrainConfig(**kw), init_scene_from_points(
            pts, rgbs, TrainConfig(**kw), device="cpu"), 1.0, width=W, height=H,
            n_cameras=3, device="cpu")

    tr = fresh()
    for s in range(4):  # a refine at step 2, then one step on the new optimizer
        tr.train_step(views[s % 3])
    assert tr.scene.num_gaussians > N and tr.scene.num_gaussians % 64 == 0
    path = str(tmp_path / "ckpts" / "full_4.npz")
    tr.save_checkpoint_full(path)
    back = fresh()
    assert back.scene.num_gaussians == N
    back.load_checkpoint_full(path)
    assert back.step == tr.step == 4
    want, got = _state_tensors(tr), _state_tensors(back)
    assert set(got) == set(want) and any(k.endswith(".exp_avg_sq") for k in got)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    assert back.grad_state.count.shape == (back.scene.num_gaussians,)
    assert back.means_step_count() == tr.means_step_count() == 1
    assert np.isfinite(back.train_step(views[0])["loss"])


def test_stage_dataset_matches_tpugs(trainers):
    jt, pt, views = trainers
    rng = np.random.default_rng(13)
    ds = [{**v, "points": rng.uniform(0, [W, H], (30 + 10 * i, 2)).astype(np.float32),
           "depths": rng.uniform(2, 3, 30 + 10 * i).astype(np.float32)}
          for i, v in enumerate(views)]
    jt.cfg.depth_loss = pt.cfg.depth_loss = True
    try:
        ref = jt.stage_dataset(ds)
        got = pt.stage_dataset(ds)
    finally:
        jt.cfg.depth_loss = pt.cfg.depth_loss = False
    assert set(got) == set(ref)
    for k in ref:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]), err_msg=k)


def test_normalize_and_traj_match_tpugs():
    rng = np.random.default_rng(14)
    cams = orbit_cameras(6, W, H, radius=2.5)
    c2w = np.linalg.inv(np.asarray(cams.viewmats, np.float64))
    pts = rng.normal(size=(200, 3)) * [1.0, 0.5, 0.2]
    for strict, center in ((False, "focus"), (True, "poses")):
        np.testing.assert_allclose(tn.similarity_from_cameras(c2w, strict, center),
                                   jn.similarity_from_cameras(c2w, strict, center), atol=1e-6)
    T = tn.align_principle_axes(pts)
    np.testing.assert_allclose(T, jn.align_principle_axes(pts), atol=1e-6)
    np.testing.assert_allclose(tn.transform_points(T, pts), jn.transform_points(T, pts),
                               atol=1e-6)
    np.testing.assert_allclose(tn.transform_cameras(T, c2w.copy()),
                               jn.transform_cameras(T, c2w.copy()), atol=1e-6)
    np.testing.assert_allclose(ttraj.generate_interpolated_path(c2w, 4),
                               jtraj.generate_interpolated_path(c2w, 4), atol=1e-6)
    for fn in ("generate_ellipse_path_z", "generate_ellipse_path_y"):
        np.testing.assert_allclose(getattr(ttraj, fn)(c2w, 12, 0.1, 0.3),
                                   getattr(jtraj, fn)(c2w, 12, 0.1, 0.3), atol=1e-6)
    np.testing.assert_allclose(ttraj.c2w_to_viewmat(c2w[2]), jtraj.c2w_to_viewmat(c2w[2]),
                               atol=1e-6)


def _write_pinhole(root, n_images=6):
    """6 orbit views of one PINHOLE camera; each image sees a subset of 80
    points through its ``point3D_ids``."""
    imageio = pytest.importorskip("imageio.v2")
    rng = np.random.default_rng(15)
    cams = orbit_cameras(n_images, W, H, radius=2.5)
    K = np.asarray(cams.Ks[0], np.float64)
    cameras = {1: ColmapCamera(1, "PINHOLE", W, H, np.array([K[0, 0], K[1, 1], K[0, 2],
                                                             K[1, 2]]))}
    images = {}
    os.makedirs(os.path.join(root, "images"), exist_ok=True)
    for i in range(n_images):
        vm = np.asarray(cams.viewmats[i], np.float64)
        ids = rng.choice(np.arange(1, 81), 30, replace=False)
        ids[:3] = -1  # unmatched keypoints
        name = f"frame_{i:04d}.png"
        images[i + 1] = ColmapImage(i + 1, rotmat_to_qvec(vm[:3, :3]), vm[:3, 3], 1, name,
                                    rng.uniform(0, 60, (30, 2)), ids.astype(np.int64))
        imageio.imwrite(os.path.join(root, "images", name),
                        rng.integers(0, 255, (H, W, 3)).astype(np.uint8))
    points = {j: ColmapPoint3D(j, rng.uniform(-0.5, 0.5, 3), rng.integers(0, 255, 3)
                               .astype(np.uint8), 0.1 * j, np.array([1], np.int64),
                               np.array([0], np.int64)) for j in range(1, 81)}
    write_sparse_model(os.path.join(root, "sparse/0"), cameras, images, points)


def _write_distorted(root):
    imageio = pytest.importorskip("imageio.v2")
    pytest.importorskip("cv2")
    w, h = 200, 150
    cam = ColmapCamera(1, "OPENCV", w, h, np.array([120.0, 120.0, w / 2 - 0.5, h / 2 - 0.5,
                                                    -0.2, 0.05, 0.001, -0.001]))
    img = ColmapImage(1, np.array([1.0, 0, 0, 0]), np.zeros(3), 1, "frame.png",
                      np.zeros((0, 2)), np.zeros((0,), np.int64))
    pt = ColmapPoint3D(1, np.zeros(3), np.zeros(3, np.uint8), 0.1, np.array([1], np.int64),
                       np.array([0], np.int64))
    write_sparse_model(os.path.join(root, "sparse/0"), {1: cam}, {1: img}, {1: pt})
    y, x = np.mgrid[0:h, 0:w]
    pattern = np.stack([np.sin(x / 17.0) * np.cos(y / 13.0), np.cos(x / 23.0),
                        np.sin((x + y) / 29.0)], axis=-1)
    os.makedirs(os.path.join(root, "images"), exist_ok=True)
    imageio.imwrite(os.path.join(root, "images", "frame.png"),
                    ((0.5 + 0.5 * pattern) * 255).astype(np.uint8))


def _same_parser(ours, ref):
    assert ours.image_names == ref.image_names and ours.camera_ids == ref.camera_ids
    assert [os.path.basename(p) for p in ours.image_paths] == \
        [os.path.basename(p) for p in ref.image_paths]
    for k in ("camtoworlds", "points", "points_rgb", "points_err", "transform"):
        np.testing.assert_allclose(getattr(ours, k), getattr(ref, k), atol=1e-6, err_msg=k)
    assert ours.scene_scale == pytest.approx(ref.scene_scale, rel=1e-12)
    for k in ("Ks_dict", "params_dict", "mapx_dict", "mapy_dict"):
        a, b = getattr(ours, k), getattr(ref, k)
        assert set(a) == set(b), k
        for c in a:
            np.testing.assert_array_equal(a[c], b[c], err_msg=f"{k}[{c}]")
    assert ours.imsize_dict == ref.imsize_dict and ours.roi_undist_dict == ref.roi_undist_dict
    assert set(ours.point_indices) == set(ref.point_indices)
    for k in ours.point_indices:
        np.testing.assert_array_equal(ours.point_indices[k], ref.point_indices[k])


@pytest.mark.parametrize("kind", ["pinhole", "opencv"])
def test_parser_and_dataset_match_tpugs(kind, tmp_path):
    root = str(tmp_path / kind)
    (_write_pinhole if kind == "pinhole" else _write_distorted)(root)
    normalize = kind == "pinhole"
    ours = td.Parser(root, factor=1, normalize=normalize, test_every=3)
    ref = jd.Parser(root, factor=1, normalize=normalize, test_every=3)
    _same_parser(ours, ref)
    items = 0
    for split in ("train", "val"):
        a = td.Dataset(ours, split, load_depths=True)
        b = jd.Dataset(ref, split, load_depths=True)
        assert len(a) == len(b)
        items += len(a)
        np.testing.assert_array_equal(a.indices, b.indices)
        for i in range(len(a)):
            x, y = a[i], b[i]
            assert set(x) == set(y) and x["image_id"] == y["image_id"]
            assert x["image_name"] == y["image_name"]
            for k in ("image", "K", "viewmat", "points", "depths"):
                np.testing.assert_allclose(x[k], y[k], atol=1e-6, err_msg=k)
    assert items == ours.num_images
    if normalize:
        assert sum(len(td.Dataset(ours, "train", load_depths=True)[i]["points"])
                   for i in range(4)) > 0
    else:
        assert ours.mapx_dict and ours.imsize_dict[1] != (200, 150)


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=10) as r:
        return r.status, r.headers.get("Content-Type"), r.read()


def test_viewer_http_surface_and_orbit():
    pytest.importorskip("imageio")
    v = tv.LiveViewer(port=0, host="127.0.0.1")
    try:
        status, ctype, body = _get(v.port, "/")
        assert status == 200 and "text/html" in ctype and b"tpugs" in body
        with pytest.raises(urllib.error.HTTPError) as e:
            _get(v.port, "/frame.png")
        assert e.value.code == 404
        assert v.render_request() is None
        frame = np.zeros((24, 32, 3), np.uint8)
        frame[:, :16] = (255, 0, 0)
        v.update(100, {"loss": 0.5}, frame, num_rays_per_step=32 * 24)
        status, ctype, body = _get(v.port, "/frame.png")
        assert status == 200 and ctype == "image/png" and body[:8] == b"\x89PNG\r\n\x1a\n"
        v.update(200, {"loss": 0.4}, None, num_rays_per_step=32 * 24)
        stats = json.loads(_get(v.port, "/stats.json")[2])
        assert stats["step"] == 200 and stats["loss"] == 0.4 and stats["steps_per_s"] > 0
        assert stats["rays_per_s"] > 0
        req = urllib.request.Request(
            f"http://127.0.0.1:{v.port}/camera", method="POST",
            data=json.dumps({"yaw": 1.5, "pitch": -0.2, "radius": 4.0}).encode())
        with urllib.request.urlopen(req, timeout=10) as r:
            assert r.status == 200
        assert v.render_request() == {"yaw": 1.5, "pitch": -0.2, "radius": 4.0}
        bad = urllib.request.Request(f"http://127.0.0.1:{v.port}/camera", data=b"{no",
                                     method="POST")
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(bad, timeout=10)
        assert e.value.code == 400
    finally:
        v.close()
    center = np.array([0.1, -0.2, 0.3])
    for yaw, pitch in ((0.3, 0.2), (1.0, -1.2), (0.0, np.pi / 2)):
        np.testing.assert_array_equal(tv.orbit_viewmat(center, yaw, pitch, 3.0),
                                      jv.orbit_viewmat(center, yaw, pitch, 3.0))
    # cv2 writes the PNG, Pillow tpugs': the same pixels, other bytes
    import imageio.v2 as imageio

    np.testing.assert_array_equal(imageio.imread(tv.encode_png(frame)),
                                  imageio.imread(jv.encode_png(frame)))

"""The port's I/O against tpugs' on the CPU: every format written by one
package is read by the other, and both read it to the same values.

* COLMAP binary: each package's ``write_synthetic_colmap`` of the same rig
  writes the same bytes; each package's ``SceneManager`` reads either's
  model to equal cameras, poses and points; COLMAP text: the same files
  read alike; ``qvec_to_rotmat``/``rotmat_to_qvec`` equal;
* scenes: PLY, ``.pt`` in the gsplat layout (with a feature field) and
  the inria layout, ``.npz`` and the PNG-grid compression, each written by
  one package and read by the other, float-equal to the source (the
  compression: equal to the other package's decompression of the same
  files);
* ``load_checkpoint`` on a single camera with a non-integer principal
  point after ``data_factor`` (the ``int`` truncation) and on a rig of
  two cameras of one render size (each image its own K, image-name
  order): the same scene, cameras and size, float-equal;
* ``cameras_from_colmap``, ``Camera.cam_centers``, ``__getitem__`` and
  ``rpy_matrix`` against tpugs' (centres 1e-6: two einsum orders).
"""

import os

import numpy as np
import pytest
import torch

from tpugs.core import camera as jcam
from tpugs.io import checkpoints as jck
from tpugs.io import colmap as jcol
from tpugs.io import compression as jcomp
from tpugs.utils import synthetic as jsyn
from tpugs_torch.convert import FEATURE_FIELDS, SCENE_FIELDS, scene_from_numpy, scene_to_numpy
from tpugs_torch.core import camera as tcam
from tpugs_torch.io import checkpoints as tck
from tpugs_torch.io import colmap as tcol
from tpugs_torch.io import compression as tcomp
from tpugs_torch.utils import synthetic as tsyn

FIELDS = SCENE_FIELDS + FEATURE_FIELDS


def _j_arrays(scene):
    return {k: np.asarray(getattr(scene, k)) for k in FIELDS if getattr(scene, k) is not None}


def _assert_scenes_equal(a: dict, b: dict):
    assert set(a) == set(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.fixture(scope="module")
def jscene():
    return jsyn.random_scene(20, seed=3, feature_dim=6)


@pytest.fixture(scope="module")
def tscene(jscene):
    return scene_from_numpy(_j_arrays(jscene), device="cpu")


def test_quaternion_conversions_match_tpugs():
    rng = np.random.default_rng(0)
    for _ in range(10):
        q = rng.normal(size=4)
        q /= np.linalg.norm(q)
        R = tcol.qvec_to_rotmat(q)
        np.testing.assert_array_equal(R, jcol.qvec_to_rotmat(q))
        np.testing.assert_array_equal(tcol.rotmat_to_qvec(R), jcol.rotmat_to_qvec(R))


def _read_model(col, sparse):
    sm = col.SceneManager(sparse).load_all()
    xyz, rgb = sm.points_array()
    cams = {i: (c.model, c.width, c.height, tuple(c.params)) for i, c in sm.cameras.items()}
    ims = {i: (im.name, im.camera_id, tuple(im.qvec), tuple(im.tvec), im.xys.tolist(),
               im.point3D_ids.tolist()) for i, im in sm.images.items()}
    return cams, ims, xyz, rgb, sm.points_err_array(), sm.point_ids_array()


def test_colmap_bin_both_ways(tmp_path):
    jc = jsyn.orbit_cameras(3, 64, 48, radius=2.5)
    tc = tsyn.orbit_cameras(3, 64, 48, radius=2.5, device="cpu")
    jsyn.write_synthetic_colmap(str(tmp_path / "j"), jc, n_points=17, seed=4)
    tsyn.write_synthetic_colmap(str(tmp_path / "t"), tc, n_points=17, seed=4)
    for name in ("cameras.bin", "images.bin", "points3D.bin"):
        a = (tmp_path / "j" / "sparse/0" / name).read_bytes()
        assert a == (tmp_path / "t" / "sparse/0" / name).read_bytes(), name
    for writer in ("j", "t"):
        sparse = str(tmp_path / writer / "sparse/0")
        got, ref = _read_model(tcol, sparse), _read_model(jcol, sparse)
        assert got[:2] == ref[:2]
        for a, b in zip(got[2:], ref[2:]):
            np.testing.assert_array_equal(a, b)
        assert len(got[1]) == 3 and got[2].shape == (17, 3)


def test_colmap_txt_read_alike(tmp_path):
    d = tmp_path / "sparse" / "0"
    d.mkdir(parents=True)
    (d / "cameras.txt").write_text("# comment\n1 PINHOLE 640 480 500 501 320 240\n"
                                   "2 SIMPLE_RADIAL 640 480 400 320 240 0.01\n")
    (d / "images.txt").write_text("# hdr\n1 1 0 0 0 0.5 -0.2 3.0 1 img0.jpg\n"
                                  "10.0 20.0 5 30.0 40.0 -1\n"
                                  "2 0.5 0.5 0.5 0.5 1 2 3 2 img1.jpg\n\n")
    (d / "points3D.txt").write_text("5 1 2 3 200 100 50 0.5 1 0\n7 -1 0 2 1 2 3 0.25 1 1 2 0\n")
    got, ref = _read_model(tcol, str(d)), _read_model(jcol, str(d))
    assert got[:2] == ref[:2]
    for a, b in zip(got[2:], ref[2:]):
        np.testing.assert_array_equal(a, b)
    sm = tcol.SceneManager(str(d)).load_all()
    assert sm.cameras[2].fy == sm.cameras[2].fx == 400 and sm.images[1].name == "img0.jpg"


@pytest.mark.parametrize("fmt", ["ply", "gsplat", "npz"])
def test_scene_files_both_ways(tmp_path, jscene, tscene, fmt):
    """Written by tpugs, read by the port; written by the port, read by
    tpugs; both float-equal to the source (PLY carries no feature field)."""
    ext = {"ply": "ply", "gsplat": "pt", "npz": "npz"}[fmt]
    j_save = {"ply": jck.save_scene_ply, "gsplat": jck.save_scene_pt, "npz": jck.save_scene_npz}
    t_save = {"ply": tck.save_scene_ply, "gsplat": tck.save_scene_pt, "npz": tck.save_scene_npz}
    j_load = {"ply": jck.load_scene_ply, "gsplat": jck.load_scene_pt, "npz": jck.load_scene_npz}
    t_load = {"ply": lambda p: tck.load_scene_ply(p, device="cpu"),
              "gsplat": lambda p: tck.load_scene_pt(p, "gsplat", device="cpu"),
              "npz": lambda p: tck.load_scene_npz(p, device="cpu")}
    src = _j_arrays(jscene)
    if fmt == "ply":
        src = {k: v for k, v in src.items() if k in SCENE_FIELDS}
    j_path, t_path = str(tmp_path / f"j.{ext}"), str(tmp_path / f"t.{ext}")
    j_save[fmt](jscene, j_path)
    t_save[fmt](tscene, t_path)
    _assert_scenes_equal(scene_to_numpy(t_load[fmt](j_path)), src)
    _assert_scenes_equal(_j_arrays(j_load[fmt](t_path)), src)


def test_inria_checkpoint_read_alike(tmp_path, jscene):
    """The original 3DGS code's (model_params, iteration) tuple, opacity
    (N, 1): both packages read it to the same scene."""
    a = _j_arrays(jscene)
    a = {k: v.copy() for k, v in a.items()}
    params = (3, torch.from_numpy(a["means"]), torch.from_numpy(a["sh0"]),
              torch.from_numpy(a["shN"]), torch.from_numpy(a["log_scales"]),
              torch.from_numpy(a["quats"]), torch.from_numpy(a["logit_opacities"][:, None]))
    path = str(tmp_path / "inria.pt")
    torch.save((params, 30000), path)
    got = scene_to_numpy(tck.load_scene_pt(path, "inria", device="cpu"))
    _assert_scenes_equal(got, _j_arrays(jck.load_scene_pt(path, "inria")))
    _assert_scenes_equal(got, {k: a[k] for k in SCENE_FIELDS})
    with pytest.raises(ValueError):
        tck.load_scene_pt(path, "splatfacto", device="cpu")


def test_compression_both_ways(tmp_path):
    js = jsyn.random_scene(40, seed=5, extent=0.8)
    ts = scene_from_numpy(_j_arrays(js), device="cpu")
    j_dir, t_dir = str(tmp_path / "j"), str(tmp_path / "t")
    assert jcomp.compress_scene(js, j_dir) == tcomp.compress_scene(ts, t_dir)
    for name in sorted(os.listdir(j_dir)):
        assert (tmp_path / "j" / name).read_bytes() == (tmp_path / "t" / name).read_bytes(), name
    for d in (j_dir, t_dir):
        _assert_scenes_equal(scene_to_numpy(tcomp.decompress_scene(d, device="cpu")),
                             _j_arrays(jcomp.decompress_scene(d)))
    assert tcomp.compressed_size_bytes(t_dir) == jcomp.compressed_size_bytes(j_dir)


def _rig_model(sparse, rig: bool):
    """Images named out of order; one camera with cx, cy = 64.5, 48.5, or
    two of one render size with different focal lengths."""
    rng = np.random.default_rng(9)
    cams = {1: jcol.ColmapCamera(1, "PINHOLE", 129, 97, np.array([100.0, 101, 64.5, 48.5]))}
    if rig:
        cams[2] = jcol.ColmapCamera(2, "PINHOLE", 129, 97, np.array([90.0, 92, 64.5, 48.5]))
    images = {}
    for i, name in enumerate(["c.jpg", "a.jpg", "d.jpg", "b.jpg"]):
        q = rng.normal(size=4)
        q /= np.linalg.norm(q)
        images[i + 1] = jcol.ColmapImage(i + 1, q, rng.normal(size=3), 1 + (i % len(cams)),
                                         name, np.zeros((0, 2)), np.zeros((0,), np.int64))
    pts = {1: jcol.ColmapPoint3D(1, np.zeros(3), np.zeros(3, np.uint8), 0.5,
                                 np.array([1], np.int64), np.array([0], np.int64))}
    jcol.write_sparse_model(sparse, cams, images, pts)


@pytest.mark.parametrize("rig", [False, True])
def test_load_checkpoint_matches_tpugs(tmp_path, jscene, rig):
    _rig_model(str(tmp_path / "sparse/0"), rig)
    ckpt = str(tmp_path / "ckpt.pt")
    jck.save_scene_pt(jscene, ckpt)
    ts, tc, tm = tck.load_checkpoint(ckpt, str(tmp_path), "gsplat", data_factor=2, device="cpu")
    js, jc, jm = jck.load_checkpoint(ckpt, str(tmp_path), "gsplat", data_factor=2)
    _assert_scenes_equal(scene_to_numpy(ts), _j_arrays(js))
    assert (tc.width, tc.height) == (jc.width, jc.height) == (64, 48)  # int(32.25 * 2)
    np.testing.assert_array_equal(tc.viewmats.numpy(), np.asarray(jc.viewmats))
    np.testing.assert_array_equal(tc.Ks.numpy(), np.asarray(jc.Ks))
    assert len(tm.cameras) == len(jm.cameras) == (2 if rig else 1)
    if rig:
        assert not torch.equal(tc.Ks[0], tc.Ks[2])  # a, b on camera 2; c, d on camera 1
    with pytest.raises(ValueError):
        tck.load_checkpoint(ckpt, str(tmp_path), "pcd", device="cpu")


def test_camera_helpers_match_tpugs():
    jc = jsyn.orbit_cameras(5, 64, 48, radius=2.5)
    tc = tsyn.orbit_cameras(5, 64, 48, radius=2.5, device="cpu")
    np.testing.assert_allclose(tc.cam_centers.numpy(), np.asarray(jc.cam_centers), atol=1e-6)
    for idx in (2, slice(1, 4), np.array([0, 3])):
        a, b = tc[idx], jc[idx]
        np.testing.assert_array_equal(a.viewmats.numpy(), np.asarray(b.viewmats))
        np.testing.assert_array_equal(a.Ks.numpy(), np.asarray(b.Ks))
        assert (a.width, a.height, a.num_cameras) == (b.width, b.height, b.num_cameras)
    for rpy in ((0.1, -0.4, 2.0), (0.0, 0.0, 0.0), (-1.2, 0.7, -3.0)):
        np.testing.assert_array_equal(tcam.rpy_matrix(*rpy), jcam.rpy_matrix(*rpy))
    rng = np.random.default_rng(2)
    ims = [jcol.ColmapImage(i, q / np.linalg.norm(q), rng.normal(size=3), 1, f"{i}.jpg",
                            np.zeros((0, 2)), np.zeros((0,), np.int64))
           for i, q in enumerate(rng.normal(size=(3, 4)))]
    K = jcam.intrinsics_matrix(50.0, 51.0, 32.0, 24.0)
    got = tcam.cameras_from_colmap(ims, K, 64, 48, device="cpu")
    ref = jcam.cameras_from_colmap(ims, K, 64, 48)
    np.testing.assert_array_equal(got.viewmats.numpy(), np.asarray(ref.viewmats))
    np.testing.assert_array_equal(got.Ks.numpy(), np.asarray(ref.Ks))
    assert (got.width, got.height) == (ref.width, ref.height)

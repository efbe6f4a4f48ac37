"""The port's native COLMAP reader (``tpugs_torch/native``, built by g++
from its own copy of ``scene_io.cc``) against its pure-Python twins and
tpugs' reader, on a synthetic model with shuffled point ids,
variable-length tracks and unicode names: field for field equal; a
truncated file raises; the native writer round-trips; processes that
start at once, with nothing built, all load the library (one build under
the file lock). Without g++ these skip: the readers then run the twins."""

import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import tpugs_torch.native as native
from tpugs.io import colmap as jcol
from tpugs_torch.io import colmap as C
from tpugs_torch.native import scene_io

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("no g++: the native reader is not built here")
    rng = np.random.default_rng(7)
    n_images, n_points = 5, 137
    cams = {i + 1: C.ColmapCamera(i + 1, "PINHOLE", 640, 480,
                                  np.array([500.0 + i, 501.0, 320.0, 240.0]))
            for i in range(2)}
    images = {}
    for i in range(n_images):
        q = rng.normal(size=4)
        q /= np.linalg.norm(q)
        m = int(rng.integers(0, 9))
        images[i + 1] = C.ColmapImage(
            i + 1, q, rng.normal(size=3), 1 + i % 2, f"frame_é{i:04d}.png",
            rng.normal(size=(m, 2)), rng.integers(-1, n_points, size=m).astype(np.int64))
    points = {}
    for pid in rng.permutation(np.arange(1, n_points * 3, 3)):  # non-contiguous, shuffled
        t = int(rng.integers(0, 6))
        points[int(pid)] = C.ColmapPoint3D(
            int(pid), rng.normal(size=3), rng.integers(0, 256, size=3).astype(np.uint8),
            float(rng.uniform()), rng.integers(1, n_images + 1, size=t).astype(np.int64),
            rng.integers(0, 50, size=t).astype(np.int64))
    sparse = str(tmp_path_factory.mktemp("native") / "sparse" / "0")
    C.write_sparse_model(sparse, cams, images, points)
    return sparse, images, points


def test_native_library_builds_from_the_ports_source(model_dir):
    assert native.available()
    assert native.library_path().exists()
    assert native.library_path().parent == REPO / "build" / "tpugs_torch"
    assert native.SRC == REPO / "tpugs_torch" / "native" / "scene_io.cc"


def test_images_native_matches_plain_and_tpugs(model_dir):
    sparse, src, _ = model_dir
    path = os.path.join(sparse, "images.bin")
    nat = C._read_images_bin_native(path)
    assert nat is not None, "the native parse did not engage"
    for other in (C.read_images_bin_plain(path), jcol.read_images_bin(path)):
        assert set(nat) == set(other) == set(src)
        for iid in src:
            a, b = nat[iid], other[iid]
            assert a.name == b.name == src[iid].name and a.camera_id == b.camera_id
            for f in ("qvec", "tvec", "xys", "point3D_ids"):
                np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)


def test_points_native_matches_plain_and_tpugs(model_dir):
    sparse, _, src = model_dir
    path = os.path.join(sparse, "points3D.bin")
    cols = C.read_points3d_bin_columnar(path)
    assert cols is not None, "the native parse did not engage"
    assert np.all(np.diff(cols["pid"]) > 0)  # sorted by id, though written shuffled
    j_cols = jcol.read_points3d_bin_columnar(path)
    for k in cols:
        np.testing.assert_array_equal(cols[k], j_cols[k], err_msg=k)
    nat = C.read_points3d_bin(path)
    for other in (C.read_points3d_bin_plain(path), jcol.read_points3d_bin(path)):
        assert set(nat) == set(other) == set(src)
        for pid in src:
            a, b = nat[pid], other[pid]
            assert a.error == b.error
            for f in ("xyz", "rgb", "image_ids", "point2D_idxs"):
                np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)


def test_scene_manager_serves_columns_lazily(model_dir):
    sparse, _, src = model_dir
    sm = C.SceneManager(sparse).load_all()
    xyz, _ = sm.points_array()
    pids = sm.point_ids_array()
    assert sm._points3D is None, "the point objects were built too early"
    np.testing.assert_array_equal(xyz, np.stack([src[p].xyz for p in sorted(src)]))
    np.testing.assert_array_equal(pids, np.sort(list(src)))
    assert len(sm.points3D) == len(src)


def test_truncated_files_raise(model_dir):
    sparse, *_ = model_dir
    data = Path(sparse, "points3D.bin").read_bytes()
    with pytest.raises(ValueError):
        scene_io.parse_points3d(data[: len(data) - 3])
    with pytest.raises(ValueError):
        scene_io.parse_images(b"\x01" + b"\x00" * 7)  # claims one image, holds none


def test_native_points_writer_round_trips(model_dir):
    sparse, *_ = model_dir
    path = os.path.join(sparse, "points3D.bin")
    cols = C.read_points3d_bin_columnar(path)
    blob = scene_io.write_points3d(cols["pid"], cols["xyz"], cols["rgb"], cols["err"],
                                   cols["track_offsets"], cols["track_image_ids"],
                                   cols["track_p2d"])
    back = scene_io.parse_points3d(blob)
    for k in cols:
        np.testing.assert_array_equal(back[k], cols[k], err_msg=k)


LOAD = """
import sys
from pathlib import Path
import tpugs_torch.native as native
native.BUILD_DIR = Path(sys.argv[1])
print("loaded", native.load() is not None, native.library_path().name)
"""


def test_processes_started_at_once_all_load_the_library(model_dir, tmp_path):
    """Four processes, an empty build directory: one builds under the
    lock, the others wait and load the same file; no temporary is left."""
    build = tmp_path / "build"
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    procs = [subprocess.Popen([sys.executable, "-c", LOAD, str(build)], cwd=REPO, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for _ in range(4)]
    outs = [p.communicate(timeout=240) for p in procs]
    assert [p.returncode for p in procs] == [0] * 4, [err for _, err in outs]
    names = {out.split()[-1] for out, _ in outs}
    assert all(out.startswith("loaded True") for out, _ in outs), outs
    assert len(names) == 1
    assert sorted(p.name for p in build.iterdir()) == sorted([names.pop(), "scene_io.lock"])

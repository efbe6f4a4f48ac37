"""COLMAP sparse-model reader/writer (binary + text), pure numpy.
Counterpart: ``tpugs/io/colmap.py``, with the same records, readers,
writers and ``SceneManager``. Implements the COLMAP sparse format:

  cameras.bin / cameras.txt    — intrinsics per physical camera
  images.bin  / images.txt     — registered image poses (qvec wxyz, tvec)
  points3D.bin / points3D.txt  — sparse points + tracks

The ``SceneManager`` facade mirrors the pycolmap_scene_manager surface
(``load_cameras()``, ``.images`` dict of objects with ``.R()``, ``.t``,
``.name``) so higher layers read identically.

``images.bin`` and ``points3D.bin`` are parsed by the port's native C++
reader (``tpugs_torch/native``) where it builds; the pure-Python readers
``read_images_bin_plain`` and ``read_points3d_bin_plain`` are its twins and
take over where it does not.
"""

from __future__ import annotations

import dataclasses
import os
import struct
from typing import Dict, Optional

import numpy as np

# model_id -> (name, num_params). Params orders follow COLMAP docs.
CAMERA_MODELS = {
    0: ("SIMPLE_PINHOLE", 3),  # f, cx, cy
    1: ("PINHOLE", 4),  # fx, fy, cx, cy
    2: ("SIMPLE_RADIAL", 4),  # f, cx, cy, k1
    3: ("RADIAL", 5),  # f, cx, cy, k1, k2
    4: ("OPENCV", 8),  # fx, fy, cx, cy, k1, k2, p1, p2
    5: ("OPENCV_FISHEYE", 8),
    6: ("FULL_OPENCV", 12),
    7: ("FOV", 5),
    8: ("SIMPLE_RADIAL_FISHEYE", 4),
    9: ("RADIAL_FISHEYE", 5),
    10: ("THIN_PRISM_FISHEYE", 12),
}
MODEL_NAME_TO_ID = {name: mid for mid, (name, _) in CAMERA_MODELS.items()}


@dataclasses.dataclass
class ColmapCamera:
    camera_id: int
    model: str
    width: int
    height: int
    params: np.ndarray

    @property
    def fx(self) -> float:
        return float(self.params[0])

    @property
    def fy(self) -> float:
        if self.model in ("SIMPLE_PINHOLE", "SIMPLE_RADIAL", "RADIAL",
                          "SIMPLE_RADIAL_FISHEYE", "RADIAL_FISHEYE", "FOV"):
            return float(self.params[0])
        return float(self.params[1])

    @property
    def cx(self) -> float:
        if self.model in ("SIMPLE_PINHOLE", "SIMPLE_RADIAL", "RADIAL",
                          "SIMPLE_RADIAL_FISHEYE", "RADIAL_FISHEYE", "FOV"):
            return float(self.params[1])
        return float(self.params[2])

    @property
    def cy(self) -> float:
        if self.model in ("SIMPLE_PINHOLE", "SIMPLE_RADIAL", "RADIAL",
                          "SIMPLE_RADIAL_FISHEYE", "RADIAL_FISHEYE", "FOV"):
            return float(self.params[2])
        return float(self.params[3])

    @property
    def K(self) -> np.ndarray:
        return np.array(
            [[self.fx, 0, self.cx], [0, self.fy, self.cy], [0, 0, 1]],
            dtype=np.float64,
        )

    @property
    def is_fisheye(self) -> bool:
        """True for COLMAP's equidistant-projection (theta-polynomial)
        models, which need cv2.fisheye.* undistortion — feeding their
        coefficients to the plain (Brown-Conrady) cv2 path silently
        produces wrongly-undistorted images."""
        return self.model in (
            "OPENCV_FISHEYE", "SIMPLE_RADIAL_FISHEYE", "RADIAL_FISHEYE"
        )

    def distortion_params(self) -> np.ndarray:
        """Distortion coefficients in cv2 layout: (k1, k2, p1, p2) for
        perspective models, (k1, k2, k3, k4) theta-polynomial terms for
        fisheye models (consume via ``is_fisheye``)."""
        m = self.model
        if m in ("SIMPLE_PINHOLE", "PINHOLE"):
            return np.zeros(4)
        if m in ("SIMPLE_RADIAL", "SIMPLE_RADIAL_FISHEYE"):
            return np.array([self.params[3], 0, 0, 0])
        if m in ("RADIAL", "RADIAL_FISHEYE"):
            return np.array([self.params[3], self.params[4], 0, 0])
        if m in ("OPENCV", "OPENCV_FISHEYE"):
            return np.asarray(self.params[4:8])
        raise NotImplementedError(f"distortion for model {m}")


def qvec_to_rotmat(qvec: np.ndarray) -> np.ndarray:
    """COLMAP wxyz quaternion -> rotation matrix."""
    w, x, y, z = qvec
    return np.array(
        [
            [
                1 - 2 * (y * y + z * z),
                2 * (x * y - w * z),
                2 * (x * z + w * y),
            ],
            [
                2 * (x * y + w * z),
                1 - 2 * (x * x + z * z),
                2 * (y * z - w * x),
            ],
            [
                2 * (x * z - w * y),
                2 * (y * z + w * x),
                1 - 2 * (x * x + y * y),
            ],
        ]
    )


def rotmat_to_qvec(R: np.ndarray) -> np.ndarray:
    """Rotation matrix -> wxyz quaternion (Shepperd's method)."""
    K = (
        np.array(
            [
                [R[0, 0] - R[1, 1] - R[2, 2], 0, 0, 0],
                [R[0, 1] + R[1, 0], R[1, 1] - R[0, 0] - R[2, 2], 0, 0],
                [R[0, 2] + R[2, 0], R[1, 2] + R[2, 1], R[2, 2] - R[0, 0] - R[1, 1], 0],
                [R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1],
                 R[0, 0] + R[1, 1] + R[2, 2]],
            ]
        )
        / 3.0
    )
    eigvals, eigvecs = np.linalg.eigh(K)
    qvec = eigvecs[[3, 0, 1, 2], np.argmax(eigvals)]
    if qvec[0] < 0:
        qvec *= -1
    return qvec


@dataclasses.dataclass
class ColmapImage:
    image_id: int
    qvec: np.ndarray  # (4,) wxyz
    tvec: np.ndarray  # (3,)
    camera_id: int
    name: str
    xys: np.ndarray  # (M, 2)
    point3D_ids: np.ndarray  # (M,) int64, -1 if unmatched

    def R(self) -> np.ndarray:
        return qvec_to_rotmat(self.qvec)

    @property
    def t(self) -> np.ndarray:
        return self.tvec


@dataclasses.dataclass
class ColmapPoint3D:
    point3D_id: int
    xyz: np.ndarray
    rgb: np.ndarray
    error: float
    image_ids: np.ndarray
    point2D_idxs: np.ndarray


def _read(fh, fmt):
    size = struct.calcsize(fmt)
    return struct.unpack(fmt, fh.read(size))


def read_cameras_bin(path: str) -> Dict[int, ColmapCamera]:
    cameras = {}
    with open(path, "rb") as fh:
        (n,) = _read(fh, "<Q")
        for _ in range(n):
            cam_id, model_id, width, height = _read(fh, "<iiQQ")
            name, n_params = CAMERA_MODELS[model_id]
            params = np.array(_read(fh, f"<{n_params}d"))
            cameras[cam_id] = ColmapCamera(cam_id, name, width, height, params)
    return cameras


def read_images_bin(path: str) -> Dict[int, ColmapImage]:
    native = _read_images_bin_native(path)
    if native is not None:
        return native
    return read_images_bin_plain(path)


def read_images_bin_plain(path: str) -> Dict[int, ColmapImage]:
    """The pure-Python images.bin reader (the native parser's twin)."""
    images = {}
    with open(path, "rb") as fh:
        (n,) = _read(fh, "<Q")
        for _ in range(n):
            image_id, qw, qx, qy, qz, tx, ty, tz, cam_id = _read(fh, "<idddddddi")
            name = b""
            while True:
                c = fh.read(1)
                if c == b"\x00":
                    break
                name += c
            (m,) = _read(fh, "<Q")
            data = np.frombuffer(
                fh.read(24 * m), dtype=np.dtype([("xy", "<2f8"), ("id", "<i8")])
            )
            images[image_id] = ColmapImage(
                image_id,
                np.array([qw, qx, qy, qz]),
                np.array([tx, ty, tz]),
                cam_id,
                name.decode("utf-8"),
                data["xy"].copy(),
                data["id"].copy(),
            )
    return images


def _read_images_bin_native(path: str) -> Optional[Dict[int, ColmapImage]]:
    """C++ fast path (tpugs_torch/native); None if the library is absent.
    A parse error (ValueError) falls back to the pure reader too — the
    file may still be readable there — but with a visible warning so a
    native-parser bug can't hide behind the silent fallback."""
    from tpugs_torch.native import scene_io as _nat

    with open(path, "rb") as fh:
        data = fh.read()
    try:
        cols = _nat.parse_images(data)
    except ValueError as e:
        import warnings

        warnings.warn(f"native images.bin parse failed ({e}); "
                      "falling back to the pure-Python reader")
        return None
    if cols is None:
        return None
    images = {}
    off = cols["obs_offsets"]
    for i, iid in enumerate(cols["image_id"]):
        lo, hi = int(off[i]), int(off[i + 1])
        images[int(iid)] = ColmapImage(
            int(iid),
            cols["qvec"][i],
            cols["tvec"][i],
            int(cols["camera_id"][i]),
            cols["names"][i],
            cols["xys"][lo:hi],
            cols["p3d_ids"][lo:hi],
        )
    return images


def read_points3d_bin_columnar(path: str) -> Optional[Dict[str, np.ndarray]]:
    """C++ columnar parse of points3D.bin (sorted by point id).

    Returns {pid, xyz, rgb, err, track_offsets, track_image_ids,
    track_p2d} or None when the native library is unavailable. At
    SfM scale (millions of points) this skips both the per-record
    Python loop and the per-point object construction.
    """
    from tpugs_torch.native import scene_io as _nat

    with open(path, "rb") as fh:
        data = fh.read()
    try:
        cols = _nat.parse_points3d(data)
    except ValueError as e:
        import warnings

        warnings.warn(f"native points3D.bin parse failed ({e}); "
                      "falling back to the pure-Python reader")
        return None
    if cols is None:
        return None
    order = np.argsort(cols["pid"], kind="stable")
    if not np.array_equal(order, np.arange(len(order))):
        # Re-sort columns (and the ragged track arrays) by point id so
        # downstream index maps are deterministic.
        counts = np.diff(cols["track_offsets"])[order]
        new_offsets = np.concatenate([[0], np.cumsum(counts)])
        gather = np.concatenate(
            [
                np.arange(cols["track_offsets"][i],
                          cols["track_offsets"][i + 1])
                for i in order
            ]
        ) if len(order) else np.zeros(0, np.int64)
        cols = {
            "pid": cols["pid"][order],
            "xyz": cols["xyz"][order],
            "rgb": cols["rgb"][order],
            "err": cols["err"][order],
            "track_offsets": new_offsets,
            "track_image_ids": cols["track_image_ids"][gather],
            "track_p2d": cols["track_p2d"][gather],
        }
    return cols


def _columnar_to_points(cols: Dict[str, np.ndarray]) -> Dict[int, ColmapPoint3D]:
    points = {}
    off = cols["track_offsets"]
    for i, pid in enumerate(cols["pid"]):
        lo, hi = int(off[i]), int(off[i + 1])
        points[int(pid)] = ColmapPoint3D(
            int(pid),
            cols["xyz"][i],
            cols["rgb"][i],
            float(cols["err"][i]),
            cols["track_image_ids"][lo:hi],
            cols["track_p2d"][lo:hi],
        )
    return points


def read_points3d_bin(path: str) -> Dict[int, ColmapPoint3D]:
    cols = read_points3d_bin_columnar(path)
    if cols is not None:
        return _columnar_to_points(cols)
    return read_points3d_bin_plain(path)


def read_points3d_bin_plain(path: str) -> Dict[int, ColmapPoint3D]:
    """The pure-Python points3D.bin reader (the native parser's twin)."""
    points = {}
    with open(path, "rb") as fh:
        (n,) = _read(fh, "<Q")
        for _ in range(n):
            pid, x, y, z, r, g, b, err = _read(fh, "<QdddBBBd")
            (track_len,) = _read(fh, "<Q")
            track = np.frombuffer(fh.read(8 * track_len), dtype="<i4").reshape(-1, 2)
            points[pid] = ColmapPoint3D(
                pid,
                np.array([x, y, z]),
                np.array([r, g, b], np.uint8),
                err,
                track[:, 0].copy(),
                track[:, 1].copy(),
            )
    return points


def read_cameras_txt(path: str) -> Dict[int, ColmapCamera]:
    cameras = {}
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            cam_id = int(parts[0])
            model = parts[1]
            width, height = int(parts[2]), int(parts[3])
            params = np.array([float(p) for p in parts[4:]])
            cameras[cam_id] = ColmapCamera(cam_id, model, width, height, params)
    return cameras


def read_images_txt(path: str) -> Dict[int, ColmapImage]:
    images = {}
    with open(path) as fh:
        lines = [
            ln.strip()
            for ln in fh
            if ln.strip() and not ln.strip().startswith("#")
        ]
    for i in range(0, len(lines), 2):
        parts = lines[i].split()
        image_id = int(parts[0])
        qvec = np.array([float(p) for p in parts[1:5]])
        tvec = np.array([float(p) for p in parts[5:8]])
        cam_id = int(parts[8])
        name = parts[9]
        pts = lines[i + 1].split() if i + 1 < len(lines) else []
        xys = np.array(
            [[float(pts[j]), float(pts[j + 1])] for j in range(0, len(pts), 3)]
        ).reshape(-1, 2)
        ids = np.array([int(pts[j + 2]) for j in range(0, len(pts), 3)], np.int64)
        images[image_id] = ColmapImage(image_id, qvec, tvec, cam_id, name, xys, ids)
    return images


def read_points3d_txt(path: str) -> Dict[int, ColmapPoint3D]:
    points = {}
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            p = line.split()
            pid = int(p[0])
            xyz = np.array([float(x) for x in p[1:4]])
            rgb = np.array([int(x) for x in p[4:7]], np.uint8)
            err = float(p[7])
            track = np.array([int(x) for x in p[8:]], np.int64).reshape(-1, 2)
            points[pid] = ColmapPoint3D(
                pid, xyz, rgb, err, track[:, 0], track[:, 1]
            )
    return points


# ---------------------------------------------------------------- writers


def write_cameras_bin(cameras: Dict[int, ColmapCamera], path: str) -> None:
    with open(path, "wb") as fh:
        fh.write(struct.pack("<Q", len(cameras)))
        for cam in cameras.values():
            mid = MODEL_NAME_TO_ID[cam.model]
            fh.write(
                struct.pack("<iiQQ", cam.camera_id, mid, cam.width, cam.height)
            )
            fh.write(struct.pack(f"<{len(cam.params)}d", *cam.params))


def write_images_bin(images: Dict[int, ColmapImage], path: str) -> None:
    with open(path, "wb") as fh:
        fh.write(struct.pack("<Q", len(images)))
        for im in images.values():
            fh.write(
                struct.pack(
                    "<idddddddi",
                    im.image_id,
                    *im.qvec,
                    *im.tvec,
                    im.camera_id,
                )
            )
            fh.write(im.name.encode("utf-8") + b"\x00")
            fh.write(struct.pack("<Q", len(im.xys)))
            for xy, pid in zip(im.xys, im.point3D_ids):
                fh.write(struct.pack("<ddq", xy[0], xy[1], int(pid)))


def write_points3d_bin(points: Dict[int, ColmapPoint3D], path: str) -> None:
    with open(path, "wb") as fh:
        fh.write(struct.pack("<Q", len(points)))
        for pt in points.values():
            fh.write(
                struct.pack(
                    "<QdddBBBd",
                    pt.point3D_id,
                    *pt.xyz,
                    *pt.rgb.astype(np.uint8),
                    pt.error,
                )
            )
            fh.write(struct.pack("<Q", len(pt.image_ids)))
            for iid, pidx in zip(pt.image_ids, pt.point2D_idxs):
                fh.write(struct.pack("<ii", int(iid), int(pidx)))


class SceneManager:
    """pycolmap_scene_manager-compatible facade over a sparse dir."""

    def __init__(self, sparse_dir: str):
        self.sparse_dir = sparse_dir
        self.cameras: Dict[int, ColmapCamera] = {}
        self.images: Dict[int, ColmapImage] = {}
        self._points3D: Optional[Dict[int, ColmapPoint3D]] = {}
        self._pts_cols: Optional[Dict[str, np.ndarray]] = None

    @property
    def points3D(self) -> Dict[int, ColmapPoint3D]:
        """Per-point objects; materialized lazily from the native
        columnar parse so bulk consumers that stay columnar
        (``points_array``/``points_err_array``) never pay for millions
        of Python objects. Handing out the (mutable) dict drops the
        columnar cache so later bulk reads see any in-place edits."""
        if self._points3D is None:
            self._points3D = _columnar_to_points(self._pts_cols)
        self._pts_cols = None
        return self._points3D

    @points3D.setter
    def points3D(self, value: Dict[int, ColmapPoint3D]) -> None:
        self._points3D = value
        self._pts_cols = None

    def _find(self, stem: str) -> Optional[str]:
        for ext in (".bin", ".txt"):
            p = os.path.join(self.sparse_dir, stem + ext)
            if os.path.exists(p):
                return p
        return None

    def load_cameras(self):
        p = self._find("cameras")
        if p is None:
            raise FileNotFoundError(f"cameras.bin/.txt in {self.sparse_dir}")
        self.cameras = (
            read_cameras_bin(p) if p.endswith(".bin") else read_cameras_txt(p)
        )
        return self

    def load_images(self):
        p = self._find("images")
        if p is None:
            raise FileNotFoundError(f"images.bin/.txt in {self.sparse_dir}")
        self.images = (
            read_images_bin(p) if p.endswith(".bin") else read_images_txt(p)
        )
        return self

    def load_points3D(self):
        p = self._find("points3D")
        if p is None:
            raise FileNotFoundError(f"points3D.bin/.txt in {self.sparse_dir}")
        if p.endswith(".bin"):
            cols = read_points3d_bin_columnar(p)
            if cols is not None:
                self._pts_cols = cols
                self._points3D = None  # materialize on demand
                return self
            self.points3D = read_points3d_bin(p)
        else:
            self.points3D = read_points3d_txt(p)
        return self

    def load_all(self):
        return self.load_cameras().load_images().load_points3D()

    def points_array(self):
        """(P, 3) xyz and (P, 3) rgb arrays in id order."""
        if self._pts_cols is not None:
            return self._pts_cols["xyz"], self._pts_cols["rgb"]
        pts = sorted(self.points3D.values(), key=lambda p: p.point3D_id)
        xyz = np.stack([p.xyz for p in pts]) if pts else np.zeros((0, 3))
        rgb = np.stack([p.rgb for p in pts]) if pts else np.zeros((0, 3))
        return xyz, rgb

    def points_err_array(self) -> np.ndarray:
        """(P,) reprojection errors, same id order as points_array."""
        if self._pts_cols is not None:
            return self._pts_cols["err"]
        pts = sorted(self.points3D.values(), key=lambda p: p.point3D_id)
        return (
            np.array([p.error for p in pts]) if pts else np.zeros((0,))
        )

    def point_ids_array(self) -> np.ndarray:
        """(P,) sorted point3D ids, same order as points_array."""
        if self._pts_cols is not None:
            return self._pts_cols["pid"]
        return np.array(sorted(self.points3D), dtype=np.int64)


def write_sparse_model(
    sparse_dir: str,
    cameras: Dict[int, ColmapCamera],
    images: Dict[int, ColmapImage],
    points: Dict[int, ColmapPoint3D],
) -> None:
    os.makedirs(sparse_dir, exist_ok=True)
    write_cameras_bin(cameras, os.path.join(sparse_dir, "cameras.bin"))
    write_images_bin(images, os.path.join(sparse_dir, "images.bin"))
    write_points3d_bin(points, os.path.join(sparse_dir, "points3D.bin"))

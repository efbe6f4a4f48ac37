"""COLMAP training dataset. Counterpart: ``tpugs/train/dataset.py`` (the
reference's ``f3dgs/datasets/colmap.py:27-237, 503-586``), host-side numpy
on the port's COLMAP reader: parser with per-camera intrinsics, undistortion, factor-
suffixed image dirs, 3D points with per-image indices (for the depth
loss), scene normalization and scale; Dataset with train/val split
(``index % test_every``), optional patch cropping, and projected-depth
ground truth. Items are numpy arrays; images are read with ``cv2``
(``io/images.py::read_image``), which is imported where an image is read
or undistorted."""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from tpugs_torch.io.colmap import SceneManager
from tpugs_torch.train.normalize import (
    align_principle_axes,
    similarity_from_cameras,
    transform_cameras,
    transform_points,
)


@dataclass
class Parser:
    data_dir: str
    factor: int = 1
    normalize: bool = False
    test_every: int = 8

    image_names: List[str] = field(default_factory=list)
    image_paths: List[str] = field(default_factory=list)
    camtoworlds: np.ndarray = None  # (C, 4, 4)
    camera_ids: List[int] = field(default_factory=list)
    Ks_dict: Dict[int, np.ndarray] = field(default_factory=dict)
    params_dict: Dict[int, np.ndarray] = field(default_factory=dict)
    imsize_dict: Dict[int, tuple] = field(default_factory=dict)
    points: np.ndarray = None  # (M, 3)
    points_rgb: np.ndarray = None
    points_err: np.ndarray = None
    point_indices: Dict[str, np.ndarray] = field(default_factory=dict)
    transform: np.ndarray = None
    scene_scale: float = 1.0
    mapx_dict: Dict[int, np.ndarray] = field(default_factory=dict)
    mapy_dict: Dict[int, np.ndarray] = field(default_factory=dict)
    roi_undist_dict: Dict[int, tuple] = field(default_factory=dict)

    def __post_init__(self):
        colmap_dir = os.path.join(self.data_dir, "sparse/0")
        if not os.path.exists(colmap_dir):
            colmap_dir = os.path.join(self.data_dir, "sparse")
        manager = SceneManager(colmap_dir).load_all()

        images = sorted(manager.images.values(), key=lambda im: im.name)
        w2c_all = []
        for im in images:
            w2c = np.eye(4)
            w2c[:3, :3] = im.R()
            w2c[:3, 3] = im.t
            w2c_all.append(w2c)
        w2c_all = np.stack(w2c_all)
        camtoworlds = np.linalg.inv(w2c_all)

        self.image_names = [im.name for im in images]
        self.camera_ids = [im.camera_id for im in images]

        # Image directory with downsample-factor suffix (reference
        # ``colmap.py:136-150``).
        image_dir = os.path.join(self.data_dir, "images")
        if self.factor > 1 and os.path.exists(image_dir + f"_{self.factor}"):
            image_dir = image_dir + f"_{self.factor}"
        self.image_paths = [
            os.path.join(image_dir, name) for name in self.image_names
        ]

        for cam_id, cam in manager.cameras.items():
            K = cam.K.copy()
            K[:2, :] /= self.factor
            self.Ks_dict[cam_id] = K.astype(np.float32)
            self.params_dict[cam_id] = cam.distortion_params() if cam.model not in (
                "SIMPLE_PINHOLE", "PINHOLE"
            ) else np.zeros(4)
            self.imsize_dict[cam_id] = (
                int(cam.width // self.factor),
                int(cam.height // self.factor),
            )
            if np.any(self.params_dict[cam_id] != 0):
                self._build_undistort_maps(cam_id, cam.is_fisheye)

        points, points_rgb = manager.points_array()
        points_err = manager.points_err_array()
        # per-image indices into the points array for the depth loss
        # (reference ``colmap.py:153-166``). `sorted_pids` is in the
        # same order as `points`, so a searchsorted gives the index map
        # without a Python dict over millions of ids.
        sorted_pids = np.asarray(manager.point_ids_array(), np.int64)
        point_indices: Dict[str, List[int]] = {}
        for im in images:
            pids = np.asarray(im.point3D_ids, np.int64)
            pids = pids[pids >= 0]
            pos = np.searchsorted(sorted_pids, pids)
            valid = (pos < len(sorted_pids)) & (
                sorted_pids[np.minimum(pos, len(sorted_pids) - 1)] == pids
            )
            point_indices[im.name] = pos[valid].astype(np.int64)

        if self.normalize and len(points):
            T1 = similarity_from_cameras(camtoworlds)
            camtoworlds = transform_cameras(T1, camtoworlds)
            points = transform_points(T1, points)
            T2 = align_principle_axes(points)
            camtoworlds = transform_cameras(T2, camtoworlds)
            points = transform_points(T2, points)
            self.transform = T2 @ T1
        else:
            self.transform = np.eye(4)

        self.camtoworlds = camtoworlds
        self.points = points.astype(np.float32)
        self.points_rgb = np.asarray(points_rgb, np.float32) / 255.0
        self.points_err = points_err
        self.point_indices = point_indices

        # Scene scale: max camera distance from center (reference
        # ``colmap.py:233-237``).
        camera_locs = camtoworlds[:, :3, 3]
        scene_center = np.mean(camera_locs, axis=0)
        dists = np.linalg.norm(camera_locs - scene_center, axis=1)
        self.scene_scale = float(np.max(dists)) if len(dists) else 1.0

    @property
    def num_images(self) -> int:
        return len(self.image_names)

    def viewmat(self, idx: int) -> np.ndarray:
        return np.linalg.inv(self.camtoworlds[idx]).astype(np.float32)

    def _build_undistort_maps(self, cam_id: int, fisheye: bool):
        """Precompute the undistortion remap grid for one camera
        (reference builds these once at parse time,
        ``f3dgs/datasets/colmap.py:209-231``).

        Perspective (Brown-Conrady) models go through
        getOptimalNewCameraMatrix(alpha=0) + initUndistortRectifyMap +
        ROI crop. Fisheye (equidistant theta-polynomial) models go
        through the cv2.fisheye pair — the reference asserts these out
        entirely (``colmap.py:100-103``), and its plain-cv2 path would
        mis-undistort them. One deliberate deviation: after the ROI
        crop the principal point is shifted by the ROI offset (the
        reference keeps the uncropped K — geometrically off by the crop
        origin). Ks_dict/imsize_dict are updated to the undistorted
        camera so every consumer (renderer, depth loss) sees the
        rectified pinhole model."""
        import cv2

        K = self.Ks_dict[cam_id].astype(np.float64)
        params = np.asarray(self.params_dict[cam_id], np.float64)
        w, h = self.imsize_dict[cam_id]
        if fisheye:
            D = params[:4].reshape(-1, 1)
            newK = cv2.fisheye.estimateNewCameraMatrixForUndistortRectify(
                K, D, (w, h), np.eye(3), balance=0.0
            )
            mapx, mapy = cv2.fisheye.initUndistortRectifyMap(
                K, D, np.eye(3), newK, (w, h), cv2.CV_32FC1
            )
            roi = (0, 0, w, h)
        else:
            newK, roi = cv2.getOptimalNewCameraMatrix(K, params, (w, h), 0)
            mapx, mapy = cv2.initUndistortRectifyMap(
                K, params, None, newK, (w, h), cv2.CV_32FC1
            )
        x, y, rw, rh = roi
        newK = np.asarray(newK, np.float64).copy()
        newK[0, 2] -= x
        newK[1, 2] -= y
        self.Ks_dict[cam_id] = newK.astype(np.float32)
        self.imsize_dict[cam_id] = (int(rw), int(rh))
        self.mapx_dict[cam_id] = mapx
        self.mapy_dict[cam_id] = mapy
        self.roi_undist_dict[cam_id] = (int(x), int(y), int(rw), int(rh))

    def load_image(self, idx: int) -> np.ndarray:
        """(H, W, 3) float image in [0, 1]; undistorts non-pinhole
        models via the precomputed remap grids."""
        from tpugs_torch.io.images import read_image

        img = read_image(self.image_paths[idx])[..., :3]
        cam_id = self.camera_ids[idx]
        if cam_id in self.mapx_dict:
            import cv2

            mapx, mapy = self.mapx_dict[cam_id], self.mapy_dict[cam_id]
            # The maps were built at the factor-scaled intrinsics; bring
            # the image to that scale first if the on-disk resolution
            # differs (no images_{factor}/ directory).
            mh, mw = mapx.shape[:2]
            if img.shape[1] != mw or img.shape[0] != mh:
                img = cv2.resize(img, (mw, mh))
            img = cv2.remap(img, mapx, mapy, cv2.INTER_LINEAR)
            x, y, rw, rh = self.roi_undist_dict[cam_id]
            img = img[y : y + rh, x : x + rw]
        w, h = self.imsize_dict[cam_id]
        if img.shape[1] != w or img.shape[0] != h:
            import cv2

            img = cv2.resize(img, (w, h))
        return img.astype(np.float32) / 255.0


class Dataset:
    """Train/val split over a Parser (reference ``colmap.py:503-586``)."""

    def __init__(
        self,
        parser: Parser,
        split: str = "train",
        patch_size: Optional[int] = None,
        load_depths: bool = False,
        crop_to_common: bool = True,
    ):
        self.parser = parser
        self.split = split
        self.patch_size = patch_size
        self.load_depths = load_depths
        indices = np.arange(parser.num_images)
        if split == "train":
            self.indices = indices[indices % parser.test_every != 0]
        else:
            self.indices = indices[indices % parser.test_every == 0]
        # Heterogeneous rigs: per-camera undistortion yields per-camera
        # sizes (reference torch path renders dynamic shapes,
        # colmap.py:209-231); the trainer renders ONE (H, W) (tpugs
        # compiles it statically), so center-crop every camera to the common minimum and
        # shift its principal point accordingly. Single-camera datasets
        # are untouched (their min IS their size).
        self.common_size = None
        sizes = {parser.imsize_dict[c] for c in parser.imsize_dict}
        if crop_to_common and len(sizes) > 1:
            self.common_size = (
                min(s[0] for s in sizes), min(s[1] for s in sizes)
            )

    def __len__(self) -> int:
        return len(self.indices)

    def __getitem__(self, item: int) -> dict:
        idx = int(self.indices[item])
        image = self.parser.load_image(idx)
        cam_id = self.parser.camera_ids[idx]
        K = self.parser.Ks_dict[cam_id].copy()
        viewmat = self.parser.viewmat(idx)

        if self.common_size is not None:
            cw, ch = self.common_size
            h, w = image.shape[:2]
            x0, y0 = (w - cw) // 2, (h - ch) // 2
            image = image[y0 : y0 + ch, x0 : x0 + cw]
            K[0, 2] -= x0
            K[1, 2] -= y0

        if self.patch_size is not None:
            h, w = image.shape[:2]
            rng = np.random.default_rng(item)
            x = rng.integers(0, max(w - self.patch_size, 1))
            y = rng.integers(0, max(h - self.patch_size, 1))
            image = image[y : y + self.patch_size, x : x + self.patch_size]
            K[0, 2] -= x
            K[1, 2] -= y

        data = {
            "K": K,
            "viewmat": viewmat,
            "image": image,
            "image_id": idx,
            "image_name": self.parser.image_names[idx],
        }
        if self.load_depths:
            name = self.parser.image_names[idx]
            pidx = self.parser.point_indices.get(name, np.zeros(0, np.int64))
            pts = self.parser.points[pidx]
            cam = (pts @ viewmat[:3, :3].T) + viewmat[:3, 3]
            uv = cam @ K.T
            uvz = uv[:, :2] / np.maximum(uv[:, 2:3], 1e-8)
            h, w = image.shape[:2]
            keep = (
                (cam[:, 2] > 0)
                & (uvz[:, 0] >= 0)
                & (uvz[:, 0] < w)
                & (uvz[:, 1] >= 0)
                & (uvz[:, 1] < h)
            )
            data["points"] = uvz[keep].astype(np.float32)
            data["depths"] = cam[keep, 2].astype(np.float32)
        return data

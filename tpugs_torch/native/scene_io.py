"""numpy-facing wrappers over the C++ COLMAP parser (scene_io.cc).
Counterpart: ``tpugs/native/scene_io.py``.

Each function takes the raw file bytes and returns flat columnar
arrays — no per-record Python objects, so a 5M-point points3D.bin
parses at memory speed instead of the pure-Python reader's
per-record struct loop (``io/colmap.py::read_points3d_bin_plain``).
Callers fall back to the pure reader when ``native.available()`` is
False.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional

import numpy as np

from . import load

_u8p = ctypes.POINTER(ctypes.c_uint8)


def _buf(data: bytes):
    """Zero-copy view of the immutable bytes (the C side only reads)."""
    return ctypes.cast(ctypes.c_char_p(data), _u8p)


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


def parse_points3d(data: bytes) -> Optional[Dict[str, np.ndarray]]:
    """points3D.bin bytes -> columnar dict, or None if unavailable.

    Keys: pid (P,), xyz (P,3) f64, rgb (P,3) u8, err (P,),
    track_offsets (P+1,), track_image_ids / track_p2d (T,) i32.
    """
    lib = load()
    if lib is None:
        return None
    buf = _buf(data)
    n = ctypes.c_uint64()
    total = ctypes.c_uint64()
    if lib.colmap_points3d_count(buf, len(data),
                                 ctypes.byref(n), ctypes.byref(total)) != 0:
        raise ValueError("corrupt points3D.bin")
    P, T = n.value, total.value
    out = {
        "pid": np.empty(P, np.int64),
        "xyz": np.empty((P, 3), np.float64),
        "rgb": np.empty((P, 3), np.uint8),
        "err": np.empty(P, np.float64),
        "track_offsets": np.empty(P + 1, np.int64),
        "track_image_ids": np.empty(T, np.int32),
        "track_p2d": np.empty(T, np.int32),
    }
    rc = lib.colmap_points3d_parse(
        buf, len(data), _ptr(out["pid"]), _ptr(out["xyz"]),
        _ptr(out["rgb"]), _ptr(out["err"]), _ptr(out["track_offsets"]),
        _ptr(out["track_image_ids"]), _ptr(out["track_p2d"]))
    if rc != 0:
        raise ValueError("corrupt points3D.bin")
    return out


def parse_images(data: bytes) -> Optional[Dict[str, np.ndarray]]:
    """images.bin bytes -> columnar dict, or None if unavailable.

    Keys: image_id (I,) i32, qvec (I,4), tvec (I,3), camera_id (I,),
    names (list of str), obs_offsets (I+1,), xys (M,2), p3d_ids (M,).
    """
    lib = load()
    if lib is None:
        return None
    buf = _buf(data)
    n = ctypes.c_uint64()
    obs = ctypes.c_uint64()
    nb = ctypes.c_uint64()
    if lib.colmap_images_count(buf, len(data), ctypes.byref(n),
                               ctypes.byref(obs), ctypes.byref(nb)) != 0:
        raise ValueError("corrupt images.bin")
    I, M, NB = n.value, obs.value, nb.value
    image_id = np.empty(I, np.int32)
    qvec = np.empty((I, 4), np.float64)
    tvec = np.empty((I, 3), np.float64)
    camera_id = np.empty(I, np.int32)
    names_raw = ctypes.create_string_buffer(max(NB, 1))
    name_offsets = np.empty(I + 1, np.int64)
    obs_offsets = np.empty(I + 1, np.int64)
    xys = np.empty((M, 2), np.float64)
    p3d_ids = np.empty(M, np.int64)
    rc = lib.colmap_images_parse(
        buf, len(data), _ptr(image_id), _ptr(qvec), _ptr(tvec),
        _ptr(camera_id), names_raw, _ptr(name_offsets), _ptr(obs_offsets),
        _ptr(xys), _ptr(p3d_ids))
    if rc != 0:
        raise ValueError("corrupt images.bin")
    blob = names_raw.raw
    names = [
        blob[name_offsets[i]:name_offsets[i + 1]].decode("utf-8")
        for i in range(I)
    ]
    return {
        "image_id": image_id, "qvec": qvec, "tvec": tvec,
        "camera_id": camera_id, "names": names,
        "obs_offsets": obs_offsets, "xys": xys, "p3d_ids": p3d_ids,
    }


def write_points3d(pid, xyz, rgb, err, track_offsets,
                   track_image_ids, track_p2d) -> Optional[bytes]:
    """Columnar arrays -> points3D.bin bytes, or None if unavailable."""
    lib = load()
    if lib is None:
        return None
    pid = np.ascontiguousarray(pid, np.int64)
    xyz = np.ascontiguousarray(xyz, np.float64)
    rgb = np.ascontiguousarray(rgb, np.uint8)
    err = np.ascontiguousarray(err, np.float64)
    track_offsets = np.ascontiguousarray(track_offsets, np.int64)
    track_image_ids = np.ascontiguousarray(track_image_ids, np.int32)
    track_p2d = np.ascontiguousarray(track_p2d, np.int32)
    n = pid.shape[0]
    size = lib.colmap_points3d_size(n, track_image_ids.shape[0])
    out = np.empty(size, np.uint8)
    rc = lib.colmap_points3d_write(
        ctypes.c_uint64(n), _ptr(pid), _ptr(xyz), _ptr(rgb), _ptr(err),
        _ptr(track_offsets), _ptr(track_image_ids), _ptr(track_p2d),
        _ptr(out))
    if rc != 0:
        raise ValueError("write failed")
    return out.tobytes()

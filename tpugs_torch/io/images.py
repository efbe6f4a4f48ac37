"""Image reads with ``cv2``. No counterpart module in ``tpugs``, which
reads with ``imageio.v2.imread`` at each site (``train/dataset.py``,
``query/affordance.py``, ``apps/affordance.py``).

``read_image`` returns what ``imageio.v2.imread`` returns for the files
the port reads: 8-bit RGB JPEG and PNG as (H, W, 3), RGBA PNG as
(H, W, 4), grayscale JPEG and PNG as (H, W), all uint8. Where ``cv2``
decodes a PNG differently, the result is brought to imageio's: a palette
PNG is RGB even with a tRNS chunk (``cv2`` gives BGRA there), gray with
alpha is (H, W, 2) (``cv2`` expands it to BGRA), and a 1-bit grayscale
PNG is bool (``cv2`` gives 0/255). EXIF orientation is not applied, as
imageio does not apply it either. There is no fallback: without ``cv2``
the read raises ImportError.
"""

from __future__ import annotations

import os
from typing import Union

import numpy as np

_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# PNG colour types (IHDR byte 25)
_GRAY, _PALETTE, _GRAY_ALPHA = 0, 3, 4


def read_image(path_or_bytes: Union[str, os.PathLike, bytes, bytearray, memoryview]
               ) -> np.ndarray:
    """The decoded image of a file path or of the file's bytes."""
    try:
        import cv2
    except ImportError as e:
        raise ImportError("read_image needs cv2 (opencv-python) to decode images") from e

    if isinstance(path_or_bytes, (bytes, bytearray, memoryview)):
        data = bytes(path_or_bytes)
        name = "<bytes>"
    else:
        name = os.fspath(path_or_bytes)
        with open(name, "rb") as fh:
            data = fh.read()
    img = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_UNCHANGED)
    if img is None:
        raise ValueError(f"cv2 cannot decode the image {name}")
    if img.ndim == 3:
        img = img[..., [2, 1, 0, 3]] if img.shape[2] == 4 else img[..., ::-1]
    if data.startswith(_PNG_SIGNATURE) and len(data) >= 26:
        bit_depth, color_type = data[24], data[25]
        if color_type == _PALETTE:
            img = img[..., :3]
        elif color_type == _GRAY_ALPHA:
            img = img[..., [0, 3]]
        elif color_type == _GRAY and bit_depth == 1:
            img = img > 0
    return np.ascontiguousarray(img)

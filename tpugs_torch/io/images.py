"""Image reads and writes with ``cv2``, and the GIF writer. No counterpart
module in ``tpugs``, which reads and writes with ``imageio`` at each site
(``train/dataset.py``, ``query/affordance.py``, ``apps/affordance.py``,
``viz/gif.py``, ``io/compression.py``, ``train/viewer.py``).

``read_image`` returns what ``imageio.v2.imread`` returns for the files
the port reads: 8-bit RGB JPEG and PNG as (H, W, 3), RGBA PNG as
(H, W, 4), grayscale JPEG and PNG as (H, W), all uint8, and 16-bit
grayscale PNG as (H, W) uint16. Where ``cv2`` decodes a PNG differently,
the result is brought to imageio's: a palette PNG is RGB even with a
tRNS chunk (``cv2`` gives BGRA there), gray with alpha is (H, W, 2)
(``cv2`` expands it to BGRA), and a 1-bit grayscale PNG is bool (``cv2``
gives 0/255). EXIF orientation is not applied, as imageio does not apply
it either.

``encode_png`` / ``write_png`` write uint8 images of 1, 3 or 4 channels
(2 are padded to 3 with zeros) and uint16 images of 1 channel through
``cv2.imencode`` at ``PNG_COMPRESSION``: zlib level 6, Pillow's default,
which tpugs' imageio writes use (cv2's default, 1, favours speed). The
compressed scene of ``tests/test_torch_io.py`` (40 Gaussians) then takes
0.9989 of the bytes of imageio's, and one of 2000 Gaussians 0.9886 (the
level moves neither by more than 0.02%). There is no fallback:
without ``cv2`` a read or a PNG write raises ImportError.

``encode_gif`` / ``write_gif`` are the port's own GIF89a encoder, in
numpy and the standard library: a NETSCAPE2.0 loop block, then per frame
a graphic control extension with the delay in centiseconds, an image
descriptor with a local palette and its LZW-coded indices. A frame with
at most 256 colours keeps them exactly; a frame with more is reduced to
256 by median cut (``gif_palette``). cv2 encodes GIFs too, but its
palette is neither exact at 256 colours nor as close as imageio's above
(CHANGES.md, PR 18).
"""

from __future__ import annotations

import os
import struct
from typing import Sequence, Tuple, Union

import numpy as np

_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# PNG colour types (IHDR byte 25)
_GRAY, _PALETTE, _GRAY_ALPHA = 0, 3, 4
PNG_COMPRESSION = 6  # zlib level of cv2.imencode's PNGs


def _cv2(what: str):
    try:
        import cv2
    except ImportError as e:
        raise ImportError(f"{what} needs cv2 (opencv-python)") from e
    return cv2


def read_image(path_or_bytes: Union[str, os.PathLike, bytes, bytearray, memoryview]
               ) -> np.ndarray:
    """The decoded image of a file path or of the file's bytes."""
    cv2 = _cv2("read_image")
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


def encode_png(image: np.ndarray) -> bytes:
    """The PNG file of ``image``: uint8 (H, W), (H, W, 1), (H, W, 3) RGB or
    (H, W, 4) RGBA, (H, W, 2) padded to RGB with a zero channel, or uint16
    (H, W) / (H, W, 1)."""
    cv2 = _cv2("encode_png")
    a = np.asarray(image)
    if a.ndim == 3 and a.shape[2] == 1:
        a = a[..., 0]
    if a.dtype == np.uint16:
        if a.ndim != 2:
            raise ValueError(f"a 16-bit PNG has one channel, got shape {a.shape}")
    elif a.dtype != np.uint8:
        raise ValueError(f"PNG writes uint8 or uint16, got {a.dtype}")
    elif a.ndim == 3 and a.shape[2] == 2:
        a = np.concatenate([a, np.zeros_like(a[..., :1])], axis=-1)
    if a.ndim == 3:
        if a.shape[2] not in (3, 4):
            raise ValueError(f"PNG writes 1 to 4 channels, got shape {a.shape}")
        a = a[..., [2, 1, 0, 3]] if a.shape[2] == 4 else a[..., ::-1]
    elif a.ndim != 2:
        raise ValueError(f"an image is (H, W) or (H, W, C), got shape {a.shape}")
    ok, buf = cv2.imencode(".png", np.ascontiguousarray(a),
                           [cv2.IMWRITE_PNG_COMPRESSION, PNG_COMPRESSION])
    if not ok:
        raise ValueError(f"cv2 cannot encode a PNG of shape {a.shape} and {a.dtype}")
    return buf.tobytes()


def write_png(path: Union[str, os.PathLike], image: np.ndarray) -> None:
    """``encode_png(image)`` written to ``path``."""
    data = encode_png(image)
    with open(path, "wb") as fh:
        fh.write(data)


# ------------------------------------------------------------------ GIF

_GIF_COLOURS = 256
_LZW_MAX_CODE = 4095


def _median_cut(colours: np.ndarray, counts: np.ndarray, k: int) -> np.ndarray:
    """The box (0..k-1) of each of ``colours`` (U, 3) int64, whose pixel
    counts are ``counts`` (U > k): the box of largest count-weighted squared
    error is cut along its widest channel, between the two distinct values
    nearest its weighted median, until there are ``k`` boxes."""
    w = counts.astype(np.float64)
    boxes = [np.arange(len(colours))]
    errs = [np.inf]  # the first box is cut first, whatever its error
    while len(boxes) < k:
        i = int(np.argmax([e if len(m) > 1 else -1.0 for m, e in zip(boxes, errs)]))
        if len(boxes[i]) < 2:
            break
        members = boxes[i]
        c = colours[members]
        axis = int(np.argmax(c.max(0) - c.min(0)))
        order = members[np.argsort(c[:, axis], kind="stable")]
        v = colours[order, axis]
        steps = np.nonzero(v[1:] != v[:-1])[0]  # cut after these positions
        # prefix sums of the weights, weighted colours and squares: each
        # half's error is sum w c^2 - |sum w c|^2 / sum w
        cw = colours[order].astype(np.float64) * w[order, None]
        n0 = np.cumsum(w[order])
        n1 = np.cumsum(cw, 0)
        n2 = np.cumsum((cw * colours[order]).sum(1))
        cut = int(steps[np.argmin(np.abs(n0[steps] - n0[-1] / 2.0))])
        right = (n0[-1] - n0[cut], n1[-1] - n1[cut], n2[-1] - n2[cut])
        boxes[i], errs[i] = order[: cut + 1], float(n2[cut] - (n1[cut] ** 2).sum() / n0[cut])
        boxes.append(order[cut + 1:])
        errs.append(float(right[2] - (right[1] ** 2).sum() / right[0]))
    box = np.empty(len(colours), np.int64)
    for b, m in enumerate(boxes):
        box[m] = b
    return box


def gif_palette(frame: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(palette (K, 3) uint8, indices (H, W) uint8) of an RGB frame: its own
    colours where it has at most 256 (exact), else 256 median-cut boxes,
    each the count-weighted mean of its colours, rounded."""
    f = np.asarray(frame)
    if f.dtype != np.uint8 or f.ndim != 3 or f.shape[2] != 3:
        raise ValueError(f"a GIF frame is (H, W, 3) uint8, got {f.shape} {f.dtype}")
    keys = (f[..., 0].astype(np.int64) << 16) | (f[..., 1].astype(np.int64) << 8) | f[..., 2]
    uniq, inverse, counts = np.unique(keys.ravel(), return_inverse=True, return_counts=True)
    colours = np.stack([uniq >> 16, (uniq >> 8) & 255, uniq & 255], 1)
    if len(uniq) <= _GIF_COLOURS:
        return colours.astype(np.uint8), inverse.reshape(f.shape[:2]).astype(np.uint8)
    box = _median_cut(colours, counts, _GIF_COLOURS)
    n = np.bincount(box, weights=counts)
    palette = np.stack([np.bincount(box, weights=colours[:, j] * counts) / n
                        for j in range(3)], 1)
    palette = np.clip(np.floor(palette + 0.5), 0, 255).astype(np.uint8)
    return palette, box[inverse].reshape(f.shape[:2]).astype(np.uint8)


def _lzw(indices: bytes, min_size: int) -> bytes:
    """GIF's variable-width LZW of ``indices``, from a clear code to the
    end-of-information code; the table is cleared when it is full."""
    clear, eoi = 1 << min_size, (1 << min_size) + 1
    codes, widths = [clear], [min_size + 1]
    size, nxt, table = min_size + 1, eoi + 1, {}
    prefix = indices[0]
    for b in indices[1:]:
        key = prefix << 8 | b
        hit = table.get(key)
        if hit is not None:
            prefix = hit
            continue
        codes.append(prefix)
        widths.append(size)
        if nxt <= _LZW_MAX_CODE:
            table[key] = nxt
            if nxt == 1 << size and size < 12:
                size += 1
            nxt += 1
        else:
            codes.append(clear)
            widths.append(size)
            size, nxt, table = min_size + 1, eoi + 1, {}
        prefix = b
    codes += [prefix, eoi]
    widths += [size, size]
    codes_a = np.asarray(codes, np.int64)
    widths_a = np.asarray(widths, np.int64)
    start = np.concatenate([[0], np.cumsum(widths_a)[:-1]])
    bits = np.zeros(int(widths_a.sum()), np.uint8)
    for j in range(12):
        m = widths_a > j
        bits[start[m] + j] = (codes_a[m] >> j) & 1
    return np.packbits(bits, bitorder="little").tobytes()


def _sub_blocks(data: bytes) -> bytes:
    out = bytearray()
    for i in range(0, len(data), 255):
        chunk = data[i:i + 255]
        out += bytes([len(chunk)]) + chunk
    return bytes(out) + b"\x00"


def encode_gif(frames: Sequence[np.ndarray], duration_ms: float, loop: int = 0) -> bytes:
    """The animated GIF of ``frames`` (each (H, W, 3) uint8, all of one
    size), each shown ``duration_ms`` (rounded to centiseconds), looping
    ``loop`` times (0: forever)."""
    frames = [np.asarray(f) for f in frames]
    if not frames:
        raise ValueError("a GIF needs at least one frame")
    h, w = frames[0].shape[:2]
    if any(f.shape[:2] != (h, w) for f in frames):
        raise ValueError("every GIF frame must have the first frame's size")
    if not (0 < w < 65536 and 0 < h < 65536):
        raise ValueError(f"a GIF frame is 1 to 65535 pixels a side, got {w} x {h}")
    delay = int(round(duration_ms / 10.0))
    out = bytearray(b"GIF89a" + struct.pack("<HHBBB", w, h, 0, 0, 0))
    out += b"\x21\xff\x0bNETSCAPE2.0\x03\x01" + struct.pack("<H", loop) + b"\x00"
    for f in frames:
        palette, idx = gif_palette(f)
        bits = max(1, int(np.ceil(np.log2(len(palette)))))
        table = np.zeros((1 << bits, 3), np.uint8)
        table[:len(palette)] = palette
        out += b"\x21\xf9\x04" + struct.pack("<BHBB", 1 << 2, delay, 0, 0)
        out += b"\x2c" + struct.pack("<HHHHB", 0, 0, w, h, 0x80 | (bits - 1))
        out += table.tobytes()
        min_size = max(2, bits)
        out += bytes([min_size]) + _sub_blocks(_lzw(idx.tobytes(), min_size))
    out += b"\x3b"
    return bytes(out)


def write_gif(path: Union[str, os.PathLike], frames: Sequence[np.ndarray],
              duration_ms: float, loop: int = 0) -> None:
    """``encode_gif(frames, duration_ms, loop)`` written to ``path``."""
    data = encode_gif(frames, duration_ms, loop)
    with open(path, "wb") as fh:
        fh.write(data)

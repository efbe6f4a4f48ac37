"""The port's image writes (``tpugs_torch/io/images.py``) and colormap,
which must run where ``imageio`` and ``matplotlib`` are missing (the
card's machine has ``cv2`` alone), against what tpugs writes with them.

* PNG: every case the port writes (uint8 gray, one channel, RGB, RGBA,
  two channels padded to RGB, uint16 gray) is written with ``imageio``
  and ``matplotlib`` unimportable, then read back by ``imageio.v2.imread``
  and by ``read_image``, bit-equal to the array; other dtypes and
  channel counts raise.
* GIF: the port's encoder against tpugs' ``save_gif`` (imageio) on the
  frames of tpugs' viz test scene (rendered by the port) and frames of
  few colours: the frame count, 100-ms delays and loop that imageio reads
  from tpugs' GIF; decoded frames equal where a frame has at most 256
  colours, else within 1.25x imageio's own mean error; ``cv2`` decodes
  the same pixels, delays and loop; a frame that fills the LZW table
  (and clears it) and one- and two-colour frames decode exactly.
* ``apply_float_colormap`` / ``apply_depth_colormap`` equal tpugs'
  (matplotlib) on 10^4 values, 0, 1, out-of-range values, infinities and
  NaN, in float64 and float32; an unknown colormap raises ValueError.
* The compressed scene and the viewer's PNG round-trip without
  ``imageio`` and ``matplotlib``.
"""

import contextlib
import sys

import cv2
import imageio
import imageio.v2 as iio
import numpy as np
import pytest
import torch

from tpugs.io import compression as jcomp
from tpugs.train import modules as jmod
from tpugs.utils.synthetic import orbit_cameras, random_scene
from tpugs.viz.gif import save_gif as j_save_gif
from tpugs_torch.convert import SCENE_FIELDS, cameras_from_numpy, scene_from_numpy, scene_to_numpy
from tpugs_torch.io import compression as tcomp
from tpugs_torch.io.images import encode_gif, encode_png, read_image, write_gif, write_png
from tpugs_torch.train import modules as tmod
from tpugs_torch.train.viewer import encode_png as viewer_png
from tpugs_torch.viz.gif import render_to_gif, save_gif


@contextlib.contextmanager
def without_imageio_and_matplotlib():
    with pytest.MonkeyPatch.context() as m:
        for name in ("imageio", "matplotlib"):
            m.setitem(sys.modules, name, None)
        yield


_RNG = np.random.default_rng(0)
PNG_CASES = {
    "gray8": (_RNG.integers(0, 256, (17, 23), dtype=np.uint8), None),
    "one-channel8": (_RNG.integers(0, 256, (17, 23, 1), dtype=np.uint8), "squeeze"),
    "rgb8": (_RNG.integers(0, 256, (17, 23, 3), dtype=np.uint8), None),
    "rgba8": (_RNG.integers(0, 256, (17, 23, 4), dtype=np.uint8), None),
    "two-channel8": (_RNG.integers(0, 256, (17, 23, 2), dtype=np.uint8), "pad"),
    "gray16": (_RNG.integers(0, 65536, (17, 23), dtype=np.uint16), None),
}


@pytest.mark.parametrize("case", sorted(PNG_CASES))
def test_png_reads_back_bit_equal(case, tmp_path):
    a, how = PNG_CASES[case]
    want = a[..., 0] if how == "squeeze" else a
    if how == "pad":
        want = np.concatenate([a, np.zeros_like(a[..., :1])], axis=-1)
    path = tmp_path / f"{case}.png"
    with without_imageio_and_matplotlib():
        write_png(path, a)
        data = encode_png(a)
        ours = read_image(path)
    assert path.read_bytes() == data
    for got in (iio.imread(path), ours):
        assert got.dtype == want.dtype and np.array_equal(got, want), case


@pytest.mark.parametrize("bad", [
    np.zeros((4, 4), np.float32), np.zeros((4, 4, 3), np.uint16), np.zeros((4, 4, 5), np.uint8),
    np.zeros((2, 4, 4, 3), np.uint8)])
def test_png_refuses_what_it_cannot_write(bad):
    with pytest.raises(ValueError):
        encode_png(bad)


@pytest.fixture(scope="module")
def frames():
    """tpugs' viz test scene (``tests/test_viz.py``: 80 Gaussians, 2 orbit
    views at 48x32) rendered by the port, then a noise frame (1536
    colours), a gray ramp (256) and a 4-level frame (64)."""
    js = random_scene(80, seed=0, extent=0.8, scale_range=(0.02, 0.1))
    jc = orbit_cameras(2, 48, 32, radius=2.5)
    ts = scene_from_numpy({k: np.asarray(getattr(js, k)) for k in SCENE_FIELDS}, device="cpu")
    tc = cameras_from_numpy(np.asarray(jc.viewmats), np.asarray(jc.Ks), 48, 32, device="cpu")
    out = render_to_gif(None, ts, tc, save_frames=False)
    rng = np.random.default_rng(1)
    out += [rng.integers(0, 256, (32, 48, 3), dtype=np.uint8),
            np.repeat(rng.permutation(256).astype(np.uint8)[rng.integers(0, 256, (32, 48, 1))],
                      3, 2),
            rng.integers(0, 4, (32, 48, 3), dtype=np.uint8) * 60]
    return out


def _colours(f):
    return len(np.unique(f.reshape(-1, 3), axis=0))


def _meta(path):
    r = imageio.get_reader(path)
    try:
        n = r.get_length()
        return n, r.get_meta_data().get("loop"), [r.get_meta_data(i)["duration"] for i in range(n)]
    finally:
        r.close()


def test_gif_matches_tpugs_gif(frames, tmp_path):
    ref_path, path = str(tmp_path / "tpugs.gif"), str(tmp_path / "port.gif")
    j_save_gif(frames, ref_path)
    with without_imageio_and_matplotlib():
        save_gif(frames, path)  # fps 10: 100 ms
    assert _meta(path) == _meta(ref_path) == (len(frames), 0, [100] * len(frames))
    ours, theirs = iio.mimread(path), iio.mimread(ref_path)
    assert any(_colours(f) > 256 for f in frames) and any(_colours(f) <= 256 for f in frames)
    for f, got, ref in zip(frames, ours, theirs):
        got, ref = got[..., :3].astype(int), ref[..., :3].astype(int)
        if _colours(f) <= 256:
            assert np.array_equal(got, f)
        else:
            assert np.abs(got - f).mean() <= 1.25 * np.abs(ref - f).mean()
    ok, anim = cv2.imreadanimation(path)
    assert ok and anim.loop_count == 0 and list(anim.durations) == [100] * len(frames)
    for got, want in zip(anim.frames, ours):
        assert np.array_equal(got[..., 2::-1], want[..., :3])


@pytest.mark.parametrize("shape, n_colours", [((96, 96), 256), ((5, 7), 1), ((9, 4), 2)])
def test_gif_of_few_colours_decodes_exactly(shape, n_colours, tmp_path):
    """96 x 96 pixels of 256 random colours fill the 4096-entry LZW table
    (the encoder then clears it and goes on); one and two colours take the
    smallest palette and code size."""
    rng = np.random.default_rng(n_colours)
    palette = rng.integers(0, 256, (n_colours, 3), dtype=np.uint8)
    f = palette[rng.integers(0, n_colours, shape)]
    path = str(tmp_path / "few.gif")
    write_gif(path, [f, f[::-1]], duration_ms=40.0, loop=3)
    assert _meta(path) == (2, 3, [40, 40])
    for got, want in zip(iio.mimread(path), [f, f[::-1]]):
        assert np.array_equal(got[..., :3], want)
    ok, anim = cv2.imreadanimation(path)
    assert ok and np.array_equal(anim.frames[0][..., ::-1], f)


def test_gif_refuses_frames_of_other_sizes():
    with pytest.raises(ValueError, match="size"):
        encode_gif([np.zeros((4, 4, 3), np.uint8), np.zeros((4, 5, 3), np.uint8)], 100.0)


def test_colormap_matches_tpugs():
    rng = np.random.default_rng(2)
    special = np.array([0.0, 1.0, -0.5, 1.5, -np.inf, np.inf, np.nan, 255 / 256, 1 / 256,
                        0.5, 1 - 1e-12])
    for x in (np.concatenate([rng.uniform(-0.2, 1.2, 10_000), special]),
              np.concatenate([rng.uniform(0, 1, 10_000), special]).astype(np.float32),
              rng.uniform(0, 1, (30, 40))):
        with without_imageio_and_matplotlib():
            got = tmod.apply_float_colormap(x)
        assert got.dtype == np.uint8 and np.array_equal(got, jmod.apply_float_colormap(x))
    depth = rng.uniform(1, 5, (16, 12))
    depth[3, 4] = np.nan
    acc = rng.uniform(0, 1, depth.shape)
    for kw in ({}, {"acc": acc}, {"acc": acc, "near": 2.0, "far": 4.0}):
        with without_imageio_and_matplotlib():
            got = tmod.apply_depth_colormap(depth, **kw)
        assert np.array_equal(got, jmod.apply_depth_colormap(depth, **kw)), kw


def test_colormap_refuses_a_name_it_does_not_carry():
    with pytest.raises(ValueError, match="viridis"):
        tmod.apply_float_colormap(np.zeros(3), "viridis")


def test_compression_and_viewer_png_without_imageio(tmp_path):
    js = random_scene(300, seed=4, extent=0.8)
    ts = scene_from_numpy({k: np.asarray(getattr(js, k)) for k in SCENE_FIELDS}, device="cpu")
    out = str(tmp_path / "c")
    frame = np.random.default_rng(5).integers(0, 256, (24, 40, 3), dtype=np.uint8)
    with without_imageio_and_matplotlib():
        tcomp.compress_scene(ts, out)
        back = scene_to_numpy(tcomp.decompress_scene(out, device="cpu"))
        png = viewer_png(frame)
    ref = jcomp.decompress_scene(out)
    for k in SCENE_FIELDS:
        np.testing.assert_array_equal(back[k], np.asarray(getattr(ref, k)), err_msg=k)
    assert np.array_equal(iio.imread(png), frame) and np.array_equal(read_image(png), frame)
    assert torch.is_tensor(tcomp.decompress_scene(out, device="cpu").means)

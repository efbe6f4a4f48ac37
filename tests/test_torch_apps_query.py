"""The port's query apps (``tpugs_torch.apps``: segment,
backproject_compressed, train_codec, visualize_pca, affordance; on
``device="cpu"``) against tpugs' apps (JAX on the CPU) on one on-disk
dataset written by tpugs: 60 Gaussians of ``random_scene(60, seed=0,
extent=0.8, scale_range=(0.02, 0.1))``, a 2-view 64x48 orbit COLMAP model
and a gsplat ``.pt`` (a second ``.pt`` adds a trained feature field for
``--f3dgs``). Each test writes into its own results directories.

* segment (``--skip-prune``; pruning is held to tpugs in
  ``test_torch_app_backproject.py``): the same mask from ``--pos-idx`` /
  ``--neg-idx`` as tpugs' app, with ``--export-checkpoint`` (the exported
  scenes equal); the GIFs are written; both print ``mask: K/N``; from
  ``--pos-idx`` alone (neg = -pos) and from ``--f3dgs``, the mask of
  tpugs' ``get_mask3d`` on the same features; through text prompts with
  ``encode_text`` patched in both packages, the compressed field
  (``--compressed``) selects what the uncompressed one does (tpugs' own
  test), which is tpugs' mask; a codec of the wrong width raises;
* backproject_compressed: ``eager`` against tpugs' app (which picks eager
  on a CPU) to 1e-5; ``pallas`` (bf16 rows) to a relative L2 error of 1e-2
  per Gaussian; ``CompressedEncoder`` carries ``pixelwise``;
* train_codec from ``--embeddings-npz``, the port's init patched to
  tpugs' draw: the saved codecs within 1e-4 of their largest entry;
* visualize_pca: both modes' frames within 1 uint8 unit of the frames
  tpugs' app hands to its GIF writer;
* affordance: the same labels as tpugs' app; with ``.mat`` ground truth
  (one view marked automatic, with wrong labels, skipped) and with PNG
  ground truth, tpugs' metrics on the ``.mat`` files, IoU 1 on the app's
  own labels;
* ``python -m tpugs_torch.apps.segment --device cpu`` in a subprocess.
"""

import base64
import contextlib
import io
import json
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpugs.codec.linear import LinearCodec as JCodec
from tpugs.codec.linear import save_codec, train_codec
from tpugs.core.scene import GaussianScene as JScene
from tpugs.io.checkpoints import save_scene_pt
from tpugs.utils.synthetic import orbit_cameras, random_scene, write_synthetic_colmap
from tpugs_torch.convert import SCENE_FIELDS, scene_to_numpy
from tpugs_torch.io.checkpoints import load_scene_pt

REPO = Path(__file__).resolve().parent.parent
N, W, H, D = 60, 64, 48, 8
FEATURE = "linear:8"


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    root = tmp_path_factory.mktemp("query-apps")
    data = root / "data"
    js = random_scene(N, seed=0, extent=0.8, scale_range=(0.02, 0.1))
    write_synthetic_colmap(str(data), orbit_cameras(2, W, H, radius=2.5))
    save_scene_pt(js, str(data / "ckpt.pt"))
    rng = np.random.default_rng(7)
    f3 = JScene(**{k: getattr(js, k) for k in SCENE_FIELDS},
                features=jnp.asarray(rng.normal(size=(N, 4)), jnp.float32),
                feature_proj=jnp.asarray(rng.normal(size=(4, D)), jnp.float32))
    save_scene_pt(f3, str(data / "f3dgs.pt"))
    return root


def _clustered_field(seed=0):
    """(N, D) features in two clusters with clear margins."""
    rng = np.random.default_rng(seed)
    centres = rng.normal(size=(2, D)) * 3
    return (centres[np.arange(N) % 2] + rng.normal(size=(N, D))).astype(np.float32)


def _results(dataset, tag, feats=None, name=f"features_{FEATURE}.npz"):
    out = dataset / tag
    out.mkdir(exist_ok=True)
    if feats is not None:
        np.savez(out / name, features=feats)
    return str(out)


def _run(main, dataset, results, **kw):
    """(returned value, stdout) of one app run."""
    data = dataset / "data"
    kw.setdefault("checkpoint", str(data / "ckpt.pt"))
    log = io.StringIO()
    with contextlib.redirect_stdout(log):
        out = main(data_dir=str(data), results_dir=results, data_factor=1, **kw)
    return out, log.getvalue()


def _mask_line(log):
    return [line for line in log.splitlines() if line.startswith("mask: ")]


@contextlib.contextmanager
def _without_imageio_and_matplotlib(monkeypatch):
    """``import imageio`` and ``import matplotlib`` fail inside, as on the
    card's machine: the port's apps write their files without them."""
    with monkeypatch.context() as m:
        for name in ("imageio", "matplotlib"):
            m.setitem(sys.modules, name, None)
        yield


def test_segment_matches_tpugs(dataset, monkeypatch):
    from tpugs.apps.segment import main as j_main
    from tpugs_torch.apps.segment import main as t_main

    feats = _clustered_field()
    kw = dict(feature=FEATURE, pos_idx="0,2", neg_idx="1,3", export_checkpoint=True,
              skip_prune=True)
    tres, jres = _results(dataset, "seg-port", feats), _results(dataset, "seg-tpugs", feats)
    with _without_imageio_and_matplotlib(monkeypatch):
        got, log = _run(t_main, dataset, tres, device="cpu", **kw)
    ref, j_log = _run(j_main, dataset, jres, **kw)
    assert got.dtype == torch.bool and 0 < int(got.sum()) < N
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert _mask_line(log) == _mask_line(j_log) == [
        f"mask: {int(got.sum())}/{N} Gaussians selected"]
    for name in ("mask2d.gif", "extracted.gif", "deleted.gif"):
        assert os.path.exists(os.path.join(tres, name)), name
    for name in ("extracted.pt", "deleted.pt"):
        a = scene_to_numpy(load_scene_pt(os.path.join(tres, name), device="cpu"))
        b = scene_to_numpy(load_scene_pt(os.path.join(jres, name), device="cpu"))
        for k in SCENE_FIELDS:
            np.testing.assert_array_equal(a[k], b[k], err_msg=f"{name} {k}")


def test_segment_negated_and_f3dgs_queries_match_tpugs(dataset):
    """``--pos-idx`` alone (neg = -pos) and ``--f3dgs`` (features @
    feature_proj of the checkpoint): the app's masks against tpugs'
    ``get_mask3d`` on the same features."""
    from tpugs.query.text import get_mask3d
    from tpugs_torch.apps.segment import main as t_main

    feats = _clustered_field(2)
    got, _ = _run(t_main, dataset, _results(dataset, "seg-neg", feats), feature=FEATURE,
                  pos_idx="5", skip_prune=True, device="cpu")
    ref, _ = get_mask3d(feats, feats[5:6], -feats[5:6])
    assert 0 < int(got.sum()) < N
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    js = load_scene_pt(str(dataset / "data" / "f3dgs.pt"), device="cpu")
    f3 = (js.features @ js.feature_proj).numpy()
    got, _ = _run(t_main, dataset, _results(dataset, "seg-f3"), f3dgs=True, pos_idx="4,9",
                  neg_idx="5", skip_prune=True, checkpoint=str(dataset / "data" / "f3dgs.pt"),
                  device="cpu")
    ref, _ = get_mask3d(f3, f3[[4, 9]], f3[[5]])
    assert 0 < int(got.sum()) < N
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    with pytest.raises(ValueError, match="feature field"):
        _run(t_main, dataset, _results(dataset, "seg-f3"), f3dgs=True, pos_idx="4",
             skip_prune=True, device="cpu")


def test_segment_compressed_text_query_matches_uncompressed(dataset, monkeypatch):
    """tpugs' own test, through both packages: with features exactly in the
    codec's latent subspace, the compressed segmentation equals the
    uncompressed one, and the port's masks equal tpugs'."""
    import tpugs.encoders.lseg as j_lseg
    import tpugs_torch.encoders.lseg as t_lseg
    from tpugs.apps.segment import main as j_main
    from tpugs_torch.apps.segment import main as t_main

    rng = np.random.default_rng(3)
    d_in, d_lat = 64, D
    basis, _ = np.linalg.qr(rng.normal(size=(d_in, d_lat)))
    z = rng.normal(size=(N, d_lat)).astype(np.float32)
    z[: N // 2, 0] += 3.0
    z[N // 2:, 1] += 3.0
    q_pos = (np.eye(d_lat)[:1] @ basis.T).astype(np.float32)
    q_neg = (np.eye(d_lat)[1:2] @ basis.T).astype(np.float32)
    monkeypatch.setattr(j_lseg, "encode_text", lambda prompts, ckpt=None, bpe_path=None:
                        jnp.asarray(q_pos if prompts == ["obj"] else q_neg))
    monkeypatch.setattr(t_lseg, "encode_text", lambda prompts, ckpt=None, bpe_path=None,
                        device="cuda": torch.from_numpy(q_pos if prompts == ["obj"] else q_neg))

    res = _results(dataset, "text-port", (z @ basis.T).astype(np.float32))
    np.savez(os.path.join(res, f"features_{FEATURE}_compressed.npz"), features=z)
    codec_path = os.path.join(res, "codec.npz")
    save_codec(JCodec(encoder=jnp.asarray(basis, jnp.float32),
                      decoder=jnp.asarray(basis.T, jnp.float32)), codec_path)
    kw = dict(feature=FEATURE, prompt="obj", neg_prompt="bg", skip_prune=True)
    full, _ = _run(t_main, dataset, res, device="cpu", **kw)
    comp, _ = _run(t_main, dataset, res, compressed=True, codec_path=codec_path, device="cpu",
                   **kw)
    ref, _ = _run(j_main, dataset, _results(dataset, "text-tpugs", (z @ basis.T).astype(
        np.float32)), **kw)
    assert int(full.sum()) == N // 2
    np.testing.assert_array_equal(comp.numpy(), full.numpy())
    np.testing.assert_array_equal(full.numpy(), np.asarray(ref))

    wrong = os.path.join(res, "wide.npz")
    save_codec(JCodec(encoder=jnp.zeros((d_in, 4)), decoder=jnp.zeros((4, d_in))), wrong)
    with pytest.raises(ValueError, match="latents"):
        _run(t_main, dataset, res, compressed=True, codec_path=wrong, device="cpu", **kw)


@pytest.fixture(scope="module")
def codec_path(dataset):
    rng = np.random.default_rng(0)
    codec, _ = train_codec(jnp.asarray(rng.normal(size=(30, 16)).astype(np.float32)), d_lat=4,
                           steps=200, lr=1e-2)
    path = str(dataset / "codec16.npz")
    save_codec(codec, path)
    return path


def test_backproject_compressed_matches_tpugs(dataset, codec_path):
    from tpugs.apps.backproject_compressed import main as j_main
    from tpugs_torch.apps.backproject_compressed import CompressedEncoder, main as t_main

    kw = dict(codec_path=codec_path, feature="linear:16", skip_prune=True)
    ref, _ = _run(j_main, dataset, _results(dataset, "comp-tpugs"), **kw)
    ref = np.asarray(ref)
    name = "features_linear:16_compressed.npz"
    for engine in ("eager", "pallas"):
        res = _results(dataset, f"comp-{engine}")
        got, log = _run(t_main, dataset, res, engine=engine, device="cpu", **kw)
        assert "Saved" in log and got.shape == ref.shape == (N, 4)
        np.testing.assert_array_equal(np.load(os.path.join(res, name))["features"], got)
        if engine == "eager":
            np.testing.assert_allclose(got, ref, atol=1e-5)
            continue
        lit = np.abs(ref).sum(1) > 0
        np.testing.assert_array_equal(np.abs(got).sum(1) > 0, lit)
        rel = np.linalg.norm(got[lit] - ref[lit], axis=1) / np.linalg.norm(ref[lit], axis=1)
        assert rel.max() <= 1e-2, rel.max()
    with pytest.raises(ValueError, match="unknown engine"):
        _run(t_main, dataset, _results(dataset, "comp-bad"), engine="scan", device="cpu", **kw)

    class NotPixelwise:
        feature_dim = 3

    codec = JCodec(encoder=jnp.zeros((3, 2)), decoder=jnp.zeros((2, 3)))
    assert CompressedEncoder(NotPixelwise(), codec).pixelwise is False
    from tpugs_torch.encoders.base import LinearRGBEncoder

    enc = CompressedEncoder(LinearRGBEncoder(3, device="cpu"), codec)
    assert enc.pixelwise is True and enc.feature_dim == 2


def test_train_codec_app_matches_tpugs(dataset, monkeypatch):
    from tpugs.apps.train_codec import main as j_main
    from tpugs_torch.apps.train_codec import main as t_main
    from tpugs_torch.codec import linear as tcodec
    from tpugs_torch.convert import codec_from_numpy

    emb_path = str(dataset / "emb.npz")
    np.savez(emb_path, embeddings=np.random.default_rng(5).normal(size=(40, 32)).astype(
        np.float32))
    start = JCodec.init(32, 4, seed=0)  # the draw tpugs' app starts from
    monkeypatch.setattr(tcodec.LinearCodec, "init", staticmethod(
        lambda d_in, d_lat, generator=None, device="cuda": codec_from_numpy(
            np.asarray(start.encoder), np.asarray(start.decoder), device=device)))
    outs = {}
    for tag, main, extra in (("port", t_main, {"device": "cpu"}), ("tpugs", j_main, {})):
        out = str(dataset / f"codec-{tag}" / "encoder_decoder.npz")
        log = io.StringIO()
        with contextlib.redirect_stdout(log):
            main(output=out, embeddings_npz=emb_path, d_lat=4, steps=10, **extra)
        assert "Saved codec to" in log.getvalue() and "1000 " in log.getvalue()
        outs[tag] = np.load(out)
    for key in ("encoder", "decoder"):
        ref = outs["tpugs"][key]
        np.testing.assert_allclose(outs["port"][key], ref, atol=1e-4 * np.abs(ref).max(), rtol=0)
    with pytest.raises(FileNotFoundError, match="objectInfo150"):
        t_main(output=str(dataset / "x.npz"), labels_csv=str(dataset / "missing.csv"),
               device="cpu")


def test_visualize_pca_app_matches_tpugs(dataset, monkeypatch):
    import tpugs.viz.pca as jpca
    from tpugs.apps.visualize_pca import main as j_main
    from tpugs_torch.apps.visualize_pca import main as t_main

    feats = _clustered_field(1)
    caught = []
    real_save = jpca.save_gif
    monkeypatch.setattr(jpca, "save_gif", lambda frames, path, fps=10: (
        caught.append(frames), real_save(frames, path, fps)))
    _run(j_main, dataset, _results(dataset, "pca-tpugs", feats), feature=FEATURE,
         skip_prune=True)
    res = _results(dataset, "pca-port", feats)
    with _without_imageio_and_matplotlib(monkeypatch):
        got, _ = _run(t_main, dataset, res, feature=FEATURE, skip_prune=True, device="cpu")
    assert len(caught) == len(got) == 2
    for frames, ref in zip(got, caught):
        for g, r in zip(frames, ref):
            assert np.abs(g.astype(int) - np.asarray(r).astype(int)).max() <= 1
    for name in ("pca_gaussian.gif", "pca_frame.gif"):
        assert os.path.exists(os.path.join(res, name))


def _exemplars(root):
    import imageio.v2 as imageio

    root.mkdir(exist_ok=True)
    rng = np.random.default_rng(0)
    imageio.imwrite(str(root / "ex.jpg"), (rng.uniform(0, 1, (16, 16, 3)) * 255).astype(np.uint8))
    mask = np.zeros((16, 16), np.uint8)
    mask[:8] = 255
    buf = io.BytesIO()
    imageio.imwrite(buf, mask, format="png")
    (root / "ex.json").write_text(json.dumps({"imagePath": "ex.jpg", "shapes": [
        {"label": "grasp", "mask": base64.b64encode(buf.getvalue()).decode()},
        {"label": "cut", "points": [[0, 8], [15, 8], [15, 15], [0, 15]]},
    ]}))
    return str(root)


def test_affordance_app_matches_tpugs(dataset):
    import imageio.v2 as imageio
    from scipy.io import savemat

    from tpugs.apps.affordance import main as j_main
    from tpugs.query.affordance import render_label_masks
    from tpugs_torch.apps.affordance import main as t_main

    ex = _exemplars(dataset / "exemplars")
    kw = dict(exemplar_dir=ex, encoder_name=FEATURE, skip_prune=True, knn=3)
    labels, metrics = _run(t_main, dataset, _results(dataset, "aff-port"), device="cpu", **kw)[0]
    ref, ref_metrics = _run(j_main, dataset, _results(dataset, "aff-tpugs"), **kw)[0]
    assert metrics is None and ref_metrics is None
    np.testing.assert_array_equal(labels, np.asarray(ref))
    assert set(np.unique(labels)) <= {1, 2} and len(labels) == N

    js = random_scene(N, seed=0, extent=0.8, scale_range=(0.02, 0.1))
    jc = orbit_cameras(2, W, H, radius=2.5)
    preds = [render_label_masks(js, labels, np.asarray(jc.viewmats[c]), np.asarray(jc.Ks[c]),
                                W, H) for c in range(2)]
    mat_dir, png_dir = dataset / "gt-mat", dataset / "gt-png"
    mat_dir.mkdir()
    png_dir.mkdir()
    for c, pred in enumerate(preds):
        wrong = c == 1  # the automatic view gets wrong labels: it must be skipped
        savemat(str(mat_dir / f"frame_{c:04d}_label.mat"),
                {"gt_label": np.roll(pred, W // 2, axis=1) if wrong else pred,
                 "gt_type": "automatic" if wrong else "manual"})
        imageio.imwrite(str(png_dir / f"frame_{c:04d}.png"), pred.astype(np.uint8))
    (_, m_ref), _ = _run(j_main, dataset, _results(dataset, "aff-tpugs"), gt_dir=str(mat_dir),
                         **kw)
    for gt in (mat_dir, png_dir):
        (got, m), _ = _run(t_main, dataset, _results(dataset, "aff-port"), gt_dir=str(gt),
                           device="cpu", **kw)
        np.testing.assert_array_equal(got, labels)
        assert m == m_ref and m["mean"]["iou"] == 1.0 and m["mean"]["recall"] == 1.0
        assert os.path.exists(dataset / "aff-port" / "affordance_eval.json")
    for name in ("affordance.gif", "affordance_labels.npz", f"features_{FEATURE}.npz"):
        assert os.path.exists(dataset / "aff-port" / name), name


def test_segment_cli_subprocess(dataset):
    data, res = dataset / "data", _results(dataset, "seg-cli", _clustered_field())
    proc = subprocess.run(
        [sys.executable, "-m", "tpugs_torch.apps.segment", "--device", "cpu",
         "--data-dir", str(data), "--checkpoint", str(data / "ckpt.pt"), "--results-dir", res,
         "--data-factor", "1", "--feature", FEATURE, "--pos-idx", "0,2", "--neg-idx", "1,3",
         "--skip-prune"],
        cwd=REPO, capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": str(REPO)})
    assert proc.returncode == 0, proc.stderr
    assert f"/{N} Gaussians selected" in proc.stdout, proc.stdout
    assert os.path.exists(os.path.join(res, "deleted.gif"))

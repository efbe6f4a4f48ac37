"""LPIPS: ``train/lpips.py`` on the CPU against ``tests/golden/lpips.npz``
(tpugs' distance under ``random_lpips_params(net, 0)`` on the golden
images) and against tpugs' ``lpips_distance`` (jitted), AlexNet and VGG16
trunks, within 1e-5 relative; ``random_lpips_params`` equal to tpugs'
draws; ``load_lpips_params`` and ``load_lpips_file`` (``.pth`` and
``.npz``) equal to tpugs' on a state dict of the torchvision / lpips key
layout.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpugs.train import lpips as jl
from tpugs_torch.train import lpips as tl

GOLDEN = Path(__file__).resolve().parent / "golden" / "lpips.npz"


def _golden_image(seed):
    """tests/test_golden.py's ``_rng_array((64, 64, 3), seed, 0.3) + 0.5``."""
    return np.random.default_rng(seed).normal(0, 0.3, (64, 64, 3)).astype(np.float32) + 0.5


@pytest.mark.parametrize("net", ["alex", "vgg"])
def test_lpips_matches_golden(net):
    with np.load(GOLDEN) as g:
        want = float(g[net])
    got = float(tl.lpips_distance(tl.random_lpips_params(net, 0), _golden_image(40),
                                  _golden_image(41), device="cpu"))
    np.testing.assert_allclose(got, want, rtol=1e-5)


@pytest.mark.parametrize("net", ["alex", "vgg"])
def test_lpips_matches_tpugs(net):
    rng = np.random.default_rng(7)
    a = rng.uniform(0, 1, (48, 72, 3)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.1, a.shape), 0, 1).astype(np.float32)
    ours, ref = tl.random_lpips_params(net, 3), jl.random_lpips_params(net, 3)
    assert set(ours) == set(ref)
    for k in ours:
        if k != "net":
            np.testing.assert_array_equal(ours[k], np.asarray(ref[k]), err_msg=k)
    want = float(jax.jit(lambda x, y: jl.lpips_distance(ref, x, y))(jnp.asarray(a), jnp.asarray(b)))
    got = float(tl.lpips_distance(ours, torch.from_numpy(a), torch.from_numpy(b), device="cpu"))
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert float(tl.lpips_distance(tl.params_to(ours, "cpu"), a, a, device="cpu")) == 0.0


def _torch_layout(net, seed=9):
    """A torchvision ``features.*`` + lpips ``lin*`` state dict of the
    production shapes, with some negative lin weights."""
    rng = np.random.default_rng(seed)
    p = jl.random_lpips_params(net, seed)
    idxs = jl._ALEX_FEATURE_IDX if net == "alex" else jl._VGG_FEATURE_IDX
    sd = {}
    for i, fi in enumerate(idxs):
        sd[f"features.{fi}.weight"] = np.asarray(p[f"conv{i}_w"])
        sd[f"features.{fi}.bias"] = rng.normal(0, 0.01, p[f"conv{i}_b"].shape).astype(np.float32)
    for t in range(5):
        c = p[f"lin{t}_w"].shape[0]
        sd[f"lin{t}.model.1.weight"] = rng.normal(0, 0.1, (1, c, 1, 1)).astype(np.float32)
    return sd


@pytest.mark.parametrize("net", ["alex", "vgg"])
def test_loaders_match_tpugs(net, tmp_path):
    sd = _torch_layout(net)
    backbone = {k: v for k, v in sd.items() if k.startswith("features.")}
    lin = {k: v for k, v in sd.items() if k.startswith("lin")}
    ours = tl.load_lpips_params(backbone, lin, net)
    ref = jl.load_lpips_params(backbone, lin, net)
    assert set(ours) == set(ref) and ours["net"] == net
    for k in ours:
        if k != "net":
            np.testing.assert_array_equal(ours[k], np.asarray(ref[k]), err_msg=k)
    pth = tmp_path / "lpips.pth"
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, pth)
    from_pth = tl.load_lpips_file(str(pth), net)
    ref_pth = jl.load_lpips_file(str(pth), net)
    npz = tmp_path / "lpips.npz"
    np.savez(npz, **from_pth)
    from_npz = tl.load_lpips_file(str(npz))
    assert from_pth["net"] == from_npz["net"] == ref_pth["net"] == net
    for k in ours:
        if k != "net":
            np.testing.assert_array_equal(from_pth[k], ours[k], err_msg=k)
            np.testing.assert_array_equal(from_npz[k], ours[k], err_msg=k)
            np.testing.assert_array_equal(np.asarray(ref_pth[k]), ours[k], err_msg=k)
    with pytest.raises(KeyError):
        tl.load_lpips_params({}, {}, net)

"""The dense oracle: the port's ``render_naive`` and ``render_naive_sh``
against tpugs' on one numpy-seeded scene (tpugs as JAX on the CPU), 64x48,
3 orbit cameras.

* images and alphas (direct colours, SH degree 3, a background): 2e-5
  absolute, tpugs' own limit for tiled against naive
  (``tests/test_rasterizer.py``);
* gradients of a seeded loss by means, quats, scales, opacities and
  colours against ``jax.grad`` of tpugs' naive render: 5e-5 of each
  gradient's max (``tests/test_rasterizer.py``'s limit);
* ``evaluate_alpha`` and ``composite`` on the same inputs: 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpugs.raster import naive as jn
from tpugs.utils.synthetic import orbit_cameras, random_scene
from tpugs_torch.raster import naive as tn

W, H = 64, 48


@pytest.fixture(scope="module")
def setup():
    js = random_scene(150, seed=0, sh_degree=3, extent=0.8, scale_range=(0.02, 0.12))
    jc = orbit_cameras(3, W, H, radius=2.5)
    return js, jc


def _t(x):
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _args(js, colors):
    return [js.means, js.quats, js.scales, js.opacities, colors]


@pytest.mark.parametrize("cam", [0, 1, 2])
def test_render_naive_matches_tpugs(setup, cam):
    js, jc = setup
    colors = jnp.abs(js.sh0[:, 0, :])
    bg = jnp.array([0.2, 0.4, 0.6]) if cam == 1 else None
    vm, K = jc.viewmats[cam], jc.Ks[cam]
    img_j, alpha_j = jn.render_naive(*_args(js, colors), vm, K, W, H, background=bg)
    img, alpha = tn.render_naive(*map(_t, _args(js, colors)), _t(vm), _t(K), W, H,
                                 background=None if bg is None else _t(bg))
    assert img.shape == (H, W, 3) and alpha.shape == (H, W)
    np.testing.assert_allclose(img.numpy(), np.asarray(img_j), atol=2e-5)
    np.testing.assert_allclose(alpha.numpy(), np.asarray(alpha_j), atol=2e-5)
    assert float(alpha.max()) > 0.5


def test_render_naive_sh_matches_tpugs(setup):
    js, jc = setup
    vm, K = jc.viewmats[0], jc.Ks[0]
    img_j, _ = jn.render_naive_sh(js.means, js.quats, js.scales, js.opacities, js.colors_all,
                                  vm, K, W, H, sh_degree=3)
    img, _ = tn.render_naive_sh(*map(_t, (js.means, js.quats, js.scales, js.opacities,
                                          js.colors_all, vm, K)), W, H, sh_degree=3)
    np.testing.assert_allclose(img.numpy(), np.asarray(img_j), atol=2e-5)


def test_render_naive_gradients_match_jax(setup):
    js, jc = setup
    vm, K = jc.viewmats[2], jc.Ks[2]
    colors = jnp.abs(js.sh0[:, 0, :])
    target = np.random.default_rng(4).uniform(0, 1, (H, W, 3)).astype(np.float32)

    def loss_j(*a):
        img, _ = jn.render_naive(*a, vm, K, W, H)
        return jnp.sum((img - target) ** 2)

    g_ref = jax.jit(jax.grad(loss_j, argnums=(0, 1, 2, 3, 4)))(*_args(js, colors))
    leaves = [_t(a).requires_grad_() for a in _args(js, colors)]
    img, _ = tn.render_naive(*leaves, _t(vm), _t(K), W, H)
    grads = torch.autograd.grad(((img - torch.from_numpy(target)) ** 2).sum(), leaves)
    for name, g, r in zip(("means", "quats", "scales", "opacities", "colors"), grads, g_ref):
        r = np.asarray(r)
        scale = float(np.abs(r).max())
        assert scale > 0, name
        np.testing.assert_allclose(g.numpy() / scale, r / scale, atol=5e-5, err_msg=name)


def test_alpha_and_composite_match_tpugs():
    rng = np.random.default_rng(1)
    conics = np.abs(rng.normal(0.3, 0.2, (40, 3))).astype(np.float32)
    conics[:, 1] *= 0.2
    opac = rng.uniform(0, 1, 40).astype(np.float32)
    dx = rng.normal(0, 4, (40, 30)).astype(np.float32)
    dy = rng.normal(0, 4, (40, 30)).astype(np.float32)
    a_j = jn.evaluate_alpha(conics[:, None], opac[:, None], dx, dy)
    a_t = tn.evaluate_alpha(_t(conics)[:, None], _t(opac)[:, None], _t(dx), _t(dy))
    np.testing.assert_allclose(a_t.numpy(), np.asarray(a_j), atol=1e-6)
    assert 0 < float((a_t == 0).float().mean()) < 1
    cols = rng.uniform(0, 1, (40, 5)).astype(np.float32)
    for got, ref in zip(tn.composite(a_t, _t(cols)), jn.composite(a_j, cols)):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-6)
    np.testing.assert_array_equal(tn.pixel_centers(5, 3).numpy(),
                                  np.asarray(jn.pixel_centers(5, 3)))

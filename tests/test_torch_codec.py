"""The port's linear codec (``tpugs_torch.codec.linear``) against tpugs'
(JAX and optax on the CPU, under ``jax.jit``), from tpugs' own init
(``convert.py::codec_from_numpy``, patched in for ``LinearCodec.init``:
``jax.random``'s draw cannot be reproduced by a ``torch.Generator``).

* ``codec_loss`` and its gradient against ``jax.value_and_grad``: 1e-6
  relative (the gradient to 1e-6 of its largest entry);
* ``train_codec`` (Adam, lr 1e-3) with ``steps=10``, which runs one whole
  chunk of 1000 steps in both: loss within 1e-4 relative, encoder and
  decoder within 1e-4 of their largest entry; the port's ``steps=10``
  equal to its ``steps=1000``; the loss returned is the one computed
  before the last update;
* npz files written by either package load in the other, bit-equal;
* ``LinearCodec.init`` is deterministic in its generator;
* the training step (forward, backward, Adam) and ``compress`` /
  ``decompress`` run every product with TF32 off, whatever the caller
  has set.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from tpugs.codec import linear as jcodec
from tpugs_torch.codec import linear as tcodec
from tpugs_torch.convert import codec_from_numpy

D_IN, D_LAT, M = 32, 4, 30


def _emb(seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(M, 6)) @ rng.normal(size=(6, D_IN))).astype(np.float32)


def _x_norm(emb):
    return emb / (np.linalg.norm(emb, axis=1, keepdims=True) + 1e-12)


@pytest.fixture(scope="module")
def init():
    return jcodec.LinearCodec.init(D_IN, D_LAT, seed=3)


def _port(jc):
    return codec_from_numpy(np.asarray(jc.encoder), np.asarray(jc.decoder), device="cpu")


def _start_from(monkeypatch, jc):
    """Make the port's ``LinearCodec.init`` return tpugs' draw ``jc``."""
    monkeypatch.setattr(tcodec.LinearCodec, "init", staticmethod(
        lambda d_in, d_lat, generator=None, device="cuda": _port(jc)))


def test_codec_loss_and_gradient_match_jax(init):
    x = _x_norm(_emb()).astype(np.float32)
    loss_j, g_j = jax.jit(jax.value_and_grad(jcodec.codec_loss))(init, jnp.asarray(x))
    tc = _port(init)
    enc = tc.encoder.clone().requires_grad_(True)
    dec = tc.decoder.clone().requires_grad_(True)
    loss = tcodec.codec_loss(tcodec.LinearCodec(enc, dec), torch.from_numpy(x))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(loss_j), rtol=1e-6)
    for got, ref in ((enc.grad, g_j.encoder), (dec.grad, g_j.decoder)):
        ref = np.asarray(ref)
        np.testing.assert_allclose(got.numpy(), ref, atol=1e-6 * np.abs(ref).max(), rtol=0)


def test_train_codec_matches_tpugs_including_the_chunk_quirk(init, monkeypatch):
    emb = _emb(1)
    jax_codec, jax_loss = jcodec.train_codec(jnp.asarray(emb), d_lat=D_LAT, steps=10, lr=1e-3)
    # tpugs draws its init inside train_codec from seed 0: start the port there
    start = jcodec.LinearCodec.init(D_IN, D_LAT, seed=0)
    _start_from(monkeypatch, start)
    got, loss = tcodec.train_codec(emb, d_lat=D_LAT, steps=10, lr=1e-3, device="cpu")
    np.testing.assert_allclose(loss, jax_loss, rtol=1e-4)
    for a, b in ((got.encoder, jax_codec.encoder), (got.decoder, jax_codec.decoder)):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, atol=1e-4 * np.abs(b).max(), rtol=0)
    moved = np.abs(got.encoder.numpy() - np.asarray(start.encoder)).max()
    assert moved > 0.5, "1000 Adam steps at lr 1e-3 move the weights by ~1"
    full, full_loss = tcodec.train_codec(emb, d_lat=D_LAT, steps=1000, lr=1e-3, device="cpu")
    assert full_loss == loss and torch.equal(full.encoder, got.encoder)


def test_train_codec_returns_the_loss_before_the_last_update(init, monkeypatch):
    emb = _emb(2)
    x = torch.from_numpy(_x_norm(emb).astype(np.float32))
    _start_from(monkeypatch, init)
    got, loss = tcodec.train_codec(emb, d_lat=D_LAT, steps=1, lr=1e-2, log_every=1,
                                   device="cpu")
    assert loss == float(tcodec.codec_loss(_port(init), x))
    assert float(tcodec.codec_loss(got, x)) != loss
    _, jax_loss = jcodec.train_codec(jnp.asarray(emb), d_lat=D_LAT, steps=1, lr=1e-2,
                                     seed=3, log_every=1)
    np.testing.assert_allclose(loss, jax_loss, rtol=1e-6)


def test_npz_files_load_both_ways(tmp_path, init):
    tpath, jpath = str(tmp_path / "port.npz"), str(tmp_path / "tpugs.npz")
    tcodec.save_codec(_port(init), tpath)
    jcodec.save_codec(init, jpath)
    from_port = jcodec.load_codec(tpath)
    from_tpugs = tcodec.load_codec(jpath, device="cpu")
    for a, b in ((from_port.encoder, init.encoder), (from_port.decoder, init.decoder),
                 (from_tpugs.encoder.numpy(), init.encoder),
                 (from_tpugs.decoder.numpy(), init.decoder)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    x = torch.randn(3, D_IN, generator=torch.Generator().manual_seed(0))
    np.testing.assert_allclose(from_tpugs.compress(x).numpy(),
                               np.asarray(init.compress(jnp.asarray(x.numpy()))), atol=1e-5)
    with pytest.raises(ValueError, match="decoder"):
        codec_from_numpy(np.zeros((4, 2)), np.zeros((4, 2)), device="cpu")


def test_init_is_deterministic_in_its_generator():
    a = tcodec.LinearCodec.init(8, 3, torch.Generator().manual_seed(5), device="cpu")
    b = tcodec.LinearCodec.init(8, 3, torch.Generator().manual_seed(5), device="cpu")
    c = tcodec.LinearCodec.init(8, 3, torch.Generator().manual_seed(6), device="cpu")
    assert a.encoder.shape == (8, 3) and a.decoder.shape == (3, 8)
    assert torch.equal(a.encoder, b.encoder) and torch.equal(a.decoder, b.decoder)
    assert not torch.equal(a.encoder, c.encoder)


class _MatmulFlags(TorchDispatchMode):
    """Records ``allow_tf32`` at every matrix product the dispatcher sees,
    those of autograd's backward pass included."""

    PRODUCTS = {torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
                torch.ops.aten.addmm.default}

    def __init__(self):
        super().__init__()
        self.flags = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in self.PRODUCTS:
            self.flags.append(torch.backends.cuda.matmul.allow_tf32)
        return func(*args, **(kwargs or {}))


def test_codec_products_keep_tf32_off(init, monkeypatch):
    _start_from(monkeypatch, init)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    with _MatmulFlags() as seen:
        tcodec.train_codec(_emb(3), d_lat=D_LAT, steps=1, log_every=1, device="cpu")
        codec = _port(init)
        codec.decompress(codec.compress(torch.ones(2, D_IN)))
    assert len(seen.flags) >= 6 and not any(seen.flags), seen.flags
    assert torch.backends.cuda.matmul.allow_tf32 is True

"""Linear 512 -> 16 feature codec. Counterpart: ``tpugs/codec/linear.py:29-130``
(``LinearCodec``, ``codec_loss``, ``train_codec``, ``save_codec``,
``load_codec``).

An encoder/decoder pair trained on CLIP text embeddings of a label
vocabulary: reconstruction MSE plus the MSE between the latent and the
input cosine Gram matrices, Adam (``torch.optim.Adam`` in place of
``optax.adam``: the same betas and eps, eps outside the square root in
both). tpugs' quirks are kept: the steps run in whole chunks of 1000 (or
``log_every``), so ``steps=10`` runs 1000, and the loss returned is the
one computed before the last update.

``LinearCodec.init`` draws from a ``torch.Generator``, not ``jax.random``:
the port cannot reproduce tpugs' draw (``convert.py::codec_from_numpy``
carries tpugs' own). Every product, the backward pass and Adam's step
included, runs in full float32 (``highest_precision``), as tpugs' at
``Precision.HIGHEST``.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional, Tuple

import numpy as np
import torch

from tpugs_torch.core.device import DeviceLike, resolve_device
from tpugs_torch.query.text import _l2norm, highest_precision


@dataclasses.dataclass(frozen=True)
class LinearCodec:
    encoder: torch.Tensor  # (D_in, D_lat)
    decoder: torch.Tensor  # (D_lat, D_in)

    @staticmethod
    def init(d_in: int = 512, d_lat: int = 16, generator: Optional[torch.Generator] = None,
             device: DeviceLike = "cuda") -> "LinearCodec":
        """Standard-normal draws from ``generator`` (a CPU generator; None:
        seed 0), moved to ``device``."""
        dev = resolve_device(device)
        gen = generator if generator is not None else torch.Generator().manual_seed(0)
        enc = torch.randn((d_in, d_lat), generator=gen)
        dec = torch.randn((d_lat, d_in), generator=gen)
        return LinearCodec(enc.to(dev), dec.to(dev))

    def compress(self, x: torch.Tensor) -> torch.Tensor:
        with highest_precision():
            return x @ self.encoder

    def decompress(self, z: torch.Tensor) -> torch.Tensor:
        with highest_precision():
            return z @ self.decoder


def codec_loss(codec: LinearCodec, x_norm: torch.Tensor) -> torch.Tensor:
    """MSE(x, normalize(dec(enc(x)))) + MSE of the latent against the input
    cosine Gram matrices, in full float32."""
    with highest_precision():
        z = codec.compress(x_norm)
        y = _l2norm(codec.decompress(z))
        loss1 = torch.mean((x_norm - y) ** 2)
        zn = _l2norm(z)
        loss2 = torch.mean((zn @ zn.T - x_norm @ x_norm.T) ** 2)
    return loss1 + loss2


def train_codec(
    embeddings,  # (M, D_in), e.g. CLIP text features; numpy or a tensor
    d_lat: int = 16,
    steps: int = 100_000,
    lr: float = 1e-4,
    seed: int = 0,
    log_every: int = 0,
    device: DeviceLike = "cuda",
) -> Tuple[LinearCodec, float]:
    """Train the codec on ``device`` from ``LinearCodec.init`` seeded with
    ``seed``: (codec, the last step's loss before its update)."""
    dev = resolve_device(device)
    x = _l2norm(torch.as_tensor(embeddings, dtype=torch.float32).to(dev))
    init = LinearCodec.init(x.shape[-1], d_lat, torch.Generator().manual_seed(seed), dev)
    enc = init.encoder.detach().to(dev, torch.float32).clone().requires_grad_(True)
    dec = init.decoder.detach().to(dev, torch.float32).clone().requires_grad_(True)
    opt = torch.optim.Adam([enc, dec], lr=lr, betas=(0.9, 0.999), eps=1e-8)
    codec = LinearCodec(enc, dec)
    chunk = 1000 if log_every == 0 else log_every
    t1 = time.time()
    loss = torch.tensor(float("inf"))
    done = 0
    while done < steps:
        with highest_precision():
            for _ in range(chunk):
                opt.zero_grad(set_to_none=True)
                step_loss = codec_loss(codec, x)
                step_loss.backward()
                opt.step()
                loss = step_loss.detach()
        done += chunk
        if log_every and done % log_every == 0:
            print(done, float(loss))
    if log_every:
        print("Time taken for training encoder decoder model: ", time.time() - t1)
    return LinearCodec(enc.detach(), dec.detach()), float(loss)


def save_codec(codec: LinearCodec, path: str) -> None:
    np.savez(path, encoder=codec.encoder.detach().cpu().numpy(),
             decoder=codec.decoder.detach().cpu().numpy())


def load_codec(path: str, device: DeviceLike = "cuda") -> LinearCodec:
    dev = resolve_device(device)
    data = np.load(path)
    return LinearCodec(torch.from_numpy(np.asarray(data["encoder"], np.float32)).to(dev),
                       torch.from_numpy(np.asarray(data["decoder"], np.float32)).to(dev))

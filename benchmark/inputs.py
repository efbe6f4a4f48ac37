"""Every input of a run, made on the device from ``--seed``: the scene,
the orbit of cameras, the encoder's weights and the check's samples. The
same seed gives the same tensors, so the program and the reference are
handed equal inputs; the reference makes its own copy after the program's
state is freed.

Each kind of input draws from its own generator, seeded from the run's
seed and the kind's number, in a few large calls on the card.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np
import torch

KINDS = {"scene": 1, "weights": 2, "choices": 4, "colours": 6}
TRUNC = 2.0  # the truncated normal's bound, in standard deviations


def generator(seed: int, kind: str, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 1_000_003 + KINDS[kind]) % (1 << 63))
    return g


def scene(spec: dict, n: int, seed: int, device) -> Dict[str, torch.Tensor]:
    """``n`` Gaussians as ``bench.py``'s canonical scene draws them:
    means uniform in the cube of half-width ``extent``, random rotations,
    per-axis scales uniform in [scale_min, scale_max], opacities uniform
    in (0.3, 0.95), DC colours uniform in (-0.5, 1.5) and the higher SH
    bands N(0, 0.1^2); raw fields as a 3DGS checkpoint holds them.

    The geometry (means, rotations, scales, opacities) is one draw for
    every seed; the seed permutes the Gaussians and draws their colours.
    Every seed so renders the same set of Gaussians in another order: the
    same work, for other inputs to check (one draw per seed made some
    seeds' views a few per cent heavier than others')."""
    fixed = generator(0, "scene", device)
    u = torch.rand((n, 7), generator=fixed, device=device)
    quats = torch.randn((n, 4), generator=fixed, device=device)
    perm = torch.randperm(n, generator=generator(seed, "scene", device), device=device)
    u, quats = u[perm], quats[perm]
    g = generator(seed, "colours", device)
    k_rest = (spec["sh_degree"] + 1) ** 2 - 1
    ext, lo, hi = spec["extent"], spec["scale_min"], spec["scale_max"]
    opac = 0.3 + 0.65 * u[:, 6]
    return {
        "means": ((2 * u[:, 0:3] - 1) * ext).contiguous(),
        "quats": (quats / torch.linalg.vector_norm(quats, dim=1, keepdim=True)).contiguous(),
        "log_scales": torch.log(lo + (hi - lo) * u[:, 3:6]).contiguous(),
        "logit_opacities": torch.log(opac / (1 - opac)).contiguous(),
        "sh0": (-0.5 + 2.0 * torch.rand((n, 1, 3), generator=g, device=device)).contiguous(),
        "shN": (0.1 * torch.randn((n, k_rest, 3), generator=g, device=device)).contiguous(),
    }


def lookat(eye) -> np.ndarray:
    """World-to-camera matrix of a camera at ``eye`` looking at the origin,
    +z forward and +y down (OpenCV), as ``utils/synthetic.py`` builds it."""
    eye = np.asarray(eye, np.float64)
    fwd = -eye / np.linalg.norm(eye)
    right = np.cross(fwd, np.array([0.0, -1.0, 0.0]))
    right /= np.linalg.norm(right)
    down = np.cross(fwd, right)
    R = np.stack([right, down, fwd], axis=1).T
    vm = np.eye(4, dtype=np.float32)
    vm[:3, :3] = R
    vm[:3, 3] = -R @ eye
    return vm


def orbit(spec: dict, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """(viewmats (C, 4, 4), Ks (C, 3, 3)) of ``n_views`` cameras evenly
    round a circle of ``radius`` at ``elevation`` * radius above the
    centre, with a ``fov_deg`` horizontal field of view."""
    n, W, H = spec["n_views"], spec["width"], spec["height"]
    f = 0.5 * W / np.tan(np.radians(spec["fov_deg"]) / 2)
    K = np.array([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1]], np.float32)
    r, el = spec["radius"], spec["elevation"]
    vms = [lookat((r * np.cos(2 * np.pi * i / n), -el * r, r * np.sin(2 * np.pi * i / n)))
           for i in range(n)]
    return (torch.from_numpy(np.stack(vms)).to(device),
            torch.from_numpy(np.tile(K[None], (n, 1, 1))).to(device))


def weights(params: List[Tuple[str, tuple, str]], seed: int, device,
            dtype: torch.dtype) -> Dict[str, torch.Tensor]:
    """Every parameter of ``params`` (name, shape, init) in ``dtype``, views
    of one buffer: dense and convolution kernels ("fan_in") a normal
    truncated at two deviations with variance 1/fan_in (a transposed
    convolution's fan-in counts its input channels and kernel), positions
    the same at 0.02, biases and class and register tokens 0, norms' gains
    1, LayerScale 1e-5. One uniform draw feeds every random leaf."""
    sizes = [math.prod(s) for _, s, _ in params]
    flat = torch.empty(sum(sizes), dtype=torch.float32, device=device)
    lo = 0.5 * (1 + math.erf(-TRUNC / math.sqrt(2)))
    flat.uniform_(lo, 1 - lo, generator=generator(seed, "weights", device))
    flat = torch.special.ndtri(flat)
    out, at = {}, 0
    for (name, shape, kind), size in zip(params, sizes):
        leaf = flat[at:at + size].view(shape)
        at += size
        if kind == "fan_in":
            leaf.mul_(1.0 / math.sqrt(math.prod(shape[1:])))
        elif kind == "fan_in_transposed":
            leaf.mul_(1.0 / math.sqrt(shape[0] * math.prod(shape[2:])))
        elif kind == "pos":
            leaf.mul_(0.02)
        else:
            leaf.fill_({"zeros": 0.0, "ones": 1.0, "gamma": 1e-5}[kind])
    flat = flat.to(dtype)
    at = 0
    for (name, shape, _), size in zip(params, sizes):
        out[name] = flat[at:at + size].view(shape)
        at += size
    return out


def choice(seed: int, n: int, k: int, device="cpu") -> torch.Tensor:
    """``k`` distinct indices below ``n`` drawn from the seed."""
    g = generator(seed, "choices", "cpu")
    return torch.randperm(n, generator=g)[:k].sort().values.to(device)

"""LPIPS perceptual distance. Counterpart: ``tpugs/train/lpips.py``.

The canonical ``lpips`` v0.1 structure: images shifted and scaled, run
through an AlexNet or VGG16 conv trunk, each tapped feature map
unit-normalised over channels, squared differences weighted by the 1x1
"lin" layer, averaged over space and summed over taps.

Parameters are a dict of numpy arrays (``"net"`` plus ``conv{i}_w`` OIHW,
``conv{i}_b``, ``lin{t}_w``), the same tree as tpugs': ``load_lpips_params``
converts torchvision / lpips state dicts, ``load_lpips_file`` reads a
``.pth`` (``torch.load``) or an ``.npz`` of the converted tree, and
``random_lpips_params`` draws synthetic weights with tpugs' numpy draws.
``lpips_distance`` runs on ``device``; ``params_to`` moves a tree there once
so that repeated calls do not copy it. The convolutions run in full f32:
cuDNN's TF32 is switched off around them, as for SSIM.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F

from tpugs_torch.core.device import DeviceLike, resolve_device

# (out_channels, kernel, stride, padding) of torchvision's alexnet.features
_ALEX_CONVS = [(64, 11, 4, 2), (192, 5, 1, 2), (384, 3, 1, 1), (256, 3, 1, 1), (256, 3, 1, 1)]
_ALEX_FEATURE_IDX = [0, 3, 6, 8, 10]
_ALEX_POOL_BEFORE = {1, 2}  # 3x3 stride-2 max pool before these convs

_VGG_CHANNELS = [64, 64, 128, 128, 256, 256, 256, 512, 512, 512, 512, 512, 512]
_VGG_FEATURE_IDX = [0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28]
_VGG_POOL_BEFORE = {2, 4, 7, 10}  # 2x2 stride-2 max pool before these convs
_VGG_TAPS = [1, 3, 6, 9, 12]

# lpips v0.1 ScalingLayer
_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)


def _conv(x, params, i, stride, padding):
    return F.conv2d(x, params[f"conv{i}_w"], params[f"conv{i}_b"], stride=stride,
                    padding=padding)


def _alex_features(params, x) -> List[torch.Tensor]:
    taps = []
    for i, (_, _, stride, pad) in enumerate(_ALEX_CONVS):
        if i in _ALEX_POOL_BEFORE:
            x = F.max_pool2d(x, 3, 2)
        x = torch.relu(_conv(x, params, i, stride, pad))
        taps.append(x)
    return taps


def _vgg_features(params, x) -> List[torch.Tensor]:
    taps = []
    for i in range(len(_VGG_CHANNELS)):
        if i in _VGG_POOL_BEFORE:
            x = F.max_pool2d(x, 2, 2)
        x = torch.relu(_conv(x, params, i, 1, 1))
        if i in _VGG_TAPS:
            taps.append(x)
    return taps


def _normalize_channels(x, eps=1e-10):
    return x / (torch.sqrt(torch.sum(x * x, dim=1, keepdim=True)) + eps)


def params_to(params: Dict, device: DeviceLike = "cuda") -> Dict:
    """The tree with every array as a float32 tensor on ``device``."""
    dev = resolve_device(device)
    return {k: v if k == "net" else torch.as_tensor(np.asarray(v) if not torch.is_tensor(v)
                                                    else v, dtype=torch.float32).to(dev)
            for k, v in params.items()}


def lpips_distance(params: Dict, img0, img1, device: DeviceLike = "cuda") -> torch.Tensor:
    """LPIPS(img0, img1) for (H, W, 3) images in [0, 1], a 0-d tensor on
    ``device``."""
    dev = resolve_device(device)
    p = params_to(params, dev)
    extract = _alex_features if p["net"] == "alex" else _vgg_features
    shift = torch.tensor(_SHIFT, device=dev)[:, None, None]
    scale = torch.tensor(_SCALE, device=dev)[:, None, None]

    def prep(im):
        im = torch.as_tensor(im, dtype=torch.float32).to(dev).permute(2, 0, 1)
        return ((im * 2.0 - 1.0 - shift) / scale)[None]

    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        f0 = extract(p, prep(img0))
        f1 = extract(p, prep(img1))
    total = torch.zeros((), device=dev)
    for t, (a, b) in enumerate(zip(f0, f1)):
        d = (_normalize_channels(a) - _normalize_channels(b)) ** 2
        total = total + torch.mean(torch.sum(d * p[f"lin{t}_w"][None, :, None, None], dim=1))
    return total


def load_lpips_params(backbone_state: Dict[str, np.ndarray], lin_state: Dict[str, np.ndarray],
                      net: str = "alex") -> Dict:
    """torchvision ``features.{idx}.weight/bias`` (OIHW) and the lpips head
    ``lin{t}.model.1.weight`` (1, C, 1, 1) -> the parameter tree; negative
    lin weights clip to 0."""
    idxs = _ALEX_FEATURE_IDX if net == "alex" else _VGG_FEATURE_IDX
    params: Dict = {"net": net}
    for i, fi in enumerate(idxs):
        params[f"conv{i}_w"] = np.asarray(backbone_state[f"features.{fi}.weight"], np.float32)
        params[f"conv{i}_b"] = np.asarray(backbone_state[f"features.{fi}.bias"], np.float32)
    for t in range(5):
        w = np.asarray(lin_state[f"lin{t}.model.1.weight"], np.float32).reshape(-1)
        params[f"lin{t}_w"] = np.maximum(w, 0.0)
    return params


def load_lpips_file(path: str, net: str = "alex") -> Dict:
    """A torch ``.pt``/``.pth`` holding both the trunk's ``features.*`` keys
    and the ``lin*`` head keys, or an ``.npz`` of the converted tree."""
    if path.endswith(".npz"):
        with np.load(path) as f:
            data = dict(f)
        out: Dict = {"net": str(data.pop("net")) if "net" in data else net}
        out.update({k: np.asarray(v) for k, v in data.items()})
        return out
    sd = torch.load(path, map_location="cpu", weights_only=True)
    sd = {k: v.numpy() for k, v in sd.items()}
    return load_lpips_params({k: v for k, v in sd.items() if k.startswith("features.")},
                             {k: v for k, v in sd.items() if k.startswith("lin")}, net)


def random_lpips_params(net: str = "alex", seed: int = 0) -> Dict:
    """Synthetic weights of the production shapes, tpugs' numpy draws."""
    rng = np.random.default_rng(seed)
    if net == "alex":
        chans = [c for c, *_ in _ALEX_CONVS]
        kernels = [k for _, k, *_ in _ALEX_CONVS]
        tap_chans = chans
    else:
        chans = _VGG_CHANNELS
        kernels = [3] * len(chans)
        tap_chans = [chans[i] for i in _VGG_TAPS]
    ins = [3] + chans[:-1]
    params: Dict = {"net": net}
    for i, (ci, co, k) in enumerate(zip(ins, chans, kernels)):
        params[f"conv{i}_w"] = rng.normal(0, 0.05, (co, ci, k, k)).astype(np.float32)
        params[f"conv{i}_b"] = np.zeros(co, np.float32)
    for t, c in enumerate(tap_chans):
        params[f"lin{t}_w"] = np.abs(rng.normal(0, 1, c)).astype(np.float32) / c
    return params

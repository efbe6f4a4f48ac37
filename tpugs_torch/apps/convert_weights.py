"""One-command weight conversion and self-check report. Counterpart:
``scripts/convert_weights.py``.

Given the public checkpoint files the reference uses
(``lseg_minimal_e200.ckpt``, which also holds the CLIP text tower; a
DINOv2 ViT-L/14-reg state dict), for each tower:

1. read it through the strict loaders of ``encoders/convert.py``
   (``load_lseg_state_dict``, ``load_clip_text_state_dict``,
   ``load_dino_state_dict``) into the module, whose
   ``load_state_dict(strict=True)`` raises on a missing or an unknown key
   before anything is written;
2. save the loaded state dict beside the report (``<tower>_state_dict.pt``:
   the port's converted form is the module's own state dict, where tpugs
   saves Flax ``.npz`` files), recording its tensors and parameters;
3. run the self-check forward on tpugs' probe (``default_rng(0)`` uniform
   (480, 480, 3) for LSeg, (224, 224, 3) for DINOv2; the text tower on two
   prompts, only with ``--bpe-path``) and report the output's shape,
   finiteness and statistics;
4. with ``--reference-dir``, run the parity forward of a lang-seg or
   dinov2 checkout where one is importable, else say so in the report.
   LSeg's is set against the self-check's output. DINOv2's compares the
   reference's ``x_norm_patchtokens`` with the port's own
   ``VisionTransformer``'s normalised patch tokens, both of the 224-px
   probe as it is (no resize, no input normalisation), on the same 16 x
   16 grid: the self-check's ``DinoEncoder`` output is another thing, the
   probe resized to 896 px and its 64 x 64 grid resized back to 224 x 224
   (tpugs' script set the two against each other, and its parity could
   only raise);

and write ``convert_report.json`` with tpugs' keys. The towers run where
``--device`` says, the card by default (tpugs forces the CPU). On the
command line:

    python -m tpugs_torch.apps.convert_weights --lseg-ckpt lseg_minimal_e200.ckpt \\
        --bpe-path bpe_simple_vocab_16e6.txt.gz --dino-ckpt dinov2_vitl14_reg.pth \\
        --out-dir /tmp/weights [--reference-dir /path/to/lang-seg] [--device cpu]

``main(argv)`` returns the report and each self-check's output tensor.
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import sys

import numpy as np
import torch

from tpugs_torch.encoders.clip_text import CLIPTextTower, SimpleTokenizer, tokenize
from tpugs_torch.encoders.convert import (
    load_clip_text_state_dict,
    load_dino_state_dict,
    load_lseg_state_dict,
    read_state_dict,
)
from tpugs_torch.encoders.dino import DinoEncoder
from tpugs_torch.encoders.lseg import LSegEncoder, LSegNet
from tpugs_torch.encoders.vit import DINOV2_VIT_L14_REG, VisionTransformer, patch_tokens

TEXT_PROBE = ["table", "a photo of a vase"]


def _save_state_dict(sd, path) -> dict:
    torch.save(sd, path)
    return {"tensors": len(sd), "parameters": int(sum(v.numel() for v in sd.values()))}


def _stats(x) -> dict:
    x = torch.as_tensor(x).detach().double().cpu()
    return {
        "shape": list(x.shape),
        "finite": bool(torch.isfinite(x).all()),
        "mean": float(x.mean()),
        "std": float(x.std(unbiased=False)),
        "absmax": float(x.abs().max()),
    }


def _parity(ours, theirs) -> dict:
    a = torch.as_tensor(ours).detach().double().cpu()
    b = torch.as_tensor(theirs).detach().double().cpu()
    if a.shape != b.shape:
        raise ValueError(f"the parity compares like shapes, got {tuple(a.shape)} against "
                         f"{tuple(b.shape)}")
    a, b = a.ravel(), b.ravel()
    return {
        "max_abs_err": float((a - b).abs().max()),
        "rel_err": float((a - b).abs().max() / (b.abs().max() + 1e-30)),
        "cosine": float((a @ b) / (a.norm() * b.norm() + 1e-30)),
    }


def _probe(size: int, dev: torch.device) -> torch.Tensor:
    rng = np.random.default_rng(0)
    return torch.from_numpy(rng.uniform(0, 1, (size, size, 3)).astype(np.float32)).to(dev)


def convert_lseg(ckpt, out_dir, reference_dir, report, dev):
    sd = load_lseg_state_dict(ckpt)
    net = LSegNet(device=dev)
    net.load_state_dict(sd)
    meta = _save_state_dict(sd, os.path.join(out_dir, "lseg_state_dict.pt"))
    probe = _probe(480, dev)
    feats = LSegEncoder.from_net(net)(probe)
    entry = {"converted": meta, "self_check": _stats(feats)}
    ref = _torch_lseg_forward(ckpt, probe, reference_dir)
    entry["parity_vs_torch"] = _parity(feats, ref) if ref is not None else (
        "torch LSeg implementation not importable — pass --reference-dir with a "
        "lang-seg/lseg_minimal checkout")
    report["lseg"] = entry
    return feats


def _reference(reference_dir, module, name):
    """``module.name`` of a reference checkout, with ``reference_dir`` on
    ``sys.path`` only for the import; None where it is not importable."""
    saved = list(sys.path)
    if reference_dir:
        sys.path.insert(0, reference_dir)
    try:
        return getattr(importlib.import_module(module), name)
    except ImportError:
        return None
    finally:
        sys.path[:] = saved


def _torch_lseg_forward(ckpt, probe, reference_dir):
    """The public lseg_minimal forward (reference ``backproject.py:102-113``)
    where its package is importable; None otherwise."""
    RefNet = _reference(reference_dir, "lseg", "LSegNet")  # the package the reference imports
    if RefNet is None:
        return None
    net = RefNet(backbone="clip_vitl16_384", features=256, crop_size=480, arch_option=0,
                 block_depth=0, activation="lrelu")
    net.load_state_dict(read_state_dict(ckpt), strict=True)
    net = net.to(probe.device).eval()
    with torch.no_grad():
        out = net.forward(probe.permute(2, 0, 1)[None])
    return out[0].permute(1, 2, 0)


def convert_clip_text(ckpt, bpe_path, out_dir, report, dev):
    sd = load_clip_text_state_dict(ckpt)
    tower = CLIPTextTower(device=dev)
    tower.load_state_dict(sd)
    meta = _save_state_dict(sd, os.path.join(out_dir, "clip_text_state_dict.pt"))
    entry, emb = {"converted": meta}, None
    if bpe_path:
        tokens = torch.from_numpy(tokenize(SimpleTokenizer(bpe_path), TEXT_PROBE)).to(dev)
        with torch.no_grad():
            emb = tower.eval()(tokens.long())
        entry["self_check"] = _stats(emb)
    else:
        entry["self_check"] = "pass --bpe-path to run the tokenizer probe"
    report["clip_text"] = entry
    return emb


def convert_dino(ckpt, out_dir, reference_dir, report, dev):
    sd = load_dino_state_dict(ckpt)
    vit = VisionTransformer(DINOV2_VIT_L14_REG, act="gelu", device=dev)
    vit.load_state_dict(sd)
    meta = _save_state_dict(sd, os.path.join(out_dir, "dino_state_dict.pt"))
    probe = _probe(224, dev)
    feats = DinoEncoder.from_vit(vit)(probe)
    entry = {"converted": meta, "self_check": _stats(feats)}
    ref = _torch_dino_forward(ckpt, probe, reference_dir)
    entry["parity_vs_torch"] = _parity(_dino_patch_grid(vit, probe), ref) if ref is not None else (
        "torch DINOv2 not importable — pass --reference-dir with a "
        "facebookresearch/dinov2 checkout")
    report["dino"] = entry
    return feats


def _dino_patch_grid(vit, probe):
    """The port's normalised patch tokens of ``probe`` (H, W, 3) as it is,
    without resize or input normalisation: (gh, gw, D), as
    ``_torch_dino_forward`` gives the reference's."""
    with torch.no_grad():
        out = vit.eval()(probe.permute(2, 0, 1)[None])
    gh, gw = out["grid"]
    return patch_tokens(out)[0].reshape(gh, gw, -1)


def _torch_dino_forward(ckpt, probe, reference_dir):
    """The public dinov2_vitl14 patch features (reference
    ``backproject.py:176-187, 206-224``) where dinov2 is importable; None
    otherwise."""
    vit_large = _reference(reference_dir, "dinov2.models.vision_transformer", "vit_large")
    if vit_large is None:
        return None
    net = vit_large(patch_size=14, img_size=518, init_values=1.0, block_chunks=0)
    net.load_state_dict(read_state_dict(ckpt), strict=True)
    net = net.to(probe.device).eval()
    with torch.no_grad():
        out = net.forward_features(probe.permute(2, 0, 1)[None])["x_norm_patchtokens"]
    g = int(round(out.shape[1] ** 0.5))
    return out[0].reshape(g, g, -1)


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--lseg-ckpt", default="",
                    help="lseg_minimal_e200.ckpt (also holds the CLIP text tower)")
    ap.add_argument("--clip-text-ckpt", default="",
                    help="checkpoint for the text tower (defaults to --lseg-ckpt)")
    ap.add_argument("--bpe-path", default="",
                    help="CLIP BPE merges file (bpe_simple_vocab_16e6)")
    ap.add_argument("--dino-ckpt", default="", help="dinov2_vitl14 state dict")
    ap.add_argument("--reference-dir", default="",
                    help="path to a torch lang-seg / dinov2 checkout for the parity forward")
    ap.add_argument("--out-dir", default="./converted_weights")
    ap.add_argument("--device", default="cuda", help='"cuda" or "cpu"')
    return ap


def main(argv=None):
    from tpugs_torch.core.device import resolve_device

    ap = _parser()
    args = ap.parse_args(argv)
    if not (args.lseg_ckpt or args.dino_ckpt or args.clip_text_ckpt):
        ap.error("nothing to convert: pass --lseg-ckpt / --dino-ckpt / --clip-text-ckpt")
    dev = resolve_device(args.device)

    os.makedirs(args.out_dir, exist_ok=True)
    report, outputs = {}, {}
    # the LSeg file also holds the text tower: read it once for both
    lseg = read_state_dict(args.lseg_ckpt) if args.lseg_ckpt else None
    if lseg is not None:
        outputs["lseg"] = convert_lseg(lseg, args.out_dir, args.reference_dir, report, dev)
    text_ckpt = args.clip_text_ckpt or lseg
    if text_ckpt is not None:
        outputs["clip_text"] = convert_clip_text(text_ckpt, args.bpe_path, args.out_dir,
                                                 report, dev)
    if args.dino_ckpt:
        outputs["dino"] = convert_dino(args.dino_ckpt, args.out_dir, args.reference_dir,
                                       report, dev)

    path = os.path.join(args.out_dir, "convert_report.json")
    with open(path, "w") as fh:
        json.dump(report, fh, indent=2)
    print(json.dumps(report, indent=2))
    print("report:", path)
    return report, outputs


if __name__ == "__main__":
    main()

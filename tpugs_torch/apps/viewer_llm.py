"""Language-driven scene editor. Counterpart: ``tpugs/apps/viewer_llm.py``.

Natural language maps to one JSON command schema::

    {"command": "change_view" | "segment" | "reset_segmentation" |
                "change_color" | "reset_color" | "exit" | "unknown",
     ...args}

``Assistant(llm=...)`` takes any callable str -> str (``llm_backend.py``:
a local transformers checkpoint, a tiny random GPT-2, or nothing); what it
cannot parse falls back to a grammar parser over the same command set,
which also serves with no model. ``SceneEditor.apply`` edits the scene on
its device: ``segment`` hides the Gaussians outside the query mask
(``query/masks.py::segment_by_opacity``), ``change_color`` greys then
tints the masked DC colour (``recolor``), and the resets restore the
original tensors. As in the reference, ``main`` builds the editor with no
text encoder and no exemplar lookup, so "segment" and "change_color"
answer ``no-query-backend`` there; the headless ``SceneEditor`` takes
either. On the command line (a cv2 window; type after a backtick)::

    python -m tpugs_torch.apps.viewer_llm --data-dir DATA --checkpoint CKPT \\
        --results-dir OUT --feature linear:8 [--llm tiny-random] [--device cpu]
"""

from __future__ import annotations

import json
import re
from typing import Callable, Optional

import numpy as np
import torch

from tpugs_torch.core.device import resolve_device
from tpugs_torch.core.scene import GaussianScene

COLOR_TO_RGB = {
    "red": (1.0, 0.0, 0.0),
    "green": (0.0, 1.0, 0.0),
    "blue": (0.0, 0.0, 1.0),
    "yellow": (1.0, 1.0, 0.0),
    "cyan": (0.0, 1.0, 1.0),
    "magenta": (1.0, 0.0, 1.0),
    "white": (1.0, 1.0, 1.0),
    "black": (0.0, 0.0, 0.0),
    "orange": (1.0, 0.5, 0.0),
    "purple": (0.5, 0.0, 0.5),
    "pink": (1.0, 0.75, 0.8),
    "gray": (0.5, 0.5, 0.5),
}

VIEWS = ("top", "front", "right", "left", "back", "bottom")

FEW_SHOT_PROMPT = """You convert user requests about a 3D scene into JSON.
Commands: change_view(view), segment(object), reset_segmentation,
change_color(object, color), reset_color, exit, unknown.
Examples:
user: show me the top view -> {"command": "change_view", "view": "top"}
user: segment out the table -> {"command": "segment", "object": "table"}
user: make the vase red -> {"command": "change_color", "object": "vase", "color": "red"}
user: undo the segmentation -> {"command": "reset_segmentation"}
user: quit -> {"command": "exit"}
Answer with JSON only.
user: {query} ->"""


def parse_rule_based(text: str) -> dict:
    """The grammar parser over the command set."""
    t = text.lower().strip()
    if re.search(r"\b(exit|quit|bye|close)\b", t):
        return {"command": "exit"}
    if re.search(r"\b(reset|undo|restore).*(color|colour)", t):
        return {"command": "reset_color"}
    if re.search(r"\b(reset|undo|restore|clear)", t) and re.search(r"segment", t):
        return {"command": "reset_segmentation"}
    if re.search(r"\b(reset|undo|restore|show all|original)\b", t):
        return {"command": "reset_segmentation"}
    m = re.search(r"\b(top|front|right|left|back|bottom)\b.*view", t) or re.search(
        r"view.*\b(top|front|right|left|back|bottom)\b", t
    ) or re.search(r"\b(top|front|right|left|back|bottom)\b", t)
    if m and re.search(r"view|look|show|camera", t):
        return {"command": "change_view", "view": m.group(1)}
    for color in COLOR_TO_RGB:
        if re.search(rf"\b{color}\b", t) and re.search(r"color|colour|paint|make|turn", t):
            obj = _extract_object(t, exclude=color)
            return {"command": "change_color", "object": obj, "color": color}
    if re.search(r"segment|extract|select|isolate|show only|highlight", t):
        return {"command": "segment", "object": _extract_object(t)}
    return {"command": "unknown"}


def _extract_object(t: str, exclude: str = "") -> str:
    stop = {
        "the", "a", "an", "please", "out", "segment", "extract", "select",
        "isolate", "only", "show", "highlight", "make", "turn", "paint",
        "color", "colour", "of", "to", "in", "it", exclude,
    }
    words = [w for w in re.findall(r"[a-z]+", t) if w not in stop]
    return " ".join(words[-2:]) if words else "object"


class Assistant:
    """Natural language -> command dict: the model's first JSON object with
    a "command", else the grammar parser's answer."""

    def __init__(self, llm: Optional[Callable[[str], str]] = None):
        self.llm = llm

    def ask(self, query: str) -> dict:
        if self.llm is not None:
            raw = self.llm(FEW_SHOT_PROMPT.replace("{query}", query))
            try:
                start = raw.index("{")
                end = raw.rindex("}") + 1
                cmd = json.loads(raw[start:end])
                if isinstance(cmd, dict) and "command" in cmd:
                    return cmd
            except (ValueError, json.JSONDecodeError):
                pass
        return parse_rule_based(query)


class SceneEditor:
    """Applies commands to a scene and its (N, D) field, on the scene's
    device."""

    def __init__(
        self,
        scene: GaussianScene,
        features,
        text_encoder: Optional[Callable] = None,  # prompts -> (P, D)
        exemplar_lookup: Optional[Callable] = None,  # name -> (D,) feature or None
    ):
        self.original = scene
        self.scene = scene
        self.features = torch.as_tensor(features, dtype=torch.float32,
                                        device=scene.means.device)
        self.text_encoder = text_encoder
        self.exemplar_lookup = exemplar_lookup
        self.view: Optional[str] = None
        self.last_mask: Optional[torch.Tensor] = None

    def _query_mask(self, obj: str) -> Optional[torch.Tensor]:
        from tpugs_torch.query.text import get_mask3d

        if self.text_encoder is not None:
            q = torch.as_tensor(self.text_encoder([obj, "other"]), dtype=torch.float32)
            pos, neg = q[:1], q[1:]
        elif self.exemplar_lookup is not None:
            f = self.exemplar_lookup(obj)
            if f is None:
                return None
            pos = torch.as_tensor(np.asarray(f), dtype=torch.float32)[None]
            neg = -pos
        else:
            return None
        mask, _ = get_mask3d(self.features, pos, neg)
        return mask

    def apply(self, cmd: dict) -> dict:
        from tpugs_torch.query.masks import recolor, segment_by_opacity

        c = cmd.get("command", "unknown")
        if c == "segment":
            mask = self._query_mask(cmd.get("object", ""))
            if mask is None:
                return {"status": "no-query-backend"}
            self.last_mask = mask
            self.scene = segment_by_opacity(self.scene, mask)
            return {"status": "ok", "selected": int(mask.sum())}
        if c == "reset_segmentation":
            self.scene = self.scene.replace(logit_opacities=self.original.logit_opacities)
            return {"status": "ok"}
        if c == "change_color":
            color = COLOR_TO_RGB.get(cmd.get("color", ""), None)
            if color is None:
                return {"status": "unknown-color"}
            mask = self._query_mask(cmd.get("object", ""))
            if mask is None:
                return {"status": "no-query-backend"}
            self.scene = recolor(self.scene, mask, color)
            return {"status": "ok", "recolored": int(mask.sum())}
        if c == "reset_color":
            self.scene = self.scene.replace(sh0=self.original.sh0, shN=self.original.shN)
            return {"status": "ok"}
        if c == "change_view":
            self.view = cmd.get("view", "front")
            return {"status": "ok", "view": self.view}
        if c == "exit":
            return {"status": "exit"}
        return {"status": "unknown"}


def main(
    data_dir: str = "./data/garden",
    checkpoint: str = "./data/garden/ckpts/ckpt_29999_rank0.pt",
    results_dir: str = "./results/garden",
    format: str = "gsplat",
    data_factor: int = 4,
    feature: str = "lseg",
    llm: str = "",  # "hf:<path>" | "tiny-random" | "" (grammar parser)
    device: str = "cuda",
):  # pragma: no cover - interactive
    import os

    import cv2

    from tpugs_torch.apps.llm_backend import make_backend
    from tpugs_torch.apps.viewer import Viewer
    from tpugs_torch.io.checkpoints import load_checkpoint

    dev = resolve_device(device)
    scene, cams, _ = load_checkpoint(checkpoint, data_dir, format, data_factor, dev)
    feats = np.load(os.path.join(results_dir, f"features_{feature}.npz"))["features"]
    assistant = Assistant(llm=make_backend(llm, device=dev))
    editor = SceneEditor(scene, feats)
    viewer = Viewer(scene, cams.Ks[0].cpu().numpy(), cams.width, cams.height,
                    viewmats=cams.viewmats.cpu().numpy(), device=dev)

    typed = ""
    prompt_mode = False
    win = "tpugs_torch viewer+llm"
    cv2.namedWindow(win, cv2.WINDOW_NORMAL)
    while True:
        viewer.scene = editor.scene
        frame = viewer.render()
        if prompt_mode:
            cv2.putText(np.ascontiguousarray(frame), "> " + typed, (10, 30),
                        cv2.FONT_HERSHEY_SIMPLEX, 0.8, (255, 255, 0), 2)
        cv2.imshow(win, frame[..., ::-1])
        key = cv2.waitKeyEx(30)
        if key < 0:
            continue
        ch = chr(key & 0xFF)
        if prompt_mode:
            if ch in ("\r", "\n"):
                result = editor.apply(assistant.ask(typed))
                if result.get("status") == "exit":
                    break
                if editor.view in ("top", "front", "right"):
                    viewer.state.set_canonical(editor.view, viewer.frame)
                typed, prompt_mode = "", False
            elif ch == "\x08":
                typed = typed[:-1]
            else:
                typed += ch
        elif ch == "`":
            prompt_mode = True
        elif not viewer.handle_key(ch):
            break
    cv2.destroyAllWindows()


if __name__ == "__main__":
    from tpugs_torch.utils.cli import cli

    cli(main)

"""The lift path. A job is what ``apps/backproject.py`` runs for a capture:
``tpugs_torch.lift.batch.backproject_views`` over every view of the orbit
in one call, the encoder at batch 1 inside it, then ``normalize_field``.
Every job lifts the same capture from the same inputs.

The window keeps little for the check, all of it gathered on the card: of
each job, ``num``, ``den`` and the field at a seeded sample of Gaussians,
and the encoder's features at a seeded sample of pixels of every view
(``Probe``). After the window the float32 reference
(``reference/lift.py``) lifts the same capture at those Gaussians and
pixels, and every job is held to it: the features, ``num``, ``den``, and
the field against the reference's normalisation of its own sums.

A traced run profiles the same call over the few views ``trace_views``,
so that the trace stays small.
"""

from __future__ import annotations

import sys
from typing import Dict, List

import torch

from benchmark import harness, inputs
from benchmark.counts import rooflines
from benchmark.reference import lift as ref_lift
from benchmark.reference import vit as ref_vit
from benchmark.reference.precision import BELOW, identity

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
KERNELS = {"adjoint": r"\badjoint_kernel\b", "reduce": r"\breduce_kernel\b"}
NUMBERS = ("features_rel", "num_rel", "den_rel", "field_rel")


def build_encoder(config: dict, weights: Dict[str, torch.Tensor], device):
    """The program's encoder for ``config`` with the given weights: the
    module built on the meta device, moved to ``device`` in the served
    dtype, the weights copied in (every name must match)."""
    dtype = DTYPES[config["dtype"]]
    from tpugs_torch.encoders.vit import ViTConfig, VisionTransformer

    vit_cfg = ViTConfig(**config["vit"])
    if config["encoder"] == "lseg":
        from tpugs_torch.encoders.lseg import LSegEncoder, LSegNet

        net = LSegNet(features=config["features"], out_dim=config["out_dim"], vit_cfg=vit_cfg,
                      hooks=tuple(config["hooks"]),
                      layer_channels=tuple(config["layer_channels"]), device="meta")
        net = net.to(dtype).to_empty(device=device)
        net.load_state_dict(weights, strict=True)
        return LSegEncoder.from_net(net, crop_size=config["crop_size"], dtype=dtype)
    from tpugs_torch.encoders.dino import DinoEncoder

    vit = VisionTransformer(vit_cfg, act="gelu", device="meta").to(dtype).to_empty(device=device)
    vit.load_state_dict(weights, strict=True)
    return DinoEncoder.from_vit(vit, image_size=config["image_size"], dtype=dtype)


class Probe:
    """The program's encoder, passed to ``backproject_views`` in its place:
    it calls the encoder and, while ``active``, keeps the features of a
    fixed sample of pixels of each view."""

    def __init__(self, encoder, pixels: torch.Tensor):
        self.encoder = encoder
        self.feature_dim = encoder.feature_dim
        self.pixelwise = False
        self.pixels = pixels
        self.active = False
        self.kept: List[torch.Tensor] = []

    def __call__(self, image: torch.Tensor) -> torch.Tensor:
        out = self.encoder(image)
        if self.active:
            self.kept.append(out.reshape(-1, out.shape[-1])[self.pixels])
        return out


class Lift:
    KERNELS = KERNELS

    def __init__(self, cell: dict, config: dict, seed: int, device, stages=None):
        self.cell, self.config, self.seed, self.device = cell, config, seed, device
        self.scene_spec = config["scene"]
        self.stages = stages
        self.t = cell["traffic"]
        self.n = self.t["n_gaussians"]
        self.views = list(range(self.scene_spec["n_views"]))
        self.jobs: List[dict] = []

    # ---------------------------------------------------------- program
    def setup(self) -> None:
        from tpugs_torch.core.scene import GaussianScene

        dev, s = self.device, self.scene_spec
        clock = harness.SetupClock("lift")
        self.scene = GaussianScene(**inputs.scene(s, self.n, self.seed, dev))
        self.viewmats, self.Ks = inputs.orbit(s, dev)
        clock.lap("scene and cameras")
        w = inputs.weights(ref_vit.PARAMS[self.config["encoder"]](self.config), self.seed, dev,
                           DTYPES[self.config["dtype"]])
        clock.lap("weights")
        encoder = build_encoder(self.config, w, dev)
        del w
        clock.lap("encoder")
        self._samples()
        self.probe = Probe(encoder, self.pixels)
        # warm-up: the same call over a few views round the orbit, which
        # loads the kernels and settles the libraries' and the allocator's
        # choices for these shapes
        self._lift(self.t["warm_views"], record=False)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        clock.lap("warm-up views (the kernels' library loaded or built)")

    def _lift(self, views: List[int], record: bool = True):
        from tpugs_torch.lift.batch import backproject_views

        idx = torch.tensor(views, device=self.device)
        return backproject_views(
            self.scene, self.viewmats[idx], self.Ks[idx], self.scene_spec["width"],
            self.scene_spec["height"], self.probe, tile_size=self.t["tile_size"],
            contrib_dtype=DTYPES[self.t["rows_dtype"]], trans_eps=self.t["trans_eps"],
            device=self.device, on_stage=self.stages.mark if (record and self.stages) else None,
            reduce_engine=self.t["reduce_engine"])

    def job(self) -> int:
        """The capture lifted once; returns the views lifted."""
        from tpugs_torch.lift.batch import normalize_field

        if self.stages:
            self.stages.mark("job")
        self.probe.active = True
        num, den = self._lift(self.views)
        field = normalize_field(num, den)
        self.probe.active = False
        self.jobs.append({"num": num[self.rows], "den": den[self.rows],
                          "field": field[self.rows], "features": torch.stack(self.probe.kept)})
        self.probe.kept = []
        del num, den, field
        if self.device.type == "cuda":
            torch.cuda.synchronize()
        return len(self.views)

    def traced_job(self) -> List[int]:
        """The same call over ``trace_views``, unchecked; returns them."""
        views = self.t["trace_views"]
        self._lift(views, record=False)
        if self.device.type == "cuda":
            torch.cuda.synchronize()
        return views

    def release(self) -> None:
        for name in ("scene", "probe", "viewmats", "Ks"):
            setattr(self, name, None)

    # ---------------------------------------------------------- checking
    def reference_inputs(self):
        dev, s = self.device, self.scene_spec
        scene = inputs.scene(s, self.n, self.seed, dev)
        viewmats, Ks = inputs.orbit(s, dev)
        w = inputs.weights(ref_vit.PARAMS[self.config["encoder"]](self.config), self.seed, dev,
                           DTYPES[self.config["dtype"]])
        return scene, viewmats, Ks, w

    def reference(self, control: bool = False, n_views: int = 0) -> List[dict]:
        """The float32 reference of the capture (its first ``n_views``
        views, if given) at the sampled Gaussians and pixels; with
        ``control`` also, from the same walk, the reference one precision
        below the configuration's (encoder, rows, sums)."""
        scene, viewmats, Ks, w = self.reference_inputs()
        s, cfg = self.scene_spec, self.config
        fn = ref_vit.FEATURES[cfg["encoder"]]
        variants = [ref_lift.Variant(lambda im: fn(w, cfg, im, identity))]
        if control:
            variants.append(ref_lift.Variant(lambda im: fn(w, cfg, im, BELOW[cfg["dtype"]]),
                                             BELOW[self.t["rows_dtype"]], BELOW["float32"]))
        n = n_views or viewmats.shape[0]
        return ref_lift.capture(scene, viewmats[:n], Ks[:n], s["width"], s["height"],
                                self.t["tile_size"], self.t["trans_eps"], s["sh_degree"],
                                self.rows, self.pixels, variants)

    @staticmethod
    def numbers(got: dict, ref: dict) -> Dict[str, float]:
        """Relative Frobenius gaps: the features at the sampled pixels,
        ``num`` and ``den`` at the sampled Gaussians, and the field with
        each Gaussian's row weighted by the weight the reference saw it
        with (its ``den``), as a render of the field weighs it: a Gaussian
        seen only past a tile's exit threshold has a unit row from a few
        weights that rounding can add or drop, which an unweighted gap
        counts in full (printed beside it, ``_look``)."""
        dev = ref["num"].device
        got = {k: v.to(dev) for k, v in got.items()}
        _look(got, ref)
        out = {k: _rel(got[k.split("_")[0]], ref[k.split("_")[0]]) for k in NUMBERS[:3]}
        out["field_rel"] = _rel(got["field"], ref["field"], ref["den"])
        return out

    def check(self) -> Dict[str, float]:
        """The numbers compared, after ``release``: each the worst over the
        window's jobs against the reference."""
        ref = self.reference()[0]
        per_job = [self.numbers(job, ref) for job in self.jobs]
        return {k: max(r[k] for r in per_job) for k in NUMBERS}

    def control_reading(self) -> Dict[str, float]:
        """The control in the program's place, held to the float32
        reference by the same numbers."""
        self._samples()
        ref, low = self.reference(control=True)
        return self.numbers(low, ref)

    def _samples(self) -> None:
        s = self.scene_spec
        self.rows = inputs.choice(self.seed, self.n, self.t["check_gaussians"], self.device)
        self.pixels = inputs.choice(self.seed + 1, s["width"] * s["height"],
                                    self.t["check_pixels"], self.device)

    def reference_time(self) -> None:
        """The reference of the first view at the cell's samples (sizing)."""
        self._samples()
        self.reference(n_views=1)

    # ---------------------------------------------------------- metrics
    def counts(self, views: List[int]) -> dict:
        scene, viewmats, Ks, _ = self.reference_inputs()
        s = self.scene_spec
        total: Dict[str, int] = {}
        for v in views:
            c = ref_lift.view_counts(scene, viewmats[v], Ks[v], s["width"], s["height"],
                                     self.t["tile_size"], self.t["trans_eps"])
            for k, x in c.items():
                total[k] = total.get(k, 0) + x
        D = self.config["out_dim"] if self.config["encoder"] == "lseg" else self.config["vit"]["width"]
        flops = ref_vit.network_flops(self.config, s["height"], s["width"]) * len(views)
        return {"pairs": total, "D": D, "units": len(views),
                "least_compute_s": rooflines.compute_s(flops, "bf16")
                + rooflines.kernel_compute_s(total, D),
                "kernels": {"adjoint": rooflines.adjoint(total, D),
                            "reduce": rooflines.reduce(total, D)}}


MISSING = 1e30  # the reading of an answer the program did not give


def _rel(a: torch.Tensor, b: torch.Tensor, row_weights=None) -> float:
    """||a - b|| / ||b||, with ``row_weights`` each row's squares weighted."""
    if a.shape != b.shape:
        return MISSING
    d2, b2 = ((a - b).float() ** 2), b.float() ** 2
    if row_weights is not None:
        w = torch.clamp(row_weights.float(), min=0.0).reshape(-1, *[1] * (b.dim() - 1))
        d2, b2 = d2 * w, b2 * w
    return float(torch.sqrt(d2.sum()) / torch.clamp(torch.sqrt(b2.sum()), min=1e-30))


def _look(got: dict, ref: dict) -> None:
    """Where the field's gap lies, on standard error: the unweighted gap,
    and each row's gap against its weight over the median seen weight."""
    if got["field"].shape != ref["field"].shape:
        return
    gap = torch.linalg.vector_norm(got["field"] - ref["field"], dim=-1)
    seen = ref["den"] > 0
    med = float(ref["den"][seen].median()) if seen.any() else 0.0
    heavy = ref["den"] >= med
    far = gap > 0.1
    print(f"field: unweighted gap {_rel(got['field'], ref['field'])!r}; rows seen {int(seen.sum())} "
          f"of {gap.shape[0]}, median weight {med!r}; worst row gap {float(gap.max())!r}, among "
          f"rows at or above the median weight {float(gap[heavy].max()) if heavy.any() else 0.0!r}; "
          f"{int(far.sum())} rows gap > 0.1, their largest weight "
          f"{float(ref['den'][far].max()) if far.any() else 0.0!r}", file=sys.stderr)


PATH = Lift

"""The encoder stack against tpugs on the CPU.

* ``encoders/resize.py`` against ``jax.image.resize`` for each method and
  direction the encoders use: 1e-6 on inputs in [0, 1];
* each ``tests/golden/*.npz`` case but ``lpips``: Flax params built as
  ``tests/test_golden.py`` builds them (PRNGKey 0-6), carried by
  ``tpugs_torch/convert.py``, the port's output against the committed
  golden at that file's tolerance (atol 1e-5 x max(1, |g|max), rtol 1e-5);
* seeded tiny public-layout state dicts (lang-seg, DINOv2, CLIP) loaded by
  tpugs' strict converters and by the port's loaders, with equal outputs
  (2e-5 of the output's scale); a missing and an unknown key raise, the
  families tpugs ignores do not;
* ``LSegEncoder.__call__`` / ``staged_apply`` and ``DinoEncoder.__call__``
  against tpugs' own methods on tiny networks (2e-5; staged bf16 output
  to within one bf16 rounding of the same f32 values);
* the Flax-like random init's moments, and the registry.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_convert_validation import (
    TINY_LSEG,
    TINY_VIT,
    make_dino_state_dict,
    make_lseg_state_dict,
)
from tests.test_golden import GOLDEN_DIR, _rng_array
from tpugs_torch import convert
from tpugs_torch.encoders.clip_text import CLIPTextTower
from tpugs_torch.encoders.convert import (
    load_clip_text_state_dict,
    load_dino_state_dict,
    load_lseg_state_dict,
)
from tpugs_torch.encoders.dino import DinoEncoder
from tpugs_torch.encoders.lseg import LSegEncoder, LSegHead, LSegNet, encode_text
from tpugs_torch.encoders.resize import resize
from tpugs_torch.encoders.vit import Block, VisionTransformer, ViTConfig, init_flax_like_

CPU = "cpu"


def _init(module, key, *args, **static):
    """``module.init`` under ``jax.jit`` (the same PRNG draws, compiled
    once instead of dispatched op by op); ``static`` keywords are bound."""
    return jax.jit(lambda k, *a: module.init(k, *a, **static))(jax.random.PRNGKey(key), *args)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _nchw(a):
    return _t(a).permute(0, 3, 1, 2)


def _nhwc(t):
    return t.permute(0, 2, 3, 1).detach().numpy()


# ------------------------------------------------------------ resize

RESIZE_CASES = {
    "bilinear down": ("bilinear", (37, 53), (16, 16)),
    "bilinear up": ("bilinear", (15, 15), (40, 52)),
    "cubic down": ("cubic", (21, 21), (9, 9)),
    "cubic up": ("cubic", (9, 9), (21, 21)),
    "nearest up": ("nearest", (8, 8), (21, 30)),
    "bilinear up and down": ("bilinear", (30, 30), (61, 20)),  # antialiased: one axis shrinks
}


@pytest.mark.parametrize("case", sorted(RESIZE_CASES))
def test_resize_matches_jax(case):
    method, (h, w), (H, W) = RESIZE_CASES[case]
    x = np.random.default_rng(7).uniform(0, 1, (2, h, w, 5)).astype(np.float32)
    ref = np.asarray(jax.jit(lambda a: jax.image.resize(a, (2, H, W, 5), method))(x))
    got = _nhwc(resize(_nchw(x), (H, W), method))
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=1e-6, rtol=0)


def test_resize_rejects_unknown_method():
    with pytest.raises(ValueError):
        resize(torch.zeros(1, 1, 4, 4), (8, 8), "lanczos3")


# ------------------------------------------------------------ golden


def _golden_vit_block():
    from tpugs.encoders.vit import Block as JBlock, ViTConfig as JViTConfig

    jcfg = JViTConfig(image_size=32, patch_size=16, width=64, layers=2, heads=4)
    x = _rng_array((1, 10, 64), seed=1)
    params = _init(JBlock(jcfg, "gelu"), 0, x)
    blk = Block(ViTConfig(**_fields(jcfg)), "gelu")
    blk.load_state_dict(convert.block_from_flax(_np_tree(params)["params"]))
    return {"out": blk(_t(x))}


def _fields(jcfg):
    return {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(ViTConfig)}


def _ls_point_one(params):
    return jax.tree_util.tree_map(
        lambda a: jnp.full_like(a, 0.1) if a.ndim == 1 and a.shape[0] == 64 else a, params)


def _golden_vit_block_dino():
    from tpugs.encoders.vit import Block as JBlock, ViTConfig as JViTConfig

    jcfg = JViTConfig(image_size=28, patch_size=14, width=64, layers=2, heads=4,
                      layer_norm_eps=1e-6, layer_scale=True)
    x = _rng_array((1, 9, 64), seed=2)
    params = _ls_point_one(_init(JBlock(jcfg, "gelu"), 1, x))
    blk = Block(ViTConfig(**_fields(jcfg)), "gelu")
    blk.load_state_dict(convert.block_from_flax(_np_tree(params)["params"]))
    return {"out": blk(_t(x))}


def _golden_vit_tiny():
    from tpugs.encoders.vit import ViTConfig as JViTConfig, VisionTransformer as JViT

    jcfg = JViTConfig(image_size=32, patch_size=16, width=64, layers=2, heads=4,
                      pre_norm=True)
    img = _rng_array((1, 32, 32, 3), seed=3, scale=0.5)
    img_big = _rng_array((1, 48, 48, 3), seed=4, scale=0.5)
    params = _init(JViT(jcfg), 2, img)
    vit = VisionTransformer(ViTConfig(**_fields(jcfg)), device=CPU)
    vit.load_state_dict(convert.vit_from_flax(_np_tree(params)))
    return {"final": vit(_nchw(img))["final"], "final_interp": vit(_nchw(img_big))["final"]}


def _golden_vit_tiny_dino():
    from tpugs.encoders.vit import ViTConfig as JViTConfig, VisionTransformer as JViT

    jcfg = JViTConfig(image_size=28, patch_size=14, width=64, layers=2, heads=4,
                      num_register_tokens=4, layer_norm_eps=1e-6, layer_scale=True,
                      pos_interp="cubic")
    img = _rng_array((1, 28, 28, 3), seed=5, scale=0.5)
    params = _ls_point_one(_init(JViT(jcfg), 3, img))
    vit = VisionTransformer(ViTConfig(**_fields(jcfg)), device=CPU)
    vit.load_state_dict(convert.dino_from_flax(_np_tree(params)))
    return {"final": vit(_nchw(img))["final"]}


def _golden_lseg_head():
    from tpugs.encoders.lseg import LSegHead as JHead

    kw = dict(features=32, out_dim=16, vit_width=64, layer_channels=(16, 32, 64, 64))
    levels = [_rng_array((1, 16, 64), seed=10 + i) for i in range(4)]
    cls = [_rng_array((1, 64), seed=20 + i) for i in range(4)]
    params = _init(JHead(**kw), 4, levels, cls, grid=(4, 4))
    head = LSegHead(**kw, device=CPU)
    head.load_state_dict(convert.lseg_head_from_flax(_np_tree(params)))
    out = head([_t(a) for a in levels], [_t(a) for a in cls], (4, 4))
    return {"out": out.permute(0, 2, 3, 1)}


def _golden_lseg_net():
    from tpugs.encoders.lseg import LSegNet as JNet
    from tpugs.encoders.vit import ViTConfig as JViTConfig

    jcfg = JViTConfig(image_size=32, patch_size=16, width=64, layers=4, heads=4)
    kw = dict(features=32, out_dim=16, hooks=(0, 1, 2, 3), layer_channels=(16, 32, 64, 64))
    img = _rng_array((1, 32, 32, 3), seed=6, scale=0.5)
    params = _init(JNet(vit_cfg=jcfg, **kw), 5, img)
    net = LSegNet(vit_cfg=ViTConfig(**_fields(jcfg)), **kw, device=CPU)
    net.load_state_dict(convert.lseg_from_flax(_np_tree(params)))
    return {"out": net(_nchw(img)).permute(0, 2, 3, 1)}


def _clip_tokens():
    rng = np.random.default_rng(30)
    tokens = np.zeros((2, 16), np.int32)
    for p in range(2):
        n = 5 + 3 * p
        tokens[p, 0] = 126
        tokens[p, 1:1 + n] = rng.integers(1, 126, n)
        tokens[p, 1 + n] = 127
    return tokens


TINY_TEXT = dict(vocab_size=128, context_length=16, width=32, heads=4, layers=2, embed_dim=24)


def _golden_clip_text():
    from tpugs.encoders.clip_text import CLIPTextTower as JTower

    tokens = _clip_tokens()
    params = _init(JTower(**TINY_TEXT), 6, jnp.asarray(tokens))
    tower = CLIPTextTower(**TINY_TEXT, device=CPU)
    tower.load_state_dict(convert.clip_text_from_flax(_np_tree(params)))
    return {"out": tower(torch.from_numpy(tokens).long())}


GOLDEN = {
    "vit_block": _golden_vit_block,
    "vit_block_dino": _golden_vit_block_dino,
    "vit_tiny": _golden_vit_tiny,
    "vit_tiny_dino": _golden_vit_tiny_dino,
    "lseg_head": _golden_lseg_head,
    "lseg_net": _golden_lseg_net,
    "clip_text": _golden_clip_text,
}


@pytest.mark.parametrize("name", sorted(GOLDEN))
def test_golden_case_through_the_port(name):
    golden = np.load(f"{GOLDEN_DIR}/{name}.npz")
    with torch.no_grad():
        got = {k: v.numpy() for k, v in GOLDEN[name]().items()}
    assert set(got) == set(golden.files)
    for k in got:
        scale = max(1.0, float(np.abs(golden[k]).max()))
        np.testing.assert_allclose(got[k], golden[k], atol=1e-5 * scale, rtol=1e-5,
                                   err_msg=f"{name}/{k}")


def test_stacked_blocks_layout_converts_like_per_block():
    from tpugs.encoders.vit import ViTConfig as JViTConfig, VisionTransformer as JViT
    from tpugs.encoders.vit import stack_block_params

    jcfg = JViTConfig(image_size=32, patch_size=16, width=16, layers=3, heads=4)
    params = _init(JViT(jcfg), 0, jnp.zeros((1, 32, 32, 3)))
    stacked = {"params": stack_block_params(dict(params["params"]), 3)}
    a = convert.vit_from_flax(_np_tree(params))
    b = convert.vit_from_flax(_np_tree(stacked))
    assert a.keys() == b.keys()
    assert all(torch.equal(a[k], b[k]) for k in a)


# ------------------------------------------ public layouts, both loaders


def _within(got, ref, frac=2e-5):
    scale = max(1e-6, float(np.abs(ref).max()))
    err = float(np.abs(np.asarray(got) - np.asarray(ref)).max())
    assert err <= frac * scale, f"{err:.3e} > {frac} x {scale:.3e}"


PORT_TINY_VIT = ViTConfig(**{f.name: getattr(TINY_VIT, f.name)
                             for f in dataclasses.fields(ViTConfig)})
PORT_TINY_LSEG = dict(TINY_LSEG, vit_cfg=PORT_TINY_VIT)


def _lseg_sd(seed=0):
    sd = make_lseg_state_dict(np.random.default_rng(seed))
    sd["pretrained.model.head.weight"] = torch.zeros(10, 16)  # timm's unused classifier
    return sd


def _port_lseg(sd, image_size=48):
    """The tiny LSegNet built for another crop than the checkpoint's: the
    stored positional grid (4x4) replaces the module's (6x6) on load."""
    cfg = dataclasses.replace(PORT_TINY_VIT, image_size=image_size)
    net = LSegNet(**dict(PORT_TINY_LSEG, vit_cfg=cfg), device=CPU)
    net.load_state_dict(load_lseg_state_dict(sd))
    return net


def test_lseg_state_dict_loads_like_tpugs():
    from tpugs.encoders.convert import load_lseg_params
    from tpugs.encoders.lseg import LSegNet as JNet

    sd = _lseg_sd()
    params = load_lseg_params(sd)
    img = np.random.default_rng(1).uniform(0, 1, (1, 48, 48, 3)).astype(np.float32)
    ref = np.asarray(jax.jit(JNet(**TINY_LSEG).apply)(params, img))
    net = _port_lseg(sd)
    assert net.pretrained.model.pos_embed.shape == (1, 17, 16)
    with torch.no_grad():
        got = _nhwc(net(_nchw(img)))
    assert got.shape == ref.shape == (1, 48, 48, 16)  # patch 8: the head returns 8 x grid
    _within(got, ref)


LSEG_BAD = {
    "missing fusion conv": lambda sd: sd.pop("scratch.refinenet2.out_conv.weight"),
    "missing block tensor": lambda sd: sd.pop("pretrained.model.blocks.1.mlp.fc2.bias"),
    "unknown scratch key": lambda sd: sd.update({"scratch.extra.weight": torch.zeros(3)}),
    "unknown backbone key": lambda sd: sd.update(
        {"pretrained.model.blocks.0.attn.q_norm.weight": torch.zeros(16)}),
}


@pytest.mark.parametrize("case", sorted(LSEG_BAD))
def test_lseg_missing_or_unknown_key_raises(case):
    sd = _lseg_sd()
    LSEG_BAD[case](sd)
    with pytest.raises((KeyError, RuntimeError)):
        _port_lseg(sd)


def test_lseg_loader_drops_exactly_the_ignored_families():
    sd = _lseg_sd()
    kept = load_lseg_state_dict(sd)
    dropped = set(sd) - set(kept)
    assert dropped and all(k.startswith(("clip_pretrained.", "logit_scale",
                                         "pretrained.model.head.",
                                         "scratch.refinenet4.resConfUnit1."))
                           for k in dropped)
    assert any(k.startswith("scratch.refinenet4.resConfUnit1.") for k in dropped)


def test_lseg_loader_reads_a_checkpoint_file(tmp_path):
    sd = _lseg_sd()
    path = tmp_path / "lseg.ckpt"
    torch.save({"state_dict": sd, "epoch": 3}, path)
    a, b = load_lseg_state_dict(str(path)), load_lseg_state_dict(sd)
    assert a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)


PORT_TINY_DINO = ViTConfig(image_size=32, patch_size=8, width=16, layers=3, heads=4,
                           num_register_tokens=4, layer_norm_eps=1e-6, layer_scale=True,
                           pos_interp="cubic")


def _dino_pair(seed=7, patch=8, grid=4):
    from tpugs.encoders.convert import load_dino_params
    from tpugs.encoders.vit import ViTConfig as JViTConfig, VisionTransformer as JViT

    sd = make_dino_state_dict(np.random.default_rng(seed), patch=patch, grid=grid)
    cfg = dataclasses.replace(PORT_TINY_DINO, patch_size=patch, image_size=patch * grid)
    jvit = JViT(JViTConfig(**dataclasses.asdict(cfg)))
    vit = VisionTransformer(cfg, device=CPU)
    vit.load_state_dict(load_dino_state_dict(sd))
    return sd, jvit, load_dino_params(sd), vit


def test_dino_state_dict_loads_like_tpugs():
    sd, jvit, params, vit = _dino_pair()
    img = np.random.default_rng(2).uniform(0, 1, (1, 48, 48, 3)).astype(np.float32)
    ref = np.asarray(jax.jit(lambda p, x: jvit.apply(p, x)["final"])(params, img))
    with torch.no_grad():
        got = vit(_nchw(img))["final"].numpy()
    assert got.shape == ref.shape == (1, 5 + 36, 16)  # cubic pos interpolation 4 -> 6
    _within(got, ref)


@pytest.mark.parametrize("case", ["missing", "unknown", "mask_token dropped"])
def test_dino_loader_keys(case):
    sd = make_dino_state_dict(np.random.default_rng(9))
    vit = VisionTransformer(PORT_TINY_DINO, device=CPU)
    if case == "mask_token dropped":
        assert "mask_token" in sd and "mask_token" not in load_dino_state_dict(sd)
        vit.load_state_dict(load_dino_state_dict(sd))
        return
    if case == "missing":
        sd.pop("blocks.2.ls2.gamma")
    else:
        sd["blocks.0.attn.q_norm.weight"] = torch.zeros(16)
    with pytest.raises((KeyError, RuntimeError)):
        vit.load_state_dict(load_dino_state_dict(sd))


TEXT_OF_LSEG_SD = dict(vocab_size=64, context_length=8, width=12, heads=4, layers=2,
                       embed_dim=16)


def test_clip_text_state_dict_loads_like_tpugs():
    from tpugs.encoders.clip_text import CLIPTextTower as JTower
    from tpugs.encoders.convert import load_clip_text_params

    sd = make_lseg_state_dict(np.random.default_rng(5))
    toks = np.random.default_rng(0).integers(1, 60, (3, 8)).astype(np.int32)
    ref = np.asarray(jax.jit(JTower(**TEXT_OF_LSEG_SD).apply)(load_clip_text_params(sd), toks))
    tower = CLIPTextTower(**TEXT_OF_LSEG_SD, device=CPU)
    tower.load_state_dict(load_clip_text_state_dict(sd))
    with torch.no_grad():
        got = tower(torch.from_numpy(toks).long()).numpy()
    assert got.shape == (3, 16)
    _within(got, ref)


@pytest.mark.parametrize("case", ["missing", "unknown"])
def test_clip_text_missing_or_unknown_key_raises(case):
    sd = make_lseg_state_dict(np.random.default_rng(6))
    if case == "missing":
        sd.pop("clip_pretrained.transformer.resblocks.1.mlp.c_fc.bias")
    else:
        sd["clip_pretrained.transformer.resblocks.0.extra.weight"] = torch.zeros(4)
    tower = CLIPTextTower(**TEXT_OF_LSEG_SD, device=CPU)
    with pytest.raises((KeyError, RuntimeError)):
        tower.load_state_dict(load_clip_text_state_dict(sd))


def test_tokenizer_matches_tpugs(tmp_path):
    from tpugs.encoders.clip_text import SimpleTokenizer as JTok, tokenize as jtokenize
    from tpugs_torch.encoders.clip_text import SimpleTokenizer, tokenize

    p = tmp_path / "bpe.txt"
    p.write_text("#version: 0.2\nt h\nth e</w>\nc a\nca t</w>\n")
    texts = ["the cat", "a photo of THE cat!", "cat  7"]
    np.testing.assert_array_equal(tokenize(SimpleTokenizer(str(p)), texts, 16),
                                  jtokenize(JTok(str(p)), texts, 16))


def test_encode_text_without_files_raises():
    with pytest.raises(FileNotFoundError):
        encode_text(["a chair"], None, None, device=CPU)


# ------------------------------------------------ the encoder protocols


def _tpugs_lseg_encoder(sd, crop):
    """tpugs' LSegEncoder around the tiny net: ``__new__`` and the
    attributes its ``__init__`` sets (``tpugs/encoders/lseg.py:175-260``)."""
    from tpugs.encoders.convert import load_lseg_params
    from tpugs.encoders.lseg import LSegEncoder as JEnc, LSegNet as JNet

    enc = JEnc.__new__(JEnc)
    enc.crop_size, enc.dtype, enc.feature_dim = crop, None, TINY_LSEG["out_dim"]
    enc.net = JNet(**TINY_LSEG)
    enc.params = load_lseg_params(sd)
    enc._apply = jax.jit(enc.net.apply)

    def _pre(imgs):
        return jax.image.resize(imgs, (imgs.shape[0], crop, crop, 3), "bilinear")

    def _post(feats, out_hw):
        f = feats.astype(jnp.float32)
        f = f / (jnp.linalg.norm(f, axis=-1, keepdims=True) + 1e-8)
        f = jax.image.resize(f, (f.shape[0], *out_hw, f.shape[-1]), "bilinear")
        return f.astype(jnp.bfloat16)

    enc._pre_jit = jax.jit(_pre)
    enc._post_jit = jax.jit(_post, static_argnums=(1,))
    return enc


@pytest.fixture(scope="module")
def lseg_pair():
    sd = _lseg_sd(3)
    return _tpugs_lseg_encoder(sd, 48), LSegEncoder.from_net(_port_lseg(sd), crop_size=48)


def test_lseg_encoder_call_matches_tpugs(lseg_pair):
    jenc, enc = lseg_pair
    img = np.random.default_rng(4).uniform(0, 1, (40, 56, 3)).astype(np.float32)
    ref = np.asarray(jenc(jnp.asarray(img)))
    got = enc(_t(img))
    assert got.shape == ref.shape == (40, 56, 16) and got.dtype == torch.float32
    _within(got.numpy(), ref)
    np.testing.assert_allclose(np.linalg.norm(got.numpy(), axis=-1).max(), 1.0, atol=0.02)


def test_lseg_staged_apply_matches_tpugs(lseg_pair):
    jenc, enc = lseg_pair
    rgbs = np.random.default_rng(5).uniform(0, 1, (2, 40, 56, 3)).astype(np.float32)
    ref = np.asarray(jenc.staged_apply(jnp.asarray(rgbs)).astype(jnp.float32))
    got = enc.staged_apply(_t(rgbs))
    assert got.shape == (2, 40, 56, 16) and got.dtype == torch.bfloat16
    assert got.is_contiguous()
    # two roundings to bf16 of f32 values 2e-5 apart differ by at most one ulp
    np.testing.assert_allclose(got.float().numpy(), ref, rtol=2.0**-7, atol=1e-5)
    # the staged path is the per-image call, rounded
    one = enc(_t(rgbs[1])).to(torch.bfloat16)
    assert torch.equal(got[1], one)


def test_lseg_encoder_bf16_close_to_f32(lseg_pair):
    _, enc = lseg_pair
    net16 = _port_lseg(_lseg_sd(3))
    enc16 = LSegEncoder.from_net(net16, crop_size=48, dtype=torch.bfloat16)
    img = _t(np.random.default_rng(6).uniform(0, 1, (40, 56, 3)))
    a, b = enc(img), enc16(img)
    assert b.dtype == torch.float32
    cos = torch.nn.functional.cosine_similarity(a, b, dim=-1)
    assert float(cos.min()) > 0.95, float(cos.min())


def test_dino_encoder_call_matches_tpugs():
    from tpugs.encoders.dino import DinoEncoder as JEnc

    # tpugs' DinoEncoder assumes patch 14: a 3x3 grid at 42^2, positions 2x2
    _, jvit, params, vit = _dino_pair(11, patch=14, grid=2)
    jenc = JEnc.__new__(JEnc)
    jenc.image_size, jenc.vit, jenc.params, jenc.feature_dim = 42, jvit, params, 16
    jenc._apply = jax.jit(lambda p, x: jvit.apply(p, x))
    enc = DinoEncoder.from_vit(vit, image_size=42)
    img = np.random.default_rng(3).uniform(0, 1, (30, 44, 3)).astype(np.float32)
    ref = np.asarray(jenc(jnp.asarray(img)))
    got = enc(_t(img))
    assert got.shape == ref.shape == (30, 44, 16) and enc.feature_dim == 16
    _within(got.numpy(), ref)


# ------------------------------------------------------ init and registry


def test_flax_like_init_moments():
    net = LSegNet(**PORT_TINY_LSEG, device=CPU)
    init_flax_like_(net, seed=0)
    sd = net.state_dict()
    w = sd["pretrained.model.blocks.0.mlp.fc1.weight"]  # (64, 16): fan_in 16
    assert abs(float(w.std()) - 0.25) < 0.03 and float(w.abs().max()) <= 2 * 0.25 / 0.8796 + 1e-6
    conv = sd["scratch.layer2_rn.weight"]  # (8, 16, 3, 3): fan_in 144
    assert abs(float(conv.std()) * 12 - 1) < 0.1
    assert float(sd["pretrained.model.pos_embed"].std()) == pytest.approx(0.02, rel=0.2)
    assert torch.equal(sd["pretrained.model.cls_token"], torch.zeros(1, 1, 16))
    assert torch.equal(sd["pretrained.model.norm.weight"], torch.ones(16))
    assert all(not v.any() for k, v in sd.items() if k.endswith(".bias"))
    again = init_flax_like_(LSegNet(**PORT_TINY_LSEG, device=CPU), seed=0).state_dict()
    assert all(torch.equal(sd[k], again[k]) for k in sd)
    dino = init_flax_like_(VisionTransformer(PORT_TINY_DINO, device=CPU), 1).state_dict()
    assert torch.equal(dino["blocks.0.ls1.gamma"], torch.full((16,), 1e-5))


@pytest.mark.parametrize("name", ["lseg", "dino"])
def test_get_encoder_builds_the_vit_encoders(monkeypatch, name):
    from tpugs_torch.encoders import dino, get_encoder, lseg

    seen = {}

    class Recorder:
        def __init__(self, ckpt=None, **kw):
            seen.update(kw, ckpt=ckpt)

    module, cls = (lseg, "LSegEncoder") if name == "lseg" else (dino, "DinoEncoder")
    monkeypatch.setattr(module, cls, Recorder)
    enc = get_encoder(name, "w.ckpt", device=CPU, dtype=torch.bfloat16)
    assert isinstance(enc, Recorder)
    assert seen == dict(ckpt="w.ckpt", device=CPU, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        get_encoder("clip", device=CPU)


def test_random_encoder_warns_and_is_finite():
    """The random-weights path of the encoders' constructors, on a DINO
    ViT cut to two blocks (ViT-L's draw takes too long for this suite)."""
    import tpugs_torch.encoders.dino as dino

    small = dataclasses.replace(dino.DINOV2_VIT_L14_REG, width=32, heads=4, layers=2)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(dino, "DINOV2_VIT_L14_REG", small)
        with pytest.warns(UserWarning, match="RANDOM"):
            enc = DinoEncoder(image_size=28, device=CPU)
    f = enc(torch.rand(20, 24, 3))
    assert f.shape == (20, 24, 32) and bool(torch.isfinite(f).all()) and f.abs().max() > 0

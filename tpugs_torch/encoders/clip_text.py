"""CLIP text tower and BPE tokenizer (queries for open-vocabulary
segmentation; reference ``segment.py:42-52`` uses
``net.clip_pretrained.encode_text`` and ``clip.tokenize``). Counterpart:
``tpugs/encoders/clip_text.py``.

The tokenizer is CLIP's byte-pair encoder in pure Python; the merges file
(``bpe_simple_vocab_16e6.txt.gz``) ships with every CLIP distribution and
must be supplied as a file. The tower keeps OpenAI CLIP's state-dict
layout (``token_embedding``, ``positional_embedding``,
``transformer.resblocks.{i}.{ln_1,attn.in_proj_weight,attn.in_proj_bias,
attn.out_proj,ln_2,mlp.c_fc,mlp.c_proj}``, ``ln_final``,
``text_projection``). Its LayerNorms use eps 1e-6, Flax's default, as
tpugs' tower does (CLIP's own are 1e-5).
"""

from __future__ import annotations

import gzip
import html
from functools import lru_cache
from typing import List

import numpy as np
import torch
import torch.nn as nn

from tpugs_torch.core.device import DeviceLike, resolve_device
from tpugs_torch.encoders.vit import attention, merge_heads, quick_gelu, split_heads


# ------------------------------------------------------------- tokenizer


@lru_cache()
def bytes_to_unicode():
    bs = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("¡"), ord("¬") + 1))
        + list(range(ord("®"), ord("ÿ") + 1))
    )
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def get_pairs(word):
    pairs = set()
    prev = word[0]
    for ch in word[1:]:
        pairs.add((prev, ch))
        prev = ch
    return pairs


def basic_clean(text):
    return html.unescape(html.unescape(text)).strip()


def whitespace_clean(text):
    import re

    return re.sub(r"\s+", " ", text).strip()


class SimpleTokenizer:
    """CLIP BPE tokenizer; pass the merges file path (gz or txt)."""

    def __init__(self, bpe_path: str):
        import re

        self.byte_encoder = bytes_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        if bpe_path.endswith(".gz"):
            merges = gzip.open(bpe_path).read().decode("utf-8").split("\n")
        else:
            merges = open(bpe_path, encoding="utf-8").read().split("\n")
        merges = merges[1 : 49152 - 256 - 2 + 1]
        merges = [tuple(m.split()) for m in merges if m]
        vocab = list(bytes_to_unicode().values())
        vocab = vocab + [v + "</w>" for v in vocab]
        for merge in merges:
            vocab.append("".join(merge))
        vocab.extend(["<|startoftext|>", "<|endoftext|>"])
        self.encoder = dict(zip(vocab, range(len(vocab))))
        self.decoder = {v: k for k, v in self.encoder.items()}
        self.bpe_ranks = dict(zip(merges, range(len(merges))))
        self.cache = {
            "<|startoftext|>": "<|startoftext|>",
            "<|endoftext|>": "<|endoftext|>",
        }
        # CLIP's original pattern uses \p{L}/\p{N} (regex module); the
        # ASCII classes below are equivalent for English prompts.
        self.pat = re.compile(
            r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|"""
            r"""[a-zA-Z]+|[0-9]|[^\sa-zA-Z0-9]+""",
            re.IGNORECASE,
        )

    def bpe(self, token):
        if token in self.cache:
            return self.cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = get_pairs(word)
        if not pairs:
            return token + "</w>"
        while True:
            bigram = min(
                pairs, key=lambda p: self.bpe_ranks.get(p, float("inf"))
            )
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                    new_word.extend(word[i:j])
                    i = j
                except ValueError:
                    new_word.extend(word[i:])
                    break
                if (
                    word[i] == first
                    and i < len(word) - 1
                    and word[i + 1] == second
                ):
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = get_pairs(word)
        out = " ".join(word)
        self.cache[token] = out
        return out

    def encode(self, text: str) -> List[int]:
        bpe_tokens: List[int] = []
        text = whitespace_clean(basic_clean(text)).lower()
        for token in self.pat.findall(text):
            token = "".join(self.byte_encoder[b] for b in token.encode("utf-8"))
            bpe_tokens.extend(
                self.encoder[t] for t in self.bpe(token).split(" ")
            )
        return bpe_tokens


def tokenize(
    tokenizer: SimpleTokenizer, texts: List[str], context_length: int = 77
) -> np.ndarray:
    """(P, 77) int tokens with SOT/EOT, matching ``clip.tokenize``."""
    sot = tokenizer.encoder["<|startoftext|>"]
    eot = tokenizer.encoder["<|endoftext|>"]
    out = np.zeros((len(texts), context_length), np.int32)
    for i, text in enumerate(texts):
        toks = [sot] + tokenizer.encode(text)[: context_length - 2] + [eot]
        out[i, : len(toks)] = toks
    return out


# ------------------------------------------------------------ text tower


class CausalSelfAttention(nn.Module):
    """``nn.MultiheadAttention``'s parameter layout (fused ``in_proj``,
    ``out_proj``) around the plain attention with a causal mask."""

    def __init__(self, width: int, heads: int):
        super().__init__()
        self.heads = heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * width, width))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * width))
        self.out_proj = nn.Linear(width, width)
        nn.init.xavier_uniform_(self.in_proj_weight)

    def forward(self, x):
        T = x.shape[1]
        mask = torch.ones((T, T), dtype=torch.bool, device=x.device).tril()
        qkv = torch.nn.functional.linear(x, self.in_proj_weight, self.in_proj_bias)
        q, k, v = (split_heads(t, self.heads) for t in qkv.chunk(3, dim=-1))
        return self.out_proj(merge_heads(attention(q, k, v, mask)))


class TextMlp(nn.Module):
    def __init__(self, width: int):
        super().__init__()
        self.c_fc = nn.Linear(width, 4 * width)
        self.c_proj = nn.Linear(4 * width, width)

    def forward(self, x):
        return self.c_proj(quick_gelu(self.c_fc(x)))


class ResidualAttentionBlock(nn.Module):
    def __init__(self, width: int, heads: int):
        super().__init__()
        self.ln_1 = nn.LayerNorm(width, eps=1e-6)
        self.attn = CausalSelfAttention(width, heads)
        self.ln_2 = nn.LayerNorm(width, eps=1e-6)
        self.mlp = TextMlp(width)

    def forward(self, x):
        x = x + self.attn(self.ln_1(x))
        return x + self.mlp(self.ln_2(x))


class CLIPTextTower(nn.Module):
    """CLIP's causal text transformer: (P, T) token ids -> (P, embed_dim).

    Defaults are CLIP ViT-B/32's text tower, the one inside
    ``lseg_minimal_e200.ckpt`` (its 512-d text space is why LSeg features
    are 512-d). The embedding is taken at the EOT token, the largest id."""

    def __init__(self, vocab_size: int = 49408, context_length: int = 77, width: int = 512,
                 heads: int = 8, layers: int = 12, embed_dim: int = 512,
                 device: DeviceLike = "cuda"):
        super().__init__()
        with resolve_device(device):
            self.token_embedding = nn.Embedding(vocab_size, width)
            self.positional_embedding = nn.Parameter(torch.zeros(context_length, width))
            self.transformer = nn.Module()
            self.transformer.resblocks = nn.ModuleList(
                ResidualAttentionBlock(width, heads) for _ in range(layers))
            self.ln_final = nn.LayerNorm(width, eps=1e-6)
            self.text_projection = nn.Parameter(torch.zeros(width, embed_dim))

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        x = self.token_embedding(tokens) + self.positional_embedding[: tokens.shape[1]]
        for block in self.transformer.resblocks:
            x = block(x)
        x = self.ln_final(x)
        eot = tokens.argmax(dim=-1)
        return x[torch.arange(x.shape[0], device=x.device), eot] @ self.text_projection

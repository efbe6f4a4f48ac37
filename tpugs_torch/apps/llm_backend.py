"""Language-model backends of the scene editor. Counterpart:
``tpugs/apps/llm_backend.py``.

Each backend is a str -> str callable for ``viewer_llm.Assistant``:

* ``make_hf_backend`` — a causal LM from a LOCAL checkpoint directory
  (Mistral, Llama, GPT-2, ...) through transformers, greedy decoding, on
  ``device``. Nothing is downloaded: the weights must be files.
* ``make_tiny_random_backend`` — a randomly initialised two-layer GPT-2
  with a byte-level BPE tokenizer trained on the prompt: it emits noise,
  but runs the whole tokenize -> generate -> decode -> JSON extraction ->
  grammar fallback path offline. Its weights are drawn under
  ``torch.random.fork_rng`` from ``seed``, so the caller's generator is
  left as it was.
* ``make_backend`` — the CLI's spec: ``"hf:<path>"``, ``"tiny-random"``
  or ``""``/``"none"`` (the grammar parser alone).

``transformers`` and ``tokenizers`` are imported where a backend is made.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from tpugs_torch.core.device import DeviceLike, resolve_device


def _import_transformers():
    try:
        import tokenizers
        import transformers
    except ImportError as e:
        raise ImportError(
            f"the LLM backends need the transformers and tokenizers packages ({e})"
        ) from e
    return transformers, tokenizers


def _greedy(tok, model, device: torch.device, max_new_tokens: int, max_length: int):
    def llm(prompt: str) -> str:
        ids = tok(prompt, return_tensors="pt", truncation=True,
                  max_length=max_length).input_ids.to(device)
        with torch.no_grad():
            out = model.generate(ids, max_new_tokens=max_new_tokens, do_sample=False,
                                 pad_token_id=tok.pad_token_id)
        return tok.decode(out[0, ids.shape[1]:], skip_special_tokens=True)

    return llm


def make_hf_backend(
    model_path: str,
    max_new_tokens: int = 64,
    device: DeviceLike = "cuda",
) -> Callable[[str], str]:
    """A transformers causal LM from the local directory ``model_path``,
    in float32 on ``device``; greedy, since the answer must parse as JSON."""
    dev = resolve_device(device)
    transformers, _ = _import_transformers()
    tok = transformers.AutoTokenizer.from_pretrained(model_path, local_files_only=True)
    model = transformers.AutoModelForCausalLM.from_pretrained(
        model_path, local_files_only=True, torch_dtype=torch.float32
    ).to(dev).eval()
    if tok.pad_token_id is None:
        tok.pad_token = tok.eos_token
    return _greedy(tok, model, dev, max_new_tokens, 2048)


def make_tiny_random_backend(
    seed: int = 0, max_new_tokens: int = 24, device: DeviceLike = "cuda",
) -> Callable[[str], str]:
    """A real transformers ``generate`` loop on a tiny random GPT-2 with a
    freshly trained BPE tokenizer, on ``device``: no downloaded files."""
    dev = resolve_device(device)
    transformers, tokenizers = _import_transformers()

    from tpugs_torch.apps.viewer_llm import FEW_SHOT_PROMPT

    corpus = [
        FEW_SHOT_PROMPT,
        '{"command": "segment", "object": "table"}',
        '{"command": "change_view", "view": "top"}',
        '{"command": "change_color", "object": "vase", "color": "red"}',
        "show me the scene from above please segment delete recolor",
    ]
    raw = tokenizers.Tokenizer(tokenizers.models.BPE(unk_token="<unk>"))
    raw.pre_tokenizer = tokenizers.pre_tokenizers.ByteLevel()
    raw.train_from_iterator(
        corpus,
        tokenizers.trainers.BpeTrainer(vocab_size=384,
                                       special_tokens=["<unk>", "<pad>", "<eos>"]),
    )
    tok = transformers.PreTrainedTokenizerFast(
        tokenizer_object=raw, unk_token="<unk>", pad_token="<pad>", eos_token="<eos>",
    )
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        model = transformers.GPT2LMHeadModel(transformers.GPT2Config(
            vocab_size=max(tok.vocab_size, 384), n_positions=1024, n_embd=32, n_layer=2,
            n_head=2,
        )).eval()
    return _greedy(tok, model.to(dev), dev, max_new_tokens, 900)


def make_backend(spec: str, device: DeviceLike = "cuda") -> Optional[Callable[[str], str]]:
    """``"hf:<path>"`` -> a local checkpoint; ``"tiny-random"`` -> the
    random GPT-2; ``""``/``"none"`` -> None (the grammar parser)."""
    if not spec or spec == "none":
        return None
    if spec == "tiny-random":
        return make_tiny_random_backend(device=device)
    if spec.startswith("hf:"):
        return make_hf_backend(spec[3:], device=device)
    raise ValueError(
        f"unknown llm backend {spec!r} (use 'hf:<path>', 'tiny-random', or 'none')"
    )

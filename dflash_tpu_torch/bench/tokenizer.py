"""Tokenizer resolution for the serving surface and the benchmarks.  Port of
``dflash_tpu/bench/tokenizer.py`` (the port keeps its own copy: importing the
JAX package pulls in JAX).

A checkpoint directory with ``tokenizer_config.json``: the Hugging Face
tokenizer from it (``transformers`` is imported only then).  Otherwise a
deterministic synthetic tokenizer, so text requests, chat templates and stop
strings still run end to end with random-weight presets.
"""

from __future__ import annotations

from pathlib import Path
from typing import List, Optional


class SyntheticTokenizer:
    """Deterministic hash tokenizer: one id per whitespace word (FNV-1a of its
    bytes), stable across runs; ids avoid the special range [0, 10)."""

    def __init__(self, vocab_size: int, eos_token_id: int = 2):
        self.vocab_size = vocab_size
        self.eos_token_id = eos_token_id

    def apply_chat_template(
        self, messages, tokenize: bool = False, add_generation_prompt: bool = True, **kw
    ) -> str:
        parts = [f"<|{m['role']}|>\n{m['content']}" for m in messages]
        if add_generation_prompt:
            parts.append("<|assistant|>\n")
        return "\n".join(parts)

    def encode(self, text: str, **kw) -> List[int]:
        ids = []
        for word in text.split():
            h = 2166136261
            for ch in word.encode():
                h = ((h ^ ch) * 16777619) & 0xFFFFFFFF
            ids.append(10 + h % max(1, self.vocab_size - 10))
        return ids or [11]

    def decode(self, ids, skip_special_tokens: bool = True) -> str:
        return " ".join(f"tok{int(i)}" for i in ids)


def resolve_tokenizer(model_path: Optional[str], vocab_size: int):
    """The checkpoint's tokenizer when ``model_path`` holds one, else
    :class:`SyntheticTokenizer` over ``vocab_size``."""
    if model_path and Path(model_path).joinpath("tokenizer_config.json").exists():
        from transformers import AutoTokenizer

        return AutoTokenizer.from_pretrained(model_path, local_files_only=True)
    return SyntheticTokenizer(vocab_size)

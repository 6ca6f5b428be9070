"""LLM tokenizer loading (HF tokenizer.json) + offline byte fallback.

The reference gets its tokenizer from ``mlx_lm.load`` (HF files). Here:
- :func:`load_llm_tokenizer` wraps a local HF ``tokenizer.json`` via the
  ``tokenizers`` library when present;
- :class:`ByteFallbackTokenizer` is the zero-egress test tokenizer: raw
  bytes + registered special tokens (``<|im_start|>`` etc.) as single ids —
  enough to exercise templates, stop tokens and streaming exactly.
"""

from __future__ import annotations

from pathlib import Path

QWEN_SPECIALS = [
    "<|endoftext|>", "<|im_start|>", "<|im_end|>",
    "<tool_call>", "</tool_call>", "<think>", "</think>",
]


class ByteFallbackTokenizer:
    """Bytes 0..255 + special tokens at 256+; greedy special matching."""

    def __init__(self, specials: list[str] | None = None):
        self.specials = list(specials or QWEN_SPECIALS)
        self._special_id = {s: 256 + i for i, s in enumerate(self.specials)}
        self._id_special = {v: k for k, v in self._special_id.items()}
        self.vocab_size = 256 + len(self.specials)
        self.eos_token_id = self._special_id.get("<|im_end|>", 256)

    def encode(self, text: str) -> list[int]:
        ids: list[int] = []
        i = 0
        while i < len(text):
            for s in self.specials:
                if text.startswith(s, i):
                    ids.append(self._special_id[s])
                    i += len(s)
                    break
            else:
                ids.extend(text[i].encode("utf-8"))
                i += 1
        return ids

    def decode(self, ids: list[int]) -> str:
        out: list[str] = []
        buf = bytearray()
        for t in ids:
            if t < 256:
                buf.append(t)
            else:
                if buf:
                    out.append(buf.decode("utf-8", errors="replace"))
                    buf = bytearray()
                out.append(self._id_special.get(t, ""))
        if buf:
            out.append(buf.decode("utf-8", errors="replace"))
        return "".join(out)


class HFTokenizerWrapper:
    """tokenizers.Tokenizer → the minimal encode/decode surface we use."""

    def __init__(self, tok, eos_token_id: int | None = None):
        self._tok = tok
        self.eos_token_id = eos_token_id
        self.vocab_size = tok.get_vocab_size()

    def encode(self, text: str) -> list[int]:
        return self._tok.encode(text, add_special_tokens=False).ids

    def decode(self, ids: list[int]) -> str:
        return self._tok.decode(ids, skip_special_tokens=False)


def load_llm_tokenizer(model_dir: str | Path):
    """HF tokenizer.json when present; byte fallback otherwise."""
    model_dir = Path(model_dir)
    tj = model_dir / "tokenizer.json"
    if tj.exists():
        from tokenizers import Tokenizer

        tok = Tokenizer.from_file(str(tj))
        eos = None
        import json

        cfg_path = model_dir / "tokenizer_config.json"
        if cfg_path.exists():
            cfg = json.loads(cfg_path.read_text())
            eos_tok = cfg.get("eos_token")
            if isinstance(eos_tok, dict):
                eos_tok = eos_tok.get("content")
            if eos_tok:
                eos = tok.token_to_id(eos_tok)
        return HFTokenizerWrapper(tok, eos)
    return ByteFallbackTokenizer()

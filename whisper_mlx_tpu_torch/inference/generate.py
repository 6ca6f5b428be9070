"""LLM generation engine: KV-cached decode with sampling and streaming.

Counterpart of ``whisper_mlx_tpu/inference/generate.py``: ChatML prompts,
prompt-length buckets, prefill + incremental decode over the Qwen model,
temperature / top-p / top-k sampling from an explicit ``torch.Generator``,
stop tokens, and a streaming generator.

PyTorch runs eagerly, so the reference's one-jit loop becomes a host loop
that keeps each sampled token on the device and is pipelined by one step:
step ``i + 1`` is dispatched before token ``i`` is read back (the
reference's streaming structure, here also under ``generate``). Tokens are
those of the reference's loop at temperature 0.

The reference's weight-residency opt-ins convert the packed tree once, in
:class:`LLMEngine`, in its order: ``WTPU_NATIVE_RESIDENT=1`` (or ``auto``:
only trees of at most ``9 << 30`` elements) promotes every packed leaf to
a native one (``ops/quant.py:promote_resident_native``; K5 at up to 32 rows,
dequantize + matmul above), and a draft with it when the target was
promoted; then ``WTPU_QWEN_A8=1`` re-quantizes the linears still packed to
per-channel int8 (``ops/quant_a8.py``, kernel K7), then
``WTPU_MBT_RESIDENT=1`` transposes the linears still packed
(``ops/quant_matmul_mb.py``, kernel K6), so the earlier conversion wins
where several are set; a draft model is converted as the target is.
``WTPU_LLM_KV_BITS=8`` or ``4`` sets the target's ``config.kv_bits`` (the
quantized KV cache, ``models/qwen.py``), as the reference's engine does; a
draft keeps its own config. The continuous-batching engine serves the
weights it is given (``LLMEngine.continuous``: the engine's converted tree).

With a draft model (``draft=(params, config)``), ``generate`` at
temperature 0 runs greedy speculative decoding
(``inference/speculative.py``), token-identical to the plain loop;
``stream_generate``, sampling and the batch engine use the target alone,
as in the reference.
"""

from __future__ import annotations

import dataclasses
import os
import threading
import time
from dataclasses import dataclass
from typing import TYPE_CHECKING, Iterator, Sequence

import numpy as np
import torch

from whisper_mlx_tpu_torch.inference import speculative
from whisper_mlx_tpu_torch.models.qwen import Params, QwenConfig, decode_step, init_kv_cache

if TYPE_CHECKING:
    from whisper_mlx_tpu_torch.inference.batch_engine import ContinuousBatchEngine

# ---------------------------------------------------------------------------
# sampling
# ---------------------------------------------------------------------------


def sample_token(logits: torch.Tensor, generator: torch.Generator | None,
                 temperature: float | Sequence[float], top_p: float = 1.0,
                 top_k: int = 0) -> torch.Tensor:
    """(b, V) fp32 logits -> (b,) int64 tokens: greedy at temperature 0,
    else top-k / nucleus sampling as the reference filters; the draw is
    ``torch.multinomial`` from ``generator``. ``temperature`` is a host
    float, or one host float per row (continuous batching), so choosing
    greedy needs no read from the device."""
    greedy = torch.argmax(logits, dim=-1)
    host = np.asarray(temperature, np.float32)
    if not (host > 0).any():
        return greedy
    temp = torch.from_numpy(host).to(logits.device)
    t = temp[:, None] if temp.dim() == 1 else temp
    scaled = logits / torch.clamp(t, min=1e-6)
    if top_k and top_k > 0:
        kth = torch.sort(scaled, dim=-1).values[:, -top_k][:, None]
        scaled = torch.where(scaled < kth, float("-inf"), scaled)
    if top_p < 1.0:
        sorted_logits = torch.sort(scaled, dim=-1, descending=True).values
        cum = torch.cumsum(torch.softmax(sorted_logits, dim=-1), dim=-1)
        # keep the smallest prefix with cumulative mass > top_p (>= 1 token)
        cutoff_idx = torch.sum(cum < top_p, dim=-1)
        cutoff = torch.gather(sorted_logits, -1, cutoff_idx[:, None])
        scaled = torch.where(scaled < cutoff, float("-inf"), scaled)
    sampled = torch.multinomial(torch.softmax(scaled, dim=-1), 1,
                                generator=generator).squeeze(-1)
    return torch.where(temp > 0, sampled, greedy)


# ---------------------------------------------------------------------------
# chat template (ChatML, the Qwen family format)
# ---------------------------------------------------------------------------


def apply_chat_template(messages: list[dict[str, str]], add_generation_prompt: bool = True,
                        enable_thinking: bool = False) -> str:
    parts = [f"<|im_start|>{m['role']}\n{m['content']}<|im_end|>\n" for m in messages]
    if add_generation_prompt:
        parts.append("<|im_start|>assistant\n")
        if not enable_thinking:
            parts.append("<think>\n\n</think>\n\n")
    return "".join(parts)


# ---------------------------------------------------------------------------
# engine
# ---------------------------------------------------------------------------


@dataclass
class GenerationResult:
    text: str
    tokens: list[int]
    prompt_tokens: int
    generation_tokens: int
    prompt_tps: float
    generation_tps: float


def default_stop_ids(tokenizer) -> list[int]:
    """``<|im_end|>`` and eos: the tokenizer's attributes plus the ids of
    the two texts where each encodes to one token."""
    stops = []
    for attr in ("eos_token_id", "im_end_id"):
        v = getattr(tokenizer, attr, None)
        if isinstance(v, int):
            stops.append(v)
        elif isinstance(v, (list, tuple)):
            stops.extend(v)
    for text in ("<|im_end|>", "<|endoftext|>"):
        ids = tokenizer.encode(text)
        if len(ids) == 1:
            stops.append(ids[0])
    return sorted(set(stops)) or [0]


def params_device(params: Params) -> torch.device:
    """The device a Qwen state dict lives on (that of its final norm)."""
    return params["final_ln"].device


class LLMEngine:
    """Loaded model + tokenizer; it runs on the device its params are on.
    ``draft``: an optional ``(params, config)`` draft model on the same
    device, for greedy speculative decoding."""

    PROMPT_BUCKET = 128  # prompt lengths are rounded up to a multiple

    def __init__(self, params: Params, config: QwenConfig, tokenizer,
                 max_context: int = 4096,
                 draft: "tuple[Params, QwenConfig] | None" = None):
        # the quantized KV cache (WTPU_LLM_KV_BITS=8 or 4): the target's
        # config only, as in the reference; the draft keeps its own
        kv_bits = int(os.environ.get("WTPU_LLM_KV_BITS", "0"))
        if kv_bits and config.kv_bits != kv_bits:
            config = dataclasses.replace(config, kv_bits=kv_bits)
        resident = os.environ.get("WTPU_NATIVE_RESIDENT", "0")
        if resident != "0":
            from whisper_mlx_tpu_torch.ops.quant import promote_resident_native

            params, promoted = promote_resident_native(
                params, budget_bytes=None if resident == "1" else 9 << 30)
            if promoted and draft is not None:
                draft = (promote_resident_native(draft[0], budget_bytes=None)[0], draft[1])
        if os.environ.get("WTPU_QWEN_A8", "0") == "1":
            from whisper_mlx_tpu_torch.ops.quant_a8 import prepare_a8_params

            params = prepare_a8_params(params)
            if draft is not None:
                draft = (prepare_a8_params(draft[0]), draft[1])
        if os.environ.get("WTPU_MBT_RESIDENT", "0") == "1":
            from whisper_mlx_tpu_torch.ops.quant import prepare_mbt_params

            params = prepare_mbt_params(params)
            if draft is not None:
                draft = (prepare_mbt_params(draft[0]), draft[1])
        self.params = params
        self.config = config
        self.tokenizer = tokenizer
        self.max_context = max_context
        self.device = params_device(params)
        self.draft = draft
        self._batch_engine = None
        self._batch_lock = threading.Lock()

    def continuous(self, slots: int = 4) -> "ContinuousBatchEngine":
        """The shared continuous-batching engine over the same weights."""
        from whisper_mlx_tpu_torch.inference.batch_engine import ContinuousBatchEngine

        with self._batch_lock:
            if self._batch_engine is None:
                self._batch_engine = ContinuousBatchEngine(
                    self.params, self.config, self.tokenizer, slots=slots,
                    max_len=self.max_context)
            return self._batch_engine

    def _fit_context(self, ids: list[int], max_tokens: int) -> tuple[list[int], int]:
        """Keep the prompt tail; always leave >= 64 tokens of generation room."""
        ids = ids[-(self.max_context - 64):]
        return ids, max(1, min(max_tokens, self.max_context - len(ids)))

    def _bucket_prompt(self, ids: list[int]) -> tuple[list[int], int]:
        """Right-pad to the bucket size (the padded positions' cache slots are
        overwritten by generated tokens before the causal mask exposes them)."""
        true_len = len(ids)
        bucket = min(-(-true_len // self.PROMPT_BUCKET) * self.PROMPT_BUCKET, self.max_context)
        return ids + [0] * (bucket - true_len), true_len

    def _stop_ids(self) -> list[int]:
        return default_stop_ids(self.tokenizer)

    def _tokens(self, ids: list[int], max_tokens: int, temperature: float, top_p: float,
                top_k: int, seed: int) -> Iterator[int]:
        """Prefill, then sample + decode one token per step, pipelined by one
        step; yields token ids up to (without) the first stop token."""
        padded, true_len = self._bucket_prompt(ids)
        stops = set(self._stop_ids())
        gen = torch.Generator(device=self.device).manual_seed(seed)
        cache = init_kv_cache(self.config, 1, self.max_context, self.device)
        logits, cache = decode_step(
            self.params, torch.tensor([padded], device=self.device), 0, cache, self.config)
        last = logits[:, true_len - 1].float()
        pending = None
        pos = true_len
        for _ in range(max_tokens):
            tok = sample_token(last, gen, temperature, top_p, top_k)
            logits, cache = decode_step(self.params, tok[:, None], pos, cache, self.config)
            last = logits[:, -1].float()
            pos += 1
            if pending is not None:
                t = int(pending[0])
                if t in stops:
                    return
                yield t
            pending = tok
        if pending is not None and int(pending[0]) not in stops:
            yield int(pending[0])

    def generate(self, prompt: str, max_tokens: int = 512, temperature: float = 0.7,
                 top_p: float = 1.0, top_k: int = 0, seed: int = 0) -> GenerationResult:
        ids = self.tokenizer.encode(prompt)
        if max_tokens <= 0:
            return GenerationResult(text="", tokens=[], prompt_tokens=len(ids),
                                    generation_tokens=0, prompt_tps=0.0, generation_tps=0.0)
        if not ids:
            raise ValueError("generate() requires a non-empty prompt")
        ids, max_tokens = self._fit_context(ids, max_tokens)
        t0 = time.perf_counter()
        if self.draft is not None and temperature == 0.0:
            toks = self._speculative_tokens(ids, max_tokens)
        else:
            toks = list(self._tokens(ids, max_tokens, temperature, top_p, top_k, seed))
        dt = time.perf_counter() - t0
        return GenerationResult(
            text=self.tokenizer.decode(toks), tokens=toks, prompt_tokens=len(ids),
            generation_tokens=len(toks), prompt_tps=len(ids) / max(dt, 1e-9),
            generation_tps=len(toks) / max(dt, 1e-9))

    def _speculative_tokens(self, ids: list[int], max_tokens: int) -> list[int]:
        """Greedy speculative decoding with the draft; trailing stop tokens
        dropped, as the plain loop yields none."""
        draft_params, draft_config = self.draft
        stops = set(self._stop_ids())
        toks, _ = speculative.speculative_generate(
            self.params, self.config, draft_params, draft_config, ids,
            max_tokens=max_tokens, stop_ids=stops, max_len=self.max_context)
        while toks and toks[-1] in stops:
            toks = toks[:-1]
        return toks

    def stream_generate(self, prompt: str, max_tokens: int = 512, temperature: float = 0.7,
                        top_p: float = 1.0, top_k: int = 0, seed: int = 0) -> Iterator[str]:
        """Yield decoded text increments token by token; a trailing
        incomplete UTF-8 sequence is held back."""
        ids = self.tokenizer.encode(prompt)
        if not ids:
            raise ValueError("stream_generate() requires a non-empty prompt")
        ids, max_tokens = self._fit_context(ids, max_tokens)
        out: list[int] = []
        sent = 0
        for tok in self._tokens(ids, max_tokens, temperature, top_p, top_k, seed):
            out.append(tok)
            text = self.tokenizer.decode(out)
            if not text.endswith("�") and len(text) > sent:
                yield text[sent:]
                sent = len(text)

    def chat(self, messages: list[dict[str, str]], max_tokens: int = 512,
             temperature: float = 0.7, **kw) -> GenerationResult:
        return self.generate(apply_chat_template(messages), max_tokens=max_tokens,
                             temperature=temperature, **kw)

"""Decoding task: options -> initial tokens -> decode loop -> results.

Counterpart of ``whisper_mlx_tpu/decoding/task.py`` for the greedy slice:
sot-sequence construction (language/task/prompt/prefix), suppress lists,
the greedy loop (temperature 0, or best_of sampling at temperature > 0),
and the host-side metrics that drive the temperature-fallback ladder.
Beam search raises (ROADMAP.md M10).
"""

from __future__ import annotations

import zlib
from dataclasses import dataclass
from typing import Sequence

import numpy as np
import torch

from whisper_mlx_tpu_torch.decoding.filters import FilterConfig, make_suppress_mask
from whisper_mlx_tpu_torch.decoding.greedy import greedy_decode
from whisper_mlx_tpu_torch.decoding.tokenizer import WhisperTokenizer
from whisper_mlx_tpu_torch.models.whisper import (
    Params,
    WhisperConfig,
    cross_kv,
    decode_step,
    encode,
    init_kv_cache,
)


@dataclass(frozen=True)
class DecodingOptions:
    """Mirror of the reference's decode options surface."""

    task: str = "transcribe"
    language: str | None = None
    temperature: float = 0.0
    sample_len: int | None = None
    best_of: int | None = None  # sampling candidates (temperature > 0)
    beam_size: int | None = None
    patience: float | None = None
    length_penalty: float | None = None
    prompt: str | Sequence[int] | None = None  # condition-on-previous-text tokens
    prefix: str | Sequence[int] | None = None
    suppress_tokens: str | Sequence[int] | None = "-1"  # "-1" = non-speech default
    suppress_blank: bool = True
    without_timestamps: bool = False
    max_initial_timestamp: float | None = 1.0
    fp16: bool = False


@dataclass
class DecodingResult:
    tokens: list[int]
    text: str
    language: str
    avg_logprob: float
    no_speech_prob: float
    temperature: float
    compression_ratio: float


def compression_ratio(text: str) -> float:
    """zlib ratio used by the hallucination heuristics (ratio > 2.4 => retry)."""
    data = text.encode("utf-8")
    if not data:
        return 0.0
    return len(data) / len(zlib.compress(data))


def _resolve_suppress(options: DecodingOptions, tokenizer: WhisperTokenizer) -> tuple[int, ...]:
    st = options.suppress_tokens
    if isinstance(st, str):
        st = [int(t) for t in st.split(",")] if st else []
    st = list(st or [])
    if -1 in st:
        st = [t for t in st if t >= 0]
        st.extend(tokenizer.non_speech_tokens)
    suppress = set(st)
    suppress.update(
        [tokenizer.transcribe, tokenizer.translate, tokenizer.sot,
         tokenizer.sot_prev, tokenizer.sot_lm]
    )
    if tokenizer.no_speech is not None:
        suppress.add(tokenizer.no_speech)
    return tuple(sorted(suppress))


def build_initial_tokens(
    tokenizer: WhisperTokenizer, options: DecodingOptions, n_text_ctx: int
) -> tuple[list[int], int, int]:
    """-> (initial_tokens, sot_index, sample_begin)."""
    tokens = list(
        tokenizer.sot_sequence_including_notimestamps
        if options.without_timestamps
        else tokenizer.sot_sequence
    )
    sot_index = 0

    if options.prefix is not None:
        prefix = (
            tokenizer.encode(" " + options.prefix.strip())
            if isinstance(options.prefix, str)
            else list(options.prefix)
        )
        if options.sample_len is not None:
            prefix = prefix[-(n_text_ctx // 2 - options.sample_len):]
        tokens = tokens + prefix

    if options.prompt is not None:
        prompt = (
            tokenizer.encode(" " + options.prompt.strip())
            if isinstance(options.prompt, str)
            else list(options.prompt)
        )
        prev = [tokenizer.sot_prev] + prompt[-(n_text_ctx // 2 - 1):]
        tokens = prev + tokens
        sot_index = len(prev)

    sample_begin = len(tokens)
    return tokens, sot_index, sample_begin


@torch.inference_mode()
def detect_language(
    params: Params,
    audio_states: torch.Tensor,
    tokenizer: WhisperTokenizer,
    config: WhisperConfig,
) -> tuple[list[str], np.ndarray]:
    """Single forward pass on [sot] -> per-window language + probs
    (softmax over the language tokens only)."""
    batch = audio_states.shape[0]
    device = audio_states.device
    xkv = cross_kv(params, audio_states, config)
    cache = init_kv_cache(config, batch, device)
    toks = torch.full((batch, 1), tokenizer.sot, dtype=torch.long, device=device)
    logits, _ = decode_step(params, toks, 0, cache, xkv, config)
    logits = logits[:, 0].float().cpu().numpy()
    lang_ids = np.asarray(tokenizer.all_language_tokens)
    mask = np.full(logits.shape[-1], -np.inf, np.float32)
    mask[lang_ids] = 0.0
    probs = torch.softmax(torch.from_numpy(logits + mask), dim=-1).numpy()[:, lang_ids]
    best = probs.argmax(axis=-1)
    codes = [tokenizer.all_language_codes[i] for i in best]
    return codes, probs.max(axis=-1)


@torch.inference_mode()
def decode(
    params: Params,
    mel_or_states: torch.Tensor,
    tokenizer: WhisperTokenizer,
    config: WhisperConfig,
    options: DecodingOptions = DecodingOptions(),
    *,
    states_precomputed: bool = False,
    generator: torch.Generator | None = None,
) -> list[DecodingResult]:
    """Decode a batch of 30 s windows -> one DecodingResult per window.

    ``mel_or_states``: (batch, 3000, n_mels) mel, or (batch, 1500, d)
    encoder states when ``states_precomputed``. ``generator`` drives the
    temperature > 0 draws.
    """
    if options.beam_size is not None:
        raise NotImplementedError("beam search: ROADMAP.md M10")
    audio_states = (
        mel_or_states if states_precomputed else encode(params, mel_or_states, config)
    )
    batch = audio_states.shape[0]
    device = audio_states.device

    init_tokens, sot_index, sample_begin = build_initial_tokens(
        tokenizer, options, config.n_text_ctx
    )
    sample_len = options.sample_len or (config.n_text_ctx // 2)

    suppress_ids = _resolve_suppress(options, tokenizer)
    blank_ids = tuple(tokenizer.encode(" ")) + (tokenizer.eot,) if options.suppress_blank else ()
    always_np, begin_np = make_suppress_mask(config.n_vocab, suppress_ids, blank_ids)

    max_initial_ts_idx = (
        round(options.max_initial_timestamp / 0.02)
        if options.max_initial_timestamp is not None
        else None
    )
    filter_cfg = FilterConfig(
        eot=tokenizer.eot,
        no_timestamps=tokenizer.no_timestamps,
        timestamp_begin=tokenizer.timestamp_begin,
        sample_begin=sample_begin,
        max_initial_timestamp_index=max_initial_ts_idx,
        apply_timestamp_rules=not options.without_timestamps,
    )

    n_candidates = options.best_of if (options.best_of and options.temperature > 0) else 1
    initial = torch.tensor(init_tokens, dtype=torch.long, device=device)
    initial = initial[None, :].expand(batch * n_candidates, -1).contiguous()

    result = greedy_decode(
        params, audio_states, initial, torch.from_numpy(always_np).to(device),
        torch.from_numpy(begin_np).to(device), float(options.temperature),
        generator, config=config, filter_cfg=filter_cfg, sample_len=sample_len,
        sot_index=sot_index, no_speech_token=tokenizer.no_speech,
        share_xkv_groups=n_candidates,
    )
    # the one device -> host fetch of the greedy path
    tokens_np = result.tokens.cpu().numpy()
    lengths = result.lengths.cpu().numpy()
    sum_lp = result.sum_logprobs.cpu().numpy()
    ns_probs = result.no_speech_probs.cpu().numpy()
    return _rank_greedy(tokens_np, lengths, sum_lp, ns_probs, batch, n_candidates,
                        sample_begin, tokenizer, options)


def _rank_greedy(tokens_np, lengths, sum_lp, ns_probs, batch: int,
                 n_candidates: int, sample_begin: int,
                 tokenizer: WhisperTokenizer,
                 options: DecodingOptions) -> list[DecodingResult]:
    """Host-side tail of :func:`decode`: pick the best candidate per window
    (MaximumLikelihoodRanker semantics) and build DecodingResults."""
    results: list[DecodingResult] = []
    for w in range(batch):
        cands = range(w * n_candidates, (w + 1) * n_candidates)
        best, best_score = None, -np.inf
        for c in cands:
            toks = tokens_np[c, sample_begin : lengths[c]].tolist()
            n_sampled = len(toks) + 1  # +1 for EOT, whisper's avg denominator
            avg_lp = float(sum_lp[c]) / n_sampled
            if options.length_penalty is None:
                penalty = float(max(len(toks), 1))
            else:
                penalty = ((5.0 + len(toks)) / 6.0) ** options.length_penalty
            score = float(sum_lp[c]) / penalty
            if score > best_score:
                best_score = score
                best = (toks, avg_lp, c)
        toks, avg_lp, c = best
        text = tokenizer.decode(toks).strip()
        results.append(
            DecodingResult(
                tokens=toks,
                text=text,
                language=tokenizer.language,
                avg_logprob=avg_lp,
                no_speech_prob=float(ns_probs[c]),
                temperature=options.temperature,
                compression_ratio=compression_ratio(text),
            )
        )
    return results

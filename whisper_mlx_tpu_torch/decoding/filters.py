"""Logit filters as batched PyTorch functions.

Counterpart of ``whisper_mlx_tpu/decoding/filters.py``. Each filter maps
``(logits, tokens, cur_len) -> logits`` over the fixed ``(batch, n_ctx)``
token buffer. ``cur_len`` is a host int (the greedy loop keeps it on the
host), so the position rules branch in Python and only the per-row rules
run on the device.

Semantics follow the public Whisper decoding rules: suppress lists, blank
suppression at the first sampled position, and the timestamp grammar
(pairs, monotonic, a timestamp first bounded by ``max_initial_timestamp``,
and a forced timestamp when their total probability beats every text
token).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

NEG_INF = float("-inf")


@dataclass(frozen=True)
class FilterConfig:
    """Static decode-filter configuration."""

    eot: int
    no_timestamps: int
    timestamp_begin: int
    sample_begin: int  # index of the first *sampled* position in the buffer
    max_initial_timestamp_index: int | None = 50  # 1.0 s default
    apply_timestamp_rules: bool = True


def make_suppress_mask(
    n_vocab: int,
    suppress_ids: tuple[int, ...],
    blank_ids: tuple[int, ...],
) -> tuple[np.ndarray, np.ndarray]:
    """Boolean (n_vocab,) masks: always-suppressed ids / begin-only ids."""
    always = np.zeros(n_vocab, bool)
    always[list(suppress_ids)] = True
    begin = np.zeros(n_vocab, bool)
    begin[list(blank_ids)] = True
    return always, begin


def apply_filters(
    logits: torch.Tensor,  # (batch, n_vocab) fp32
    tokens: torch.Tensor,  # (batch, n_ctx) int buffer, valid up to cur_len
    cur_len: int,
    suppress_mask: torch.Tensor,  # (n_vocab,) bool
    blank_mask: torch.Tensor,  # (n_vocab,) bool
    cfg: FilterConfig,
) -> torch.Tensor:
    logits = logits.masked_fill(suppress_mask[None, :], NEG_INF)
    if cur_len == cfg.sample_begin:
        logits = logits.masked_fill(blank_mask[None, :], NEG_INF)
    if cfg.apply_timestamp_rules:
        logits = _timestamp_rules(logits, tokens, cur_len, cfg)
    return logits


def _timestamp_rules(
    logits: torch.Tensor,
    tokens: torch.Tensor,
    cur_len: int,
    cfg: FilterConfig,
) -> torch.Tensor:
    ts_begin = cfg.timestamp_begin
    logits = logits.clone()
    # <|notimestamps|> is never sampled when rules are on
    logits[:, cfg.no_timestamps] = NEG_INF

    at_begin = cur_len == cfg.sample_begin
    if at_begin:
        # the first sampled token must be a timestamp (text, EOT and
        # specials suppressed), bounded by max_initial_timestamp
        logits[:, :ts_begin] = NEG_INF
        if cfg.max_initial_timestamp_index is not None:
            logits[:, ts_begin + cfg.max_initial_timestamp_index + 1:] = NEG_INF
    else:
        # pair grammar: ts,ts -> must emit text; x,ts -> must emit ts or EOT
        last_was_ts = tokens[:, cur_len - 1] >= ts_begin
        if cur_len > cfg.sample_begin + 1:
            penult_was_ts = tokens[:, cur_len - 2] >= ts_begin
        else:
            penult_was_ts = torch.ones_like(last_was_ts)
        force_text = last_was_ts & penult_was_ts
        force_ts = last_was_ts & ~penult_was_ts
        logits[:, ts_begin:] = logits[:, ts_begin:].masked_fill(force_text[:, None], NEG_INF)
        logits[:, :cfg.eot] = logits[:, :cfg.eot].masked_fill(force_ts[:, None], NEG_INF)

        # monotonicity: suppress timestamps below the running max
        sampled = tokens[:, cfg.sample_begin:cur_len]
        ts_vals = torch.where(sampled >= ts_begin, sampled, torch.full_like(sampled, -1))
        max_ts = ts_vals.max(dim=1).values
        ts_floor = torch.where(force_ts, max_ts, max_ts + 1)  # whisper's off-by-one rule
        vocab_idx = torch.arange(logits.shape[1], device=logits.device)[None, :]
        low_ts = ((max_ts >= 0)[:, None] & (vocab_idx >= ts_begin)
                  & (vocab_idx < ts_floor[:, None]))
        logits = logits.masked_fill(low_ts, NEG_INF)

    # if total timestamp probability beats every text token, force a timestamp
    logprobs = torch.log_softmax(logits, dim=-1)
    ts_logprob = torch.logsumexp(logprobs[:, ts_begin:], dim=-1)
    max_text_logprob = logprobs[:, :ts_begin].max(dim=-1).values
    force = ts_logprob > max_text_logprob
    logits[:, :ts_begin] = logits[:, :ts_begin].masked_fill(force[:, None], NEG_INF)
    return logits

"""Batched greedy / temperature-sampling decode loop.

Counterpart of ``whisper_mlx_tpu/decoding/greedy.py``. The JAX loop is one
``lax.while_loop`` under jit; here it is a Python loop over steps with
``cur_len`` and ``pos`` held as host ints, so the attention kernels get
``pos`` as a plain int and the filters branch on the host. The loop does
not wait for the device on every step: it checks ``done.all()`` once every
:data:`DONE_CHECK_EVERY` steps. Rows already done emit EOT and add nothing
to ``sum_logprobs``, so the extra steps leave the results unchanged.

The self-attention cache is one right-sized allocation (horizon rounded up
to 128). The JAX package's growing-cache phase ladder is not needed: the
decode kernel stops its key loop at ``pos + 1``, so dead positions are
never read.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from whisper_mlx_tpu_torch.decoding.filters import FilterConfig, apply_filters
from whisper_mlx_tpu_torch.models.whisper import (
    Params,
    WhisperConfig,
    cross_kv,
    decode_step,
    init_kv_cache,
)

DONE_CHECK_EVERY = 16


class GreedyResult(NamedTuple):
    tokens: torch.Tensor  # (batch, n_ctx) int64, EOT-padded after finish
    lengths: torch.Tensor  # (batch,) total valid length incl. initial tokens
    sum_logprobs: torch.Tensor  # (batch,) fp32 — sum over sampled tokens up to EOT
    no_speech_probs: torch.Tensor  # (batch,) fp32 — P(no_speech) at the SOT position


def sample_tokens(logits: torch.Tensor, temperature: float,
                  generator: torch.Generator | None,
                  rows: tuple[int, int] | None = None) -> torch.Tensor:
    """Argmax at temperature 0, else a categorical draw (Gumbel-max with
    noise from ``generator``) from ``softmax(logits / temperature)``.
    ``rows = (start, total)``: ``logits`` are rows ``[start, start + b)`` of
    a batch of ``total`` (a data-parallel slice); the whole batch's noise
    is drawn and this slice's rows kept, so that every slice samples what
    the whole batch would."""
    if temperature <= 0:
        return logits.argmax(dim=-1)
    start, total = rows or (0, logits.shape[0])
    u = torch.rand((total, *logits.shape[1:]), generator=generator,
                   device=logits.device)[start:start + logits.shape[0]]
    gumbel = -torch.log(-torch.log(u.clamp_min(torch.finfo(u.dtype).tiny)))
    return (logits / temperature + gumbel).argmax(dim=-1)


@torch.inference_mode()
def greedy_decode(
    params: Params,
    audio_states: torch.Tensor,  # (batch / g, 1500, d) encoder output
    initial_tokens: torch.Tensor,  # (batch, n_init) — sot sequence (+ prompt)
    suppress_mask: torch.Tensor,  # (n_vocab,) bool
    blank_mask: torch.Tensor,  # (n_vocab,) bool
    temperature: float,
    generator: torch.Generator | None,
    config: WhisperConfig,
    filter_cfg: FilterConfig,
    sample_len: int,
    sot_index: int,
    no_speech_token: int,
    share_xkv_groups: int = 1,
    rows: tuple[int, int] | None = None,
) -> GreedyResult:
    """``share_xkv_groups=g``: audio_states holds batch/g windows whose
    cross K/V are shared by g consecutive decode rows (best_of). ``rows``:
    see :func:`sample_tokens`."""
    device = audio_states.device
    batch, n_init = initial_tokens.shape
    n_ctx = config.n_text_ctx
    eot = filter_cfg.eot
    max_len = min(n_init + sample_len, n_ctx)

    xkv = cross_kv(params, audio_states, config)
    cache = init_kv_cache(config, batch, device, max_len=n_init + sample_len)

    logits_all, cache = decode_step(params, initial_tokens, 0, cache, xkv, config,
                                    share_xkv_groups=share_xkv_groups)
    no_speech_probs = torch.softmax(logits_all[:, sot_index], dim=-1)[:, no_speech_token]
    logits = logits_all[:, -1]

    tokens = torch.zeros((batch, n_ctx), dtype=torch.long, device=device)
    tokens[:, :n_init] = initial_tokens
    sum_logprobs = torch.zeros(batch, dtype=torch.float32, device=device)
    done = torch.zeros(batch, dtype=torch.bool, device=device)
    eot_t = torch.full((batch,), eot, dtype=torch.long, device=device)

    cur_len = n_init
    step = 0
    while cur_len < max_len:
        filtered = apply_filters(logits, tokens, cur_len, suppress_mask, blank_mask,
                                 filter_cfg)
        logprobs = torch.log_softmax(filtered, dim=-1)
        next_tok = sample_tokens(filtered, temperature, generator, rows)
        tok_logprob = logprobs.gather(1, next_tok[:, None])[:, 0]
        sum_logprobs += torch.where(done, torch.zeros_like(tok_logprob), tok_logprob)
        next_tok = torch.where(done, eot_t, next_tok)
        done |= next_tok == eot
        tokens[:, cur_len] = next_tok
        step_logits, cache = decode_step(params, next_tok[:, None], cur_len, cache, xkv,
                                         config, share_xkv_groups=share_xkv_groups)
        logits = step_logits[:, -1]
        cur_len += 1
        step += 1
        if step % DONE_CHECK_EVERY == 0 and bool(done.all()):
            break

    # effective length: position of the first EOT after sample_begin (or cur_len)
    pos = torch.arange(n_ctx, device=device)[None, :]
    is_eot = (tokens == eot) & (pos >= n_init) & (pos < cur_len)
    first_eot = torch.where(is_eot.any(dim=1), is_eot.int().argmax(dim=1),
                            torch.full((batch,), cur_len, device=device))
    return GreedyResult(tokens=tokens, lengths=first_eot, sum_logprobs=sum_logprobs,
                        no_speech_probs=no_speech_probs)

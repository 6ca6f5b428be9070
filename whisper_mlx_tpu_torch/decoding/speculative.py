"""Speculative whisper decoding: a draft model proposes, the target verifies.

Counterpart of ``whisper_mlx_tpu/decoding/speculative.py``. A cheap draft
decoder (large-v3-turbo's 4-layer decoder shares large-v3's encoder)
proposes ``k`` tokens; the target verifies all of them in one forward of
``k + 1`` positions, so its cross-attention K/V stream is read once per
accepted block instead of once per token. Greedy acceptance keeps the output
token-identical to the target's own greedy decode: accept the longest prefix
where each proposal equals the target's filtered argmax; the target's argmax
at the first mismatch becomes the next committed token. The suppress masks
and the timestamp grammar (``decoding/filters.py``) run at every proposal
and verify position with that position's own token prefix.

The reference's jitted ``while_loop`` is a host loop here, with ``s_len``
and every position a host int, as in ``decoding/greedy.py``. An iteration
runs one draft sync (the last two committed tokens at ``s_len - 2``), k - 1
draft steps, one verify of ``k + 1`` positions at ``s_len - 1`` and one
read of the accepted count and the first EOT back to the host. On CUDA the
quantized self and cross caches put every attention of both models on kernel
K3: the sync at 2 query rows, the verify at ``k + 1``.

The n_ctx edge: no block reaches past ``n_text_ctx``. Where
``s_len - 1 + k + 1`` would, the iteration proposes ``n_text_ctx - s_len``
tokens instead of ``k``, so the port stays the sequential greedy decode. The
reference's ``dynamic_slice`` clamps such a block's start instead, which
shifts its positional embeddings and cache writes.

Cache invariant (both caches): after an iteration commits m tokens,
positions ``[s_len, s_len + k)`` may hold proposal K/V that diverged from
the committed sequence; the next iteration writes ``[s_len - 1, s_len + k)``
before the causal mask can expose any of them. The 2-token draft sync
covers a fully accepted block, after which the draft cache misses two
trailing positions (the last proposal never fed back, the bonus token new).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from whisper_mlx_tpu_torch.decoding.filters import FilterConfig, apply_filters
from whisper_mlx_tpu_torch.decoding.task import DecodingResult, compression_ratio, decode_setup
from whisper_mlx_tpu_torch.models.whisper import (
    Params,
    WhisperConfig,
    cross_kv,
    decode_step,
    encode,
    init_kv_cache,
)
from whisper_mlx_tpu_torch.ops.quant import maybe_dense_decode_params


class SpecResult(NamedTuple):
    tokens: torch.Tensor  # (1, n_ctx) int64, valid up to lengths
    lengths: torch.Tensor  # (1,) first-EOT position (absolute), else s_len
    sum_logprobs: torch.Tensor  # (1,) fp32 over the sampled tokens, EOT included
    no_speech_probs: torch.Tensor  # (1,) fp32 at the SOT position
    proposed: int  # draft tokens proposed
    accepted: int  # proposals accepted by the target
    target_calls: int  # verify forwards (the prefill not counted)


@torch.inference_mode()
def spec_decode(
    params_t: Params,
    params_d: Params,
    audio_states_t: torch.Tensor,  # (1, 1500, d_t) target encoder output
    audio_states_d: torch.Tensor,  # (1, 1500, d_d) draft encoder output
    initial_tokens: torch.Tensor,  # (1, n_init)
    suppress_mask: torch.Tensor,
    blank_mask: torch.Tensor,
    config_t: WhisperConfig,
    config_d: WhisperConfig,
    filter_cfg: FilterConfig,
    sample_len: int,
    sot_index: int,
    no_speech_token: int,
    k: int = 4,
) -> SpecResult:
    """Greedy speculative decode of one window; token-identical to
    ``greedy_decode(temperature=0)`` on the target."""
    if config_t.n_vocab != config_d.n_vocab:
        raise ValueError("spec_decode: the draft must share the target's vocabulary")
    _, n_init = initial_tokens.shape
    if n_init < 2:
        raise ValueError("spec_decode: the 2-token draft sync needs >= 2 initial tokens")
    if k < 1:
        raise ValueError(f"spec_decode: k must be >= 1, got {k}")
    dev = audio_states_t.device
    n_ctx = config_t.n_text_ctx
    eot = filter_cfg.eot
    max_len = min(n_init + sample_len, n_ctx)
    horizon = max_len + k + 1

    xkv_t = cross_kv(params_t, audio_states_t, config_t)
    xkv_d = cross_kv(params_d, audio_states_d, config_d)
    t_cache = init_kv_cache(config_t, 1, dev, max_len=horizon)
    d_cache = init_kv_cache(config_d, 1, dev, max_len=horizon)
    # committed tokens through s_len; positions past it hold proposals or
    # garbage that later writes cover before any read
    tokens = torch.zeros((1, n_ctx + k + 1), dtype=torch.long, device=dev)
    tokens[:, :n_init] = initial_tokens

    def filt(logits_1v: torch.Tensor, cur_len: int) -> torch.Tensor:
        return apply_filters(logits_1v.float(), tokens, cur_len, suppress_mask, blank_mask,
                             filter_cfg)

    # prefill, both models
    t_logits, t_cache = decode_step(params_t, initial_tokens, 0, t_cache, xkv_t, config_t)
    _, d_cache = decode_step(params_d, initial_tokens, 0, d_cache, xkv_d, config_d)
    no_speech_probs = torch.softmax(t_logits[:, sot_index], dim=-1)[:, no_speech_token]
    lg0 = filt(t_logits[:, -1], n_init)
    t1 = lg0.argmax(dim=-1)
    sum_logprobs = torch.log_softmax(lg0, dim=-1).gather(1, t1[:, None])[:, 0]
    tokens[:, n_init] = t1
    s_len = n_init + 1  # tokens[s_len - 1] is in neither cache yet
    done = int(t1[0]) == eot
    proposed = accepted = target_calls = 0

    while s_len < max_len and not done:
        kk = min(k, n_ctx - s_len)  # no block past n_text_ctx
        # draft: the 2-token sync, then kk - 1 steps, each proposal filtered
        # with its own prefix and written after it
        d_logits, d_cache = decode_step(params_d, tokens[:, s_len - 2:s_len], s_len - 2,
                                        d_cache, xkv_d, config_d)
        p = filt(d_logits[:, -1], s_len).argmax(dim=-1)
        tokens[:, s_len] = p
        for j in range(1, kk):
            d_logits, d_cache = decode_step(params_d, p[:, None], s_len + j - 1, d_cache,
                                            xkv_d, config_d)
            p = filt(d_logits[:, -1], s_len + j).argmax(dim=-1)
            tokens[:, s_len + j] = p
        props = tokens[0, s_len:s_len + kk].clone()

        # target: verify [last, p1 .. pkk] in one forward of kk + 1 positions
        v_logits, t_cache = decode_step(params_t, tokens[:, s_len - 1:s_len + kk].clone(),
                                        s_len - 1, t_cache, xkv_t, config_t)
        lgs = torch.cat([filt(v_logits[:, i], s_len + i) for i in range(kk + 1)])
        g = lgs.argmax(dim=-1)  # (kk + 1,) the target's filtered greedy picks
        lp = torch.log_softmax(lgs, dim=-1).gather(1, g[:, None])[:, 0]

        n_dev = torch.cumprod((props == g[:kk]).long(), dim=0).sum()  # leading accepted
        idx = torch.arange(kk + 1, device=dev)
        eot_hit = (g == eot) & (idx <= n_dev)
        first_eot = torch.where(eot_hit.any(), eot_hit.long().argmax(), idx[-1] + 1)
        n, first = torch.stack([n_dev, first_eot]).tolist()  # the iteration's one read
        m = min(n + 1, first + 1, max_len - s_len)

        # commit: position s_len + i holds g_i for i < m (g_i equals p_{i+1}
        # while accepted); the rest of the write is garbage the next
        # iteration covers before any read
        tokens[0, s_len:s_len + kk + 1] = g
        sum_logprobs = sum_logprobs + lp[:m].sum()
        done = first < m
        proposed += kk
        accepted += min(n, m)
        target_calls += 1
        s_len += m

    toks = tokens[:, :n_ctx]
    pos = torch.arange(n_ctx, device=dev)[None, :]
    cur = min(s_len, max_len)
    is_eot = (toks == eot) & (pos >= n_init) & (pos < cur)
    lengths = torch.where(is_eot.any(dim=1), is_eot.long().argmax(dim=1),
                          torch.full((1,), cur, device=dev))
    return SpecResult(tokens=toks, lengths=lengths, sum_logprobs=sum_logprobs,
                      no_speech_probs=no_speech_probs, proposed=proposed,
                      accepted=accepted, target_calls=target_calls)


@torch.inference_mode()
def spec_decode_task(
    params_t: Params,
    params_d: Params,
    mel_or_states: torch.Tensor,
    tokenizer,
    config_t: WhisperConfig,
    config_d: WhisperConfig,
    options,
    *,
    k: int = 4,
    states_precomputed: bool = False,
    draft_shares_encoder: bool | None = None,
):
    """-> list[DecodingResult], one a window, decoded one window after the
    other (speculative decoding is a single-stream latency feature; batched
    throughput is ``decoding/greedy.py``'s).

    ``draft_shares_encoder`` (default: when the widths match and the draft
    has no encoder) gives the draft the target's encoder states;
    ``states_precomputed`` always does, since the mel is gone. A packed 4/8-bit
    tree of either model takes ``maybe_dense_decode_params``'s policy at its
    own rows: ``k + 1`` for the target's verify, 2 for the draft's sync.
    """
    params_t = maybe_dense_decode_params(params_t, k + 1, dtype=config_t.dtype)
    params_d = maybe_dense_decode_params(params_d, 2, dtype=config_d.dtype)
    states_t = mel_or_states if states_precomputed else encode(params_t, mel_or_states, config_t)
    if draft_shares_encoder is None:
        draft_shares_encoder = (config_d.n_audio_state == config_t.n_audio_state
                                and "encoder" not in params_d)
    if states_precomputed or draft_shares_encoder or "encoder" not in params_d:
        states_d = states_t
    else:
        states_d = encode(params_d, mel_or_states, config_d)

    dev = states_t.device
    setup = decode_setup(tokenizer, options, config_t, dev)
    sample_begin = setup.filter_cfg.sample_begin
    init = torch.tensor(setup.init_tokens, dtype=torch.long, device=dev)[None, :]
    out = []
    for w in range(states_t.shape[0]):
        res = spec_decode(
            params_t, params_d, states_t[w:w + 1], states_d[w:w + 1], init,
            setup.suppress_mask, setup.blank_mask, config_t, config_d, setup.filter_cfg,
            setup.sample_len, setup.sot_index, tokenizer.no_speech, k=k)
        length = int(res.lengths[0])
        toks = res.tokens[0, sample_begin:length].tolist()
        text = tokenizer.decode(toks).strip()
        n_sampled = max(length - sample_begin + 1, 1)  # + EOT, as greedy ranks
        out.append(DecodingResult(
            tokens=toks, text=text, language=tokenizer.language,
            avg_logprob=float(res.sum_logprobs[0]) / n_sampled,
            no_speech_prob=float(res.no_speech_probs[0]),
            temperature=0.0,
            compression_ratio=compression_ratio(text),
            spec_stats={"proposed": res.proposed, "accepted": res.accepted,
                        "target_calls": res.target_calls},
        ))
    return out

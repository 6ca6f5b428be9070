"""Batched beam search over N windows x B beams.

Counterpart of ``whisper_mlx_tpu/decoding/beam.py``. The JAX loop is one
``lax.while_loop`` under jit; here it is a Python loop with ``cur_len`` a
host int, and the selection (filters, log-softmax, top-2B candidates, the
finished pool, the live-beam refill) on device tensors. The loop checks
``all(fin_count >= P)`` once every :data:`DONE_CHECK_EVERY` steps, as greedy
checks ``done``: the pool is insertion-only and the final backfill skips
full pools, so steps after a window's pool is full change nothing.

Semantics of the reference (mlx_whisper's decoding): candidates best-first,
ties by ascending (parent, token) flat index (:func:`_topk_flat`); EOT
candidates fill a finished pool of ``round(beam_size * patience)``, the rest
refill the B live beams; step 0 proposes from beam 0 only; windows with an
underfull pool take their best live beams at the end.

Self-KV schemes (``WTPU_BEAM_KV``):

- ``flat`` (default): the prefilled per-lane cache becomes the lane-
  interleaved flat cache (``models/whisper.py:beam_flat_cache``); it is
  never reordered. Each lane writes its own rows, and an ``(N*B, T)``
  ancestry map, reordered by parent each step, tells attention (kernel K8)
  which lane's row holds each position.
- ``perm``, ``permg``, ``permp``: the per-lane cache is physically reordered
  by parent before each step, out of place (kernel K9's permute). The
  reference lowers the three differently (one-hot matmul, XLA gather,
  Pallas DMA); they compute the same function, and here all three run K9.
- ``permi``: copy-on-divergence. A parent's first child keeps the parent's
  lane; extra children claim freed lanes and copy the parent's rows in
  place (K9's move). An ``(N, B)`` map holds each logical beam's lane.
- ``shared`` (prefix sharing): the flat cache and ancestry of ``flat``,
  plus a per-window depth ``s_fill`` below which every live lane of the
  window agrees on its ancestry. Attention splits at it (kernel K8's split
  mode, ``kv_quant.py:attention_int8_shared``): positions below it form one
  softmax block, the divergent tail another. The reference reads the agreed
  block from a single copy S; K8 reads those same rows through the
  ancestry, so no S buffer is kept. The loop follows the reference's
  trajectory exactly (:func:`_shared_commits`, :func:`_shared_prefix`): at
  most two commits a step, each below the segment's S width; an overflow
  flag, set when an active window's tail outgrows the read window
  ``WTPU_BEAM_WIN`` (64), turns the split off from the next step (K8
  computes the flat function); at each segment bound ``s_fill`` is
  recomputed and the flag cleared. ``s_fill`` and the flag stay on the
  device. Int8 and fp self caches (the reference raises for int4, and its
  ``beam_decode_task`` remaps int4 to ``flat``).

``WTPU_BEAM_PHASES``, the reference's growing-cache phase ladder, was
dropped for every other scheme: the kernels stop their key loop at the
live length, so one right-sized cache gives the same results. Under
``shared`` it sets the segment bounds, where ``s_fill`` is recomputed, so it
changes the results and is read for that scheme only.
"""

from __future__ import annotations

import dataclasses
import os
from typing import NamedTuple

import numpy as np
import torch

from whisper_mlx_tpu_torch.decoding.filters import FilterConfig, apply_filters
from whisper_mlx_tpu_torch.models.whisper import (
    Params,
    WhisperConfig,
    beam_flat_cache,
    cross_kv,
    decode_step,
    init_kv_cache,
)
from whisper_mlx_tpu_torch.ops.lane_permute import lane_move_inplace, permute_lanes

DONE_CHECK_EVERY = 16
# the schemes that compute the flat scheme's function; "shared" rounds its
# integer dots by blocks, and takes no int4 self cache
SCHEMES = ("flat", "perm", "permg", "permp", "permi")
SHARED_WINDOW = 64  # the shared scheme's read window W when none is given


def _topk_flat(cand: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k over the last axis with ``lax.top_k``'s order: values
    descending, equal values by ascending index. One unique int64 key per
    entry (the float's order-preserving int32 in the high half, the inverted
    index in the low half) makes ``torch.topk`` exact on any device."""
    bits = cand.float().contiguous().view(torch.int32)
    ordered = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits).long()
    idx = torch.arange(cand.shape[-1], device=cand.device)
    key = (ordered << 32) + (0xFFFFFFFF - idx)
    top = torch.topk(key, k, dim=-1).indices
    return cand.gather(-1, top), top


class BeamResult(NamedTuple):
    tokens: torch.Tensor  # (N, P, ctx) finished hypotheses (EOT-terminated)
    lengths: torch.Tensor  # (N, P) sampled length before EOT
    scores: torch.Tensor  # (N, P) raw sum_logprobs (incl. EOT)
    fin_count: torch.Tensor  # (N,) valid finished hypotheses
    no_speech_probs: torch.Tensor  # (N,)


def _scatter_dump(shape, index, src, fill) -> torch.Tensor:
    """``out[n, index[n, k]] = src[n, k]`` along axis 1 of a new tensor with
    one extra slot at the end, which takes every write aimed at it (the
    caller slices it off)."""
    out = torch.full((shape[0], shape[1] + 1, *shape[2:]), fill, dtype=src.dtype,
                     device=src.device)
    if src.dim() > 2:
        index = index[..., None].expand(-1, -1, *src.shape[2:])
    return out.scatter_(1, index, src)[:, :shape[1]]


def _permi_lanes(lane_of, new_parent, new_token, n_beam):
    """Copy-on-divergence lane assignment (``beam.py:513-552`` of the
    reference) as index arithmetic over (N, B): the first child of each
    parent keeps the parent's lane, extra children take the freed lanes in
    ascending order. -> (lane of each new logical beam (N, B), row map
    src (N, B) with src[l] = l for untouched lanes, tokens by lane (N, B))."""
    n = lane_of.shape[0]
    iota = torch.arange(n_beam, device=lane_of.device)
    parent_lane = lane_of.gather(1, new_parent)
    same = new_parent[:, :, None] == new_parent[:, None, :]  # (N, j, i)
    dup_before = (same & (iota[None, :, None] > iota[None, None, :])).any(dim=2)
    referenced = (parent_lane[:, :, None] == iota).any(dim=1)  # (N, lane)
    dead_rank = torch.cumsum((~referenced).long(), dim=1) - 1
    lane_at_rank = _scatter_dump((n, n_beam), torch.where(~referenced, dead_rank, n_beam),
                                 iota.expand(n, -1).contiguous(), 0)
    fill_rank = (torch.cumsum(dup_before.long(), dim=1) - 1).clamp(0, n_beam - 1)
    lane_new = torch.where(dup_before, lane_at_rank.gather(1, fill_rank), parent_lane)
    moved_to = torch.where(dup_before, lane_new, n_beam)
    hit = _scatter_dump((n, n_beam), moved_to, torch.ones_like(dup_before), False)
    src = torch.where(hit, _scatter_dump((n, n_beam), moved_to, parent_lane, 0), iota)
    token_lane = torch.zeros_like(new_token).scatter_(1, lane_new, new_token)
    return lane_new, src, token_lane


def _shared_prefix(anc: torch.Tensor, n_win: int, cur_len: int, cap: int) -> torch.Tensor:
    """``s_fill`` at a segment bound (``beam.py:600-606`` of the reference):
    each window's count of leading positions below ``cur_len`` on which all
    its lanes' ancestries agree, at most ``cap`` (the next segment's S
    width). (n_win,) int32."""
    anc3 = anc.reshape(n_win, -1, anc.shape[1])
    agree = (anc3 == anc3[:, :1]).all(dim=1)
    agree &= torch.arange(anc.shape[1], device=anc.device) < cur_len
    pref = torch.cumprod(agree.int(), dim=1).sum(dim=1)
    return pref.clamp(max=cap).to(torch.int32)


def _shared_commits(anc, s_fill, overflow, active, n_win: int, cur_len: int, ts_seg: int,
                    window: int) -> tuple[torch.Tensor, torch.Tensor]:
    """One step's commits and overflow rule (``beam.py:447-507`` of the
    reference) over the reordered ancestry ``anc``: at most two, each
    position ``p = s_fill`` on which the window's lanes agree, below
    ``cur_len`` and the segment's S width ``ts_seg``, and none once the
    flag is set; then the flag turns on where an active window's tail
    ``[s_fill, cur_len + 1]`` outgrows ``window``. -> (s_fill, the flag for
    the next step); this step still runs the split under the flag it was
    given."""
    anc3 = anc.reshape(n_win, -1, anc.shape[1])
    for _ in range(2):
        p = s_fill
        idx = p.long().clamp(0, anc.shape[1] - 1)[:, None, None].expand(-1, anc3.shape[1], 1)
        cols = anc3.gather(2, idx)[:, :, 0]
        ok = (cols == cols[:, :1]).all(dim=1) & (p < cur_len) & (p < ts_seg) & ~overflow
        s_fill = torch.where(ok, p + 1, p)
    overflow = overflow | (active & (s_fill < cur_len + 2 - window)).any()
    return s_fill, overflow


@torch.inference_mode()
def beam_decode(
    params: Params,
    audio_states: torch.Tensor,  # (N, 1500, d)
    initial_tokens: torch.Tensor,  # (N, n_init)
    suppress_mask: torch.Tensor,  # (n_vocab,) bool
    blank_mask: torch.Tensor,  # (n_vocab,) bool
    config: WhisperConfig,
    filter_cfg: FilterConfig,
    sample_len: int,
    sot_index: int,
    no_speech_token: int,
    beam_size: int,
    pool_size: int,
    kv_scheme: str = "flat",
    phases: tuple[int, ...] | None = None,
    window: int | None = None,
) -> BeamResult:
    """``phases`` (segment bounds) and ``window`` (the read window W) steer
    the ``shared`` scheme only."""
    if kv_scheme not in (*SCHEMES, "shared"):
        raise ValueError(f"unknown beam kv_scheme {kv_scheme!r}")
    if kv_scheme == "shared" and config.self_kv_bits == 4:
        raise ValueError("kv_scheme='shared' requires self_kv_bits in (0, 8), as the "
                         "reference does")
    if config.self_kv_layout != "tminor":
        # the beam's own caches: the greedy time-major self layout does not
        # apply (a time-major cross cache does: its attention stays fp)
        config = dataclasses.replace(config, self_kv_layout="tminor")
    device = audio_states.device
    n_win, n_init = initial_tokens.shape
    B, P = beam_size, pool_size
    NB = n_win * B
    n_ctx, V, eot = config.n_text_ctx, config.n_vocab, filter_cfg.eot
    K = 2 * B  # top-K per window: at most B are EOT, so B non-EOT remain
    max_len = min(n_init + sample_len, n_ctx)
    win_base = torch.arange(n_win, device=device)[:, None] * B

    xkv = cross_kv(params, audio_states, config)
    cache = init_kv_cache(config, NB, device, max_len=n_init + sample_len)
    t_alloc = next(iter(cache[0].values())).shape[2]
    init_flat = initial_tokens.repeat_interleave(B, dim=0)
    logits_all, cache = decode_step(params, init_flat, 0, cache, xkv, config,
                                    share_xkv_groups=B)
    own_lane = torch.arange(B, dtype=torch.int32, device=device).repeat(n_win)
    if kv_scheme in ("flat", "shared"):
        cache = beam_flat_cache(cache, B)
        anc = own_lane[:, None].repeat(1, t_alloc).contiguous()  # (NB, T)
    if kv_scheme == "shared":
        window = int(window) if window else SHARED_WINDOW
        horizon = n_init + sample_len
        bounds = [b for b in sorted(set((128,) if phases is None else phases))
                  if n_init + 1 < b and horizon > b + 32]
        seg_bounds = [min(b, max_len) for b in bounds] + [max_len]
        # S widths: the bound rounded up to 128, at most the reference's own
        # F allocation (its init_kv_cache at the horizon)
        t_ref = min(-(-horizon // 128) * 128, n_ctx)

        def ts_of(bound: int) -> int:
            return min(-(-bound // 128) * 128, t_ref)

        seg, ts_seg = 0, ts_of(bounds[0] if bounds else horizon)
        s_fill = torch.full((n_win,), n_init, dtype=torch.int32, device=device)
        overflow = torch.zeros((), dtype=torch.bool, device=device)
    elif kv_scheme == "permi":
        anc = torch.arange(B, device=device).repeat(n_win, 1)  # (N, B) beam -> lane
    no_speech_probs = torch.softmax(logits_all[::B, sot_index].float(), dim=-1)[
        :, no_speech_token]
    logits = logits_all[:, -1].float()

    tokens = torch.zeros((NB, n_ctx), dtype=torch.long, device=device)
    tokens[:, :n_init] = init_flat
    cum = torch.full((n_win, B), float("-inf"), device=device)
    cum[:, 0] = 0.0  # step 0: only beam 0 is live
    fin_tokens = torch.zeros((n_win, P, n_ctx), dtype=torch.long, device=device)
    fin_lengths = torch.zeros((n_win, P), dtype=torch.long, device=device)
    fin_scores = torch.full((n_win, P), float("-inf"), device=device)
    fin_count = torch.zeros(n_win, dtype=torch.long, device=device)

    cur_len, step = n_init, 0
    while cur_len < max_len:
        fin_before = fin_count  # the shared scheme's overflow rule reads the step's start
        if kv_scheme == "permi":  # logits come in lane order
            logits = logits[(anc + win_base).reshape(-1)]
        filtered = apply_filters(logits, tokens, cur_len, suppress_mask, blank_mask,
                                 filter_cfg)
        logprobs = torch.log_softmax(filtered, dim=-1).reshape(n_win, B, V)
        top_scores, top_idx = _topk_flat((cum[:, :, None] + logprobs).reshape(n_win, B * V), K)
        parent, token = top_idx // V, top_idx % V
        is_eot = token == eot

        # finished pool: insertion-only, best-first within the step
        slot = fin_count[:, None] + torch.cumsum(is_eot.long(), dim=1) - 1
        can_insert = is_eot & (slot < P)
        seqs = tokens[(parent + win_base).reshape(-1)].reshape(n_win, K, n_ctx)
        seqs[:, :, cur_len] = token
        slot = torch.where(can_insert, slot, P)
        written = _scatter_dump((n_win, P), slot, torch.ones_like(can_insert), False)
        fin_tokens = torch.where(written[:, :, None],
                                 _scatter_dump((n_win, P, n_ctx), slot, seqs, 0), fin_tokens)
        fin_scores = torch.where(written, _scatter_dump((n_win, P), slot, top_scores, 0.0),
                                 fin_scores)
        fin_lengths = torch.where(written, cur_len - n_init, fin_lengths)
        fin_count = torch.clamp(fin_count + can_insert.sum(dim=1), max=P)

        # refill the live beams with the best B non-EOT candidates
        nb_rank = torch.cumsum((~is_eot).long(), dim=1) - 1
        sel = torch.where(~is_eot & (nb_rank < B), nb_rank, B)
        new_parent = _scatter_dump((n_win, B), sel, parent, 0)
        new_token = _scatter_dump((n_win, B), sel, token, 0)
        cum = _scatter_dump((n_win, B), sel, top_scores, 0.0)
        flat_parent = (new_parent + win_base).reshape(-1)
        tokens = tokens[flat_parent]
        tokens[:, cur_len] = new_token.reshape(-1)

        step_tokens = new_token.reshape(-1, 1)
        ancestry = split = None
        if kv_scheme in ("flat", "shared"):
            if kv_scheme == "shared":
                while seg + 1 < len(seg_bounds) and cur_len >= seg_bounds[seg]:
                    seg += 1  # a segment bound: s_fill anew, the flag cleared
                    ts_seg = ts_of(seg_bounds[seg])
                    s_fill = _shared_prefix(anc, n_win, cur_len, ts_seg)
                    overflow = torch.zeros_like(overflow)
            anc = anc[flat_parent]
            anc[:, cur_len] = own_lane
            ancestry = anc
            if kv_scheme == "shared":
                s_fill, next_overflow = _shared_commits(anc, s_fill, overflow, fin_before < P,
                                                        n_win, cur_len, ts_seg, window)
                split = dict(beam_s_fill=s_fill, beam_overflow=overflow, beam_window=window)
                overflow = next_overflow
        elif kv_scheme == "permi":
            anc, src, token_lane = _permi_lanes(anc, new_parent, new_token, B)
            # K9 takes int32 maps: converted once a step, not in each layer's call
            src_flat = (src + win_base).reshape(-1).to(torch.int32)
            for entry in cache:
                lane_move_inplace(list(entry.values()), src_flat)
            step_tokens = token_lane.reshape(-1, 1)
        else:
            parent32 = flat_parent.to(torch.int32)
            cache = [dict(zip(entry, permute_lanes(list(entry.values()), parent32)))
                     for entry in cache]
        step_logits, cache = decode_step(params, step_tokens, cur_len, cache, xkv, config,
                                         share_xkv_groups=B, beam_ancestry=ancestry,
                                         **(split or {}))
        logits = step_logits[:, -1]
        cur_len += 1
        step += 1
        if step % DONE_CHECK_EVERY == 0 and bool((fin_count >= P).all()):
            break

    # windows with an underfull pool take their best live beams, each once
    order = torch.argsort(-cum, dim=1, stable=True)
    live_tokens = tokens.reshape(n_win, B, n_ctx).gather(
        1, order[:, :, None].expand(-1, -1, n_ctx)).clone()
    live_tokens[:, :, min(cur_len, n_ctx - 1)] = eot  # the reference's clamped write
    live_scores = cum.gather(1, order)
    idx = torch.arange(P, device=device)[None, :]
    src_raw = idx - fin_count[:, None]
    valid = (src_raw >= 0) & (src_raw < B)
    src = src_raw.clamp(0, B - 1)
    fin_tokens = torch.where(valid[:, :, None],
                             live_tokens.gather(1, src[:, :, None].expand(-1, -1, n_ctx)),
                             fin_tokens)
    fin_scores = torch.where(valid, live_scores.gather(1, src), fin_scores)
    fin_lengths = torch.where(valid, cur_len - n_init, fin_lengths)
    return BeamResult(tokens=fin_tokens, lengths=fin_lengths, scores=fin_scores,
                      fin_count=torch.clamp(fin_count + B, max=P),
                      no_speech_probs=no_speech_probs)


def beam_decode_task(params: Params, mel_or_states: torch.Tensor, tokenizer,
                     config: WhisperConfig, options, *, states_precomputed: bool = False):
    """Beam decode of a batch of windows -> one ``DecodingResult`` each,
    the pool ranked by length penalty (``beam.py:688-785``)."""
    from whisper_mlx_tpu_torch.decoding.task import (
        DecodingResult,
        compression_ratio,
        decode_setup,
    )
    from whisper_mlx_tpu_torch.models.whisper import encode

    audio_states = (mel_or_states if states_precomputed
                    else encode(params, mel_or_states, config))
    n_win = audio_states.shape[0]
    B = options.beam_size
    P = max(round(B * (options.patience if options.patience is not None else 1.0)), 1)
    setup = decode_setup(tokenizer, options, config, audio_states.device)
    kv_scheme = os.environ.get("WTPU_BEAM_KV", "flat")
    if kv_scheme == "shared" and config.self_kv_bits == 4:
        kv_scheme = "flat"  # the reference's own remap: no int4 shared buffers
    phases = window = None
    if kv_scheme == "shared":  # its segment bounds ("" none) and read window
        raw = os.environ.get("WTPU_BEAM_PHASES")
        if raw is not None:
            phases = tuple(int(p) for p in raw.split(",") if p.strip())
        window = int(os.environ.get("WTPU_BEAM_WIN", str(SHARED_WINDOW)))
    initial = torch.tensor(setup.init_tokens, dtype=torch.long, device=audio_states.device)
    result = beam_decode(
        params, audio_states, initial[None, :].expand(n_win, -1).contiguous(),
        setup.suppress_mask, setup.blank_mask, config=config, filter_cfg=setup.filter_cfg,
        sample_len=setup.sample_len, sot_index=setup.sot_index,
        no_speech_token=tokenizer.no_speech, beam_size=B, pool_size=P, kv_scheme=kv_scheme,
        phases=phases, window=window)
    tokens_np = result.tokens.cpu().numpy()
    lengths_np = result.lengths.cpu().numpy()
    scores_np = result.scores.cpu().numpy()
    ns_np = result.no_speech_probs.cpu().numpy()

    lp = options.length_penalty
    out = []
    sample_begin = setup.filter_cfg.sample_begin
    for w in range(n_win):
        best, best_score = 0, -np.inf
        for p in range(P):
            L = max(int(lengths_np[w, p]), 1)
            penalty = float(L) if lp is None else ((5.0 + L) / 6.0) ** lp
            score = scores_np[w, p] / penalty
            if score > best_score:
                best_score, best = score, p
        L = int(lengths_np[w, best])
        toks = tokens_np[w, best, sample_begin:sample_begin + L].tolist()
        text = tokenizer.decode(toks).strip()
        out.append(DecodingResult(
            tokens=toks, text=text, language=tokenizer.language,
            avg_logprob=float(scores_np[w, best]) / (L + 1),
            no_speech_prob=float(ns_np[w]), temperature=options.temperature,
            compression_ratio=compression_ratio(text)))
    return out

"""Speculative decoding for the LLM engine (greedy, exactness-preserving).

Counterpart of ``whisper_mlx_tpu/inference/speculative.py``, a host loop in
both packages. A small draft model proposes ``k`` tokens; the target
verifies all of them in one forward of ``k + 1`` positions. With greedy
acceptance the output is token-identical to greedy decoding of the target
alone: accept the longest prefix where each proposal equals the target's
argmax at its position; the target's argmax at the first mismatch (or the
bonus position after full acceptance) becomes the next committed token.

Invariants (absolute sequence S = prompt + committed tokens):

- the target cache holds K/V for ``S[:t_pos]``; ``next_tok`` is S's next
  committed token, in no cache yet;
- the draft cache holds K/V for ``S[:d_pos]`` plus garbage beyond, which the
  next sync block overwrites before the causal mask can expose it.

Positions are host ints, as everywhere in the port. Each model's cache is
built from its own config: the target's is quantized under
``WTPU_LLM_KV_BITS`` (``LLMEngine`` sets ``kv_bits`` in the target's config
only), the draft's as its config says. On CUDA the prompt's prefill runs the
flash kernel (K4) for both models, and every later block of several tokens
(the verify, a draft sync) attends over the cache on ``models/qwen.py``'s
grouped path: over a quantized cache K3's GQA mode.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from whisper_mlx_tpu_torch.models.qwen import Params, QwenConfig, decode_step, init_kv_cache


@dataclass
class SpecStats:
    proposed: int = 0
    accepted: int = 0
    target_calls: int = 0
    draft_calls: int = 0

    @property
    def acceptance_rate(self) -> float:
        return self.accepted / max(self.proposed, 1)


def _argmax(logits: torch.Tensor) -> int:
    return int(torch.argmax(logits))


def speculative_generate(
    target_params: Params,
    target_config: QwenConfig,
    draft_params: Params,
    draft_config: QwenConfig,
    prompt_ids: list[int],
    max_tokens: int,
    stop_ids: set[int],
    k: int = 4,
    max_len: int = 2048,
) -> tuple[list[int], SpecStats]:
    """Greedy speculative decode -> (generated tokens, stats); both models
    run on the device their params are on (the target's)."""
    dev = target_params["final_ln"].device
    stats = SpecStats()
    S = list(prompt_ids)

    def ids(tokens: list[int]) -> torch.Tensor:
        return torch.tensor([tokens], dtype=torch.long, device=dev)

    t_cache = init_kv_cache(target_config, 1, max_len, dev)
    d_cache = init_kv_cache(draft_config, 1, max_len, dev)

    t_logits, t_cache = decode_step(target_params, ids(S), 0, t_cache, target_config)
    stats.target_calls += 1
    _, d_cache = decode_step(draft_params, ids(S), 0, d_cache, draft_config)
    stats.draft_calls += 1
    t_pos = len(S)
    d_pos = len(S)
    next_tok = _argmax(t_logits[0, -1])

    out: list[int] = []
    while len(out) < max_tokens:
        S.append(next_tok)
        out.append(next_tok)
        if next_tok in stop_ids or len(out) >= max_tokens:
            break

        # draft: sync to the frontier (>= 1 tokens, at least next_tok; it
        # overwrites the garbage past d_pos), then propose
        d_logits, d_cache = decode_step(draft_params, ids(S[d_pos:]), d_pos, d_cache,
                                        draft_config)
        stats.draft_calls += 1
        d_step_pos = len(S)
        proposals = [_argmax(d_logits[0, -1])]
        budget = min(k, max_tokens - len(out))
        while len(proposals) < budget and proposals[-1] not in stop_ids:
            d_logits, d_cache = decode_step(draft_params, ids(proposals[-1:]), d_step_pos,
                                            d_cache, draft_config)
            stats.draft_calls += 1
            d_step_pos += 1
            proposals.append(_argmax(d_logits[0, -1]))
        d_pos = len(S)  # proposal writes past len(S) are garbage until the next sync
        stats.proposed += len(proposals)

        # target: verify [next_tok, *proposals] in one forward
        t_logits, t_cache = decode_step(target_params, ids([next_tok] + proposals), t_pos,
                                        t_cache, target_config)
        stats.target_calls += 1
        # target_greedy[i]: the target's token for sequence position t_pos + i + 1
        target_greedy = torch.argmax(t_logits[0], dim=-1).tolist()

        n_accept = 0
        for i, proposal in enumerate(proposals):
            if target_greedy[i] != proposal:
                break
            n_accept += 1
            if proposal in stop_ids:
                break
        stats.accepted += n_accept

        take = proposals[:n_accept][: max_tokens - len(out)]
        S.extend(take)
        out.extend(take)
        if len(out) >= max_tokens or (take and take[-1] in stop_ids):
            break

        # the target cache now covers S (positions t_pos .. t_pos + n_accept
        # hold [next_tok, *accepted]); garbage beyond is overwritten before
        # the causal mask exposes it
        t_pos += n_accept + 1
        next_tok = target_greedy[n_accept]

    return out, stats

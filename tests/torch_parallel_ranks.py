"""The ranks' side of tests/test_torch_parallel_mp.py.

Each function runs in one process of a gloo job on the CPU, started by
``whisper_mlx_tpu_torch.parallel.launch.run_ranks``, and imports torch and
the port only (the JAX references are computed by the test). It returns
plain data: tokens, logits as numpy arrays, segment dicts.
"""

from __future__ import annotations

import asyncio
import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from whisper_mlx_tpu_torch.decoding.task import decode
from whisper_mlx_tpu_torch.decoding.tokenizer import make_synthetic_tokenizer
from whisper_mlx_tpu_torch.inference.transcribe import transcribe
from whisper_mlx_tpu_torch.models import qwen as tqw
from whisper_mlx_tpu_torch.models import whisper as tw
from whisper_mlx_tpu_torch.parallel.mesh import (
    all_gather_cat,
    all_gather_objects,
    all_sum,
    broadcast,
    init_distributed,
    make_mesh,
)
from whisper_mlx_tpu_torch.parallel.sharding import shard_batch, shard_model
from whisper_mlx_tpu_torch.parallel.sharding_llm import shard_qwen_model
from whisper_mlx_tpu_torch.runtime.batcher import TranscriptionBatcher


def _join(rank: int, world: int, coordinator: str) -> None:
    torch.set_num_threads(1)
    init_distributed(coordinator, world, rank, device="cpu")


def _collectives(mesh) -> dict:
    """Every collective over each axis of ``mesh`` and over the job."""
    r = mesh.rank
    x = torch.tensor([float(r + 1), 0.5], dtype=torch.bfloat16)
    out = {"rank": r, "coords": (mesh.index("dp"), mesh.index("tp")),
           "sum_tp": all_sum(x, mesh, "tp").tolist(),
           "sum_dp": all_sum(x, mesh, "dp").tolist(),
           "sum_dtype": str(all_sum(x, mesh, "tp").dtype),
           "gather_tp": all_gather_cat(torch.tensor([[float(r)]]), mesh, "tp", dim=1).tolist(),
           "gather_uneven": all_gather_cat(torch.arange(3 if mesh.index("tp") + 1 < mesh.tp
                                                        else 2) + 10 * mesh.index("tp"),
                                           mesh, "tp", total=3 * mesh.tp - 1).tolist(),
           "gather_dp": all_gather_cat(torch.tensor([r]), mesh, "dp").tolist(),
           "bcast": broadcast(torch.tensor([r * 7]), mesh).tolist(),
           "objects_dp": all_gather_objects({"r": r}, mesh, "dp")}
    return out


def _whisper_tokens(params, config, mel, mesh, opts) -> list:
    tok = make_synthetic_tokenizer()
    p, c = shard_model(params, config, mesh)
    res = decode(p, shard_batch(torch.from_numpy(mel), mesh), tok, c, opts)
    return [r.tokens for part in all_gather_objects(res, mesh, "dp") for r in part]


def _whisper_logits(params, config, mel, tokens, mesh) -> np.ndarray:
    p, c = shard_model(params, config, mesh)
    states = tw.encode(p, torch.from_numpy(mel), c)
    cache = tw.init_kv_cache(c, tokens.shape[0], "cpu", max_len=8)
    logits, _ = tw.decode_step(p, torch.from_numpy(tokens), 0, cache,
                               tw.cross_kv(p, states, c), c)
    return logits.numpy()


def _qwen_logits(params, config, tokens, mesh) -> list[np.ndarray]:
    """Prefill of ``tokens[:, :-1]``, then one step on the last token."""
    p, c = shard_qwen_model(params, config, mesh)
    cache = tqw.init_kv_cache(c, 1, 16)
    toks = torch.from_numpy(tokens)
    first, _ = tqw.decode_step(p, toks[:, :-1], 0, cache, c)
    step, _ = tqw.decode_step(p, toks[:, -1:], toks.shape[1] - 1, cache, c)
    return [first.numpy(), step.numpy()]


def four_ranks(rank: int, world: int, coordinator: str, *, whisper_tiny, qwen_tiny,
               whisper_uneven) -> dict:
    """dp 2 x tp 2: the collectives, tiny whisper's tokens; dp 1 x tp 4: a
    tiny Qwen whose row-split leaves stay whole, and whisper's uneven
    vocabulary split."""
    _join(rank, world, coordinator)
    try:
        mesh = make_mesh(dp=2, tp=2)
        out = {"collectives": _collectives(mesh)}
        params, config, mel, opts = whisper_tiny
        out["whisper_dp2_tp2"] = _whisper_tokens(params, config, mel, mesh, opts)
        tp4 = make_mesh(dp=1, tp=4)
        out["collectives_tp4"] = _collectives(tp4)
        params, config, tokens = qwen_tiny
        out["qwen_tp4"] = _qwen_logits(params, config, tokens, tp4)
        params, config, mel, tokens = whisper_uneven
        out["whisper_uneven_tp4"] = _whisper_logits(params, config, mel, tokens, tp4)
        return out
    finally:
        dist.destroy_process_group()


def two_ranks(rank: int, world: int, coordinator: str, *, whisper_tiny, beam_opts,
              whisper_wide, qwen_cases, transcribe_case, batcher_case) -> dict:
    """Two ranks at dp 2 and at tp 2: whisper decodes, Qwen logits, the
    batched transcribe and the batcher."""
    _join(rank, world, coordinator)
    try:
        dp2, tp2 = make_mesh(dp=2, tp=1), make_mesh(dp=1, tp=2)
        out = {"collectives": _collectives(tp2)}
        params, config, mel, opts = whisper_tiny
        for name, mesh in (("dp2", dp2), ("tp2", tp2)):
            for kv in (0, 8):
                cfg = dataclasses.replace(config, kv_bits=kv, self_kv_bits=kv)
                out[f"whisper_{name}_kv{kv}"] = _whisper_tokens(params, cfg, mel, mesh, opts)
            out[f"whisper_{name}_beam"] = _whisper_tokens(params, config, mel, mesh, beam_opts)
        params, config, mel, opts = whisper_wide
        out["whisper_wide_tp2"] = _whisper_tokens(params, config, mel, tp2, opts)
        for key, (params, config, tokens) in qwen_cases.items():
            out[f"qwen_{key}"] = _qwen_logits(params, config, tokens, tp2)

        params, config, audio, kw = transcribe_case
        for label, mesh in (("dp2", dp2), ("tp2", tp2)):
            for temps in ((0.0,), (0.0, 1.0)):
                got = transcribe(audio, params=params, config=config,
                                 tokenizer=make_synthetic_tokenizer(), device="cpu",
                                 temperature=temps, mesh=mesh, **kw)
                out[f"transcribe_{label}_{len(temps)}"] = got["segments"]
        words = transcribe(audio, params=params, config=config,
                           tokenizer=make_synthetic_tokenizer(), device="cpu", temperature=0.0,
                           mesh=tp2, word_timestamps=True, **kw)
        out["transcribe_tp2_words"] = words["segments"]

        params, config, audios, kw = batcher_case
        batcher = TranscriptionBatcher(params, config, make_synthetic_tokenizer(),
                                       device="cpu", mesh=dp2, **kw)
        out["batcher_buckets"] = batcher.buckets
        if rank == 0:
            async def burst():
                res = await asyncio.gather(*(batcher.transcribe(a) for a in audios))
                try:  # the second batch raises on rank 1
                    await batcher.transcribe(audios[1])
                    failed = None
                except RuntimeError as exc:
                    failed = f"{type(exc).__name__}: {exc}"
                again = await batcher.transcribe(audios[1])
                batcher.shutdown()
                return res, failed, again

            out["batcher"], out["batcher_failed"], out["batcher_again"] = asyncio.run(burst())
            out["batcher_stats"] = dict(batcher.stats)
        else:
            real, calls = batcher._decode_slice, []

            def flaky(mel):
                calls.append(1)
                if len(calls) == 2:
                    raise ValueError("a fault on the follower")
                return real(mel)

            batcher._decode_slice = flaky
            out["batcher_followed"] = batcher.follow()
        return out
    finally:
        dist.destroy_process_group()

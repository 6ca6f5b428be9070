"""Continuous batching: many chat requests share one resident decode batch.

Counterpart of ``whisper_mlx_tpu/inference/batch_engine.py``. The engine
keeps S decode slots on the device: one step advances every slot together
(per-row positions through ``models.qwen.decode_step``); a new request
joins mid-flight by prefilling through a fresh one-row cache at position 0
(kernel K4 on the card) whose rows are then copied into its slot; a
finished request frees its slot at its stop token.

A single worker thread owns the device state and runs admit -> step ->
drain, pipelined by one step: step ``i + 1`` is dispatched before step
``i``'s tokens are read back. Per-request temperature is honored per slot;
top_p/top_k are engine-level. Slot positions are kept on the host (every
slot advances one position a step, as the reference's do), so the decode
step reads only cache positions below the largest of them. If the worker
dies, every waiter is closed and the exception re-raised in the thread.
"""

from __future__ import annotations

import itertools
import queue
import threading
from dataclasses import dataclass, field
from typing import Iterator

import numpy as np
import torch

from whisper_mlx_tpu_torch.inference.generate import (
    check_opt_ins,
    default_stop_ids,
    params_device,
    sample_token,
)
from whisper_mlx_tpu_torch.models.qwen import Params, QwenConfig, decode_step, init_kv_cache


@dataclass
class _Request:
    rid: int
    prompt_ids: list[int]
    max_tokens: int
    temperature: float
    out: "queue.SimpleQueue[int | None]" = field(default_factory=queue.SimpleQueue)
    emitted: int = 0
    cancelled: bool = False
    done: bool = False  # emission closed (worker side)


class RequestHandle:
    """Consumer side of one in-flight request."""

    def __init__(self, req: _Request, tokenizer):
        self._req = req
        self._tokenizer = tokenizer

    def tokens(self) -> Iterator[int]:
        """Blocking iterator over generated token ids (stop token excluded)."""
        while True:
            tok = self._req.out.get()
            if tok is None:
                return
            yield tok

    def text_stream(self) -> Iterator[str]:
        """Decoded text increments (LLMEngine.stream_generate's UTF-8 rule)."""
        out: list[int] = []
        sent = 0
        for tok in self.tokens():
            out.append(tok)
            text = self._tokenizer.decode(out)
            if not text.endswith("�") and len(text) > sent:
                yield text[sent:]
                sent = len(text)

    def result_text(self) -> str:
        return "".join(self.text_stream())

    def cancel(self) -> None:
        self._req.cancelled = True


class ContinuousBatchEngine:
    """S-slot resident decode batch with mid-flight admission."""

    PROMPT_BUCKET = 128

    def __init__(self, params: Params, config: QwenConfig, tokenizer, *, slots: int = 4,
                 max_len: int = 4096, top_p: float = 1.0, top_k: int = 0,
                 stop_ids: "set[int] | None" = None):
        check_opt_ins()
        self.params = params
        self.config = config
        self.tokenizer = tokenizer
        self.slots = slots
        self.max_len = max_len
        self.top_p = top_p
        self.top_k = top_k
        self.device = params_device(params)
        self._stop_ids = set(stop_ids) if stop_ids else set(default_stop_ids(tokenizer))
        self._stop_arr = torch.tensor(sorted(self._stop_ids), device=self.device)

        # device state, owned by the worker thread; positions on the host
        self._cache = init_kv_cache(config, slots, max_len, self.device)
        self._logits = torch.zeros((slots, config.vocab_size), device=self.device)
        self._pos = np.zeros(slots, np.int64)
        self._gen = torch.Generator(device=self.device).manual_seed(0)

        self._slot_req: list[_Request | None] = [None] * slots
        self._pending: "queue.SimpleQueue[_Request]" = queue.SimpleQueue()
        self._wakeup = threading.Event()
        self._shutdown = False
        self._ids = itertools.count()
        self._steps = 0  # batch steps run (telemetry, tests)
        self._step_occupancy: list[int] = []  # active slots per step (tests)
        self._worker = threading.Thread(target=self._worker_loop, name="llm-batch-worker",
                                        daemon=True)
        self._worker.start()

    # -- public API ------------------------------------------------------------

    def submit(self, prompt: "str | list[int]", max_tokens: int = 512,
               temperature: float = 0.7) -> RequestHandle:
        ids = self.tokenizer.encode(prompt) if isinstance(prompt, str) else list(prompt)
        if not ids:
            raise ValueError("submit() requires a non-empty prompt")
        ids = ids[-(self.max_len - 64):]
        max_tokens = max(1, min(max_tokens, self.max_len - len(ids)))
        req = _Request(next(self._ids), ids, max_tokens, float(temperature))
        self._pending.put(req)
        self._wakeup.set()
        return RequestHandle(req, self.tokenizer)

    def generate_text(self, prompt, max_tokens: int = 512, temperature: float = 0.7) -> str:
        return self.submit(prompt, max_tokens, temperature).result_text()

    def close(self) -> None:
        self._shutdown = True
        self._wakeup.set()
        self._worker.join(timeout=10)

    @property
    def alive(self) -> bool:
        return self._worker.is_alive()

    # -- worker ----------------------------------------------------------------

    def _bucket(self, ids: list[int]) -> tuple[list[int], int]:
        true_len = len(ids)
        bucket = min(-(-true_len // self.PROMPT_BUCKET) * self.PROMPT_BUCKET, self.max_len)
        return ids + [0] * (bucket - true_len), true_len

    def _prefill_slot(self, slot: int, ids: list[int]) -> None:
        """Prefill one prompt through a fresh one-row cache at position 0,
        then copy that row into ``slot``; the other slots are untouched."""
        padded, true_len = self._bucket(ids)
        row_cache = init_kv_cache(self.config, 1, self.max_len, self.device)
        lg, row_cache = decode_step(self.params, torch.tensor([padded], device=self.device), 0,
                                    row_cache, self.config)
        for big, row in zip(self._cache, row_cache):
            for key in big:
                big[key][slot].copy_(row[key][0])
        self._logits[slot] = lg[0, true_len - 1].float()
        self._pos = self._pos.copy()  # the batch in flight holds the old array
        self._pos[slot] = true_len

    def _batch_step(self, temps: np.ndarray):
        """Sample one token per slot, then advance every slot one position."""
        tok = sample_token(self._logits, self._gen, temps, self.top_p, self.top_k)
        is_stop = torch.isin(tok, self._stop_arr)
        logits, self._cache = decode_step(self.params, tok[:, None], self._pos.tolist(),
                                          self._cache, self.config)
        self._logits = logits[:, -1].float()
        self._pos = self._pos + 1
        return tok, is_stop, self._pos

    def _admit(self) -> None:
        while None in self._slot_req:
            try:
                req = self._pending.get_nowait()
            except queue.Empty:
                return
            if req.cancelled:
                req.out.put(None)
                continue
            slot = self._slot_req.index(None)
            self._prefill_slot(slot, req.prompt_ids)
            self._slot_req[slot] = req

    def _finish(self, slot: int) -> None:
        req = self._slot_req[slot]
        if req is not None and not req.done:
            req.done = True
            req.out.put(None)
        self._slot_req[slot] = None

    def _close_pending(self) -> None:
        while True:
            try:
                self._pending.get_nowait().out.put(None)
            except queue.Empty:
                return

    def _worker_loop(self) -> None:
        try:
            self._run()
        except BaseException:  # release every waiter, then re-raise
            for i in range(self.slots):
                self._finish(i)
            self._close_pending()
            raise

    def _run(self) -> None:
        # Pipelined by one step: the lag means a slot that stops at step i
        # still computes a throwaway token at step i + 1; emission captures
        # request objects at dispatch time, so a slot re-admitted in between
        # never receives a stale token.
        in_flight = None  # (tok, is_stop, pos after the step, [(slot, req), ...])

        def drain(batch) -> None:
            tok_dev, stop_dev, pos_np, slot_reqs = batch
            tok_np = tok_dev.cpu().numpy()
            stop_np = stop_dev.cpu().numpy()
            for i, req in slot_reqs:
                if req.done:
                    continue  # stopped at the previous step; stale token
                if req.cancelled or stop_np[i]:
                    if self._slot_req[i] is req:
                        self._finish(i)
                    else:
                        req.done = True
                        req.out.put(None)
                    continue
                req.out.put(int(tok_np[i]))
                req.emitted += 1
                if req.emitted >= req.max_tokens or pos_np[i] >= self.max_len - 1:
                    if self._slot_req[i] is req:
                        self._finish(i)
                    else:
                        req.done = True
                        req.out.put(None)

        while not self._shutdown:
            if not any(self._slot_req) and self._pending.empty() and in_flight is None:
                self._wakeup.wait(timeout=0.2)
                self._wakeup.clear()
                continue
            self._admit()
            active = [i for i, r in enumerate(self._slot_req) if r is not None]
            next_flight = None
            if active:
                temps = np.zeros(self.slots, np.float32)
                for i in active:
                    temps[i] = self._slot_req[i].temperature
                tok, is_stop, pos = self._batch_step(temps)
                self._steps += 1
                self._step_occupancy.append(len(active))
                next_flight = (tok, is_stop, pos, [(i, self._slot_req[i]) for i in active])
            if in_flight is not None:
                drain(in_flight)
            in_flight = next_flight

        # shutdown: deliver the batch in flight, then close every consumer
        if in_flight is not None:
            drain(in_flight)
        for i in range(self.slots):
            self._finish(i)
        self._close_pending()

"""Cross-request window batching for transcription serving.

Counterpart of ``whisper_mlx_tpu/runtime/batcher.py``. A decode step for 8
windows costs about what one costs, so the serving path batches windows
across requests:

    request A (90 s audio) -> 3 windows ┐
    request B (30 s audio) -> 1 window  ├─> one batch of <= B windows
    request C (60 s audio) -> 2 windows ┘   -> one encode + one decode loop

Each request's mel is computed on the device (kernel K1) over its audio
plus a 30 s tail padded on the device; its windows are device slices and
are never fetched to the host. One worker drains a queue of window jobs,
stacks a batch on the device, pads it to the smallest bucket that fits,
encodes and decodes it, and resolves each request as its windows complete.
The flush is adaptive (see ``_run``): while batch i runs in a worker
thread, batch i+1 is collected.

Semantics match ``transcribe(batch_windows=True)`` at one rung: fixed-stride
windows, no conditioning on previous text (the reference launcher's
configuration), ``decoding`` for every window.

The buckets and the flush deadlines default to the serving knobs
(``runtime/serving_config.py``: WTPU_TRANSCRIBE_BATCH, SERVE_WAIT_MS,
SERVE_IDLE_GAP_MS).

Data parallelism over windows (``mesh=``, ``parallel/mesh.py``): every
rank of the job builds a batcher with the same arguments. Rank 0 holds the
request queue and computes the mel; the other ranks call :meth:`follow`,
which returns after :meth:`shutdown` on rank 0. The buckets are rounded up
to multiples of dp. Each flush broadcasts its bucket and mel to every rank,
each rank encodes and decodes its contiguous dp slice (a tensor-parallel
tree splits each step besides), and rank 0 gathers the results in rank
order and resolves the requests. A batch that raises on any rank fails on
every rank (:class:`RankFailure`, gathered with the results): rank 0 fails
its requests, and the followers go on to the next batch.
"""

from __future__ import annotations

import asyncio
import threading
import time
from dataclasses import dataclass, field
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from whisper_mlx_tpu_torch.audio.mel import N_FRAMES, N_SAMPLES, log_mel_spectrogram
from whisper_mlx_tpu_torch.decoding.task import DecodingOptions, decode
from whisper_mlx_tpu_torch.inference.transcribe import window_segments
from whisper_mlx_tpu_torch.models.whisper import encode
from whisper_mlx_tpu_torch.ops.quant import maybe_dense_decode_params
from whisper_mlx_tpu_torch.parallel.mesh import Mesh, all_gather_objects, broadcast
from whisper_mlx_tpu_torch.parallel.sharding import dp_round, shard_batch, shard_model
from whisper_mlx_tpu_torch.runtime.device import device_context, setup_device
from whisper_mlx_tpu_torch.runtime.serving_config import (
    serving_batch_buckets,
    serving_flush_knobs,
)

# the header rank 0 broadcasts before each batch: (command, bucket, frames, mels)
_STOP, _BATCH = 0, 1


class RankFailure(RuntimeError):
    """A batch raised on one or more ranks of the batcher's job; every rank
    raises it for that batch."""


@dataclass
class _WindowJob:
    request_id: int
    window_idx: int
    mel: torch.Tensor  # (3000, n_mels) on the device, never fetched to the host


@dataclass
class _Request:
    n_windows: int
    done: asyncio.Future
    events: asyncio.Queue  # per-window completions (streaming)
    results: dict[int, Any] = field(default_factory=dict)


class TranscriptionBatcher:
    """Cross-request window batcher over one whisper model on ``device``
    (``params`` must live there)."""

    def __init__(
        self,
        params,
        config,
        tokenizer,
        *,
        device: torch.device | str,
        batch_size: int | tuple[int, ...] | list[int] | None = None,
        max_wait_ms: float | None = None,
        decoding: DecodingOptions | None = None,
        mesh=None,
        idle_gap_ms: float | None = None,
    ) -> None:
        if mesh is not None and not isinstance(mesh, Mesh):
            raise TypeError(f"mesh=: expected a parallel.mesh.Mesh, got {type(mesh).__name__}")
        self.device = setup_device(device)
        if batch_size is None:
            batch_size = serving_batch_buckets(self.device)
        wait_ms, gap_ms = serving_flush_knobs()
        self.mesh = mesh
        self.params, self.config = shard_model(params, config, mesh)
        self.tokenizer = tokenizer
        # each bucket is one batch shape; a flush rides the smallest that
        # fits its jobs, so a lone short request does not pay the largest;
        # under a mesh each divides evenly over "dp"
        if isinstance(batch_size, int):
            batch_size = (batch_size,)
        self.buckets = tuple(sorted({dp_round(b, mesh) for b in batch_size}))
        self.batch_size = self.buckets[-1]
        self.max_wait_ms = wait_ms if max_wait_ms is None else max_wait_ms
        self.idle_gap_ms = gap_ms if idle_gap_ms is None else idle_gap_ms
        self.decoding = decoding or DecodingOptions()
        self._queue: asyncio.Queue[_WindowJob] = asyncio.Queue()
        self._requests: dict[int, _Request] = {}
        self._next_id = 0
        self._worker: asyncio.Task | None = None
        self.stats = {"batches": 0, "windows": 0, "fill_sum": 0.0}
        # the ranks' collectives run one batch (or the stop) at a time
        self._ranks = mesh.dp * mesh.tp if mesh is not None else 1
        self._collective = threading.Lock()
        self._stopped = False

    # -- public API ---------------------------------------------------------

    async def transcribe(self, audio: np.ndarray) -> dict[str, Any]:
        """Enqueue every window of ``audio`` (f32, or int16 from
        ``audio/decode.py:load_audio_serving``); resolves when all are
        decoded, with ``{"text", "segments", "language"}``. Raises the
        worker's exception if a batch it rode in failed (the next request
        restarts the worker)."""
        req_id, request = await self._enqueue(audio)
        try:
            results = await request.done
        finally:
            del self._requests[req_id]
        # segment assembly is host work: off the loop, which keeps
        # collecting and flushing batches for the other requests meanwhile
        return await asyncio.to_thread(self._assemble, results)

    async def stream_transcribe(self, audio: np.ndarray):
        """Yield each window's segments as soon as that window decodes."""
        req_id, request = await self._enqueue(audio)
        try:
            emitted = 0
            while emitted < request.n_windows:
                item = await request.events.get()
                if isinstance(item, BaseException):  # worker failure
                    raise item
                emitted += 1
                w, result = item
                partial = self._assemble({w: result})
                yield {"window": w, "of": request.n_windows,
                       "segments": partial["segments"], "text": partial["text"]}
        finally:
            del self._requests[req_id]

    def shutdown(self) -> None:
        """Stop the worker; under a mesh of several ranks also release the
        followers (after the batch in flight, if any)."""
        if self._worker is not None:
            self._worker.cancel()
            self._worker = None
        if self._ranks > 1 and self.mesh.rank == 0 and not self._stopped:
            with self._collective, device_context(self.device):
                self._stopped = True
                self._send(_STOP)

    def follow(self) -> int:
        """A follower rank's loop: run each batch rank 0 broadcasts, until
        its stop. -> the number of batches run."""
        if self._ranks == 1 or self.mesh.rank == 0:
            raise RuntimeError("follow(): rank 0 of a mesh of several ranks holds the queue")
        n = 0
        with device_context(self.device), torch.inference_mode():
            while True:
                header = broadcast(torch.zeros(4, dtype=torch.int64, device=self.device),
                                   self.mesh)
                cmd, bucket, frames, mels = header.tolist()
                if cmd == _STOP:
                    return n
                mel = broadcast(torch.empty((bucket, frames, mels), device=self.device),
                                self.mesh)
                try:
                    self._run_slice(mel)
                except RankFailure:
                    continue  # rank 0 fails the batch's requests
                n += 1

    def _send(self, cmd: int, mel: torch.Tensor | None = None) -> None:
        shape = tuple(mel.shape) if mel is not None else (0, 0, 0)
        broadcast(torch.tensor([cmd, *shape], dtype=torch.int64, device=self.device),
                  self.mesh)
        if mel is not None:
            broadcast(mel.float().contiguous(), self.mesh)

    # -- enqueue ------------------------------------------------------------

    def _windows(self, audio: np.ndarray) -> torch.Tensor:
        """(n_windows, 3000, n_mels) device slices of the request's mel."""
        with device_context(self.device), torch.inference_mode():
            audio = np.asarray(audio)
            if audio.dtype == np.int16:
                # half the bytes up; /2^15 is exact in f32 (a power of two's
                # reciprocal), so this equals the host conversion bit for bit
                dev = torch.from_numpy(audio).to(self.device).float() / 32768.0
            else:
                dev = torch.from_numpy(np.asarray(audio, np.float32)).to(self.device)
            mel_all = log_mel_spectrogram(F.pad(dev, (0, N_SAMPLES)), n_mels=self.config.n_mels)
            content_frames = max(mel_all.shape[0] - N_FRAMES, 1)
            n_windows = max(1, -(-content_frames // N_FRAMES))
            # the 30 s tail makes every slice full length (mel of silence in
            # the overhang, as the offline path has)
            return mel_all[: n_windows * N_FRAMES].reshape(n_windows, N_FRAMES, -1)

    async def _enqueue(self, audio: np.ndarray) -> tuple[int, _Request]:
        if self._ranks > 1 and self.mesh.rank != 0:
            raise RuntimeError("a follower rank takes no requests: call follow()")
        self._ensure_worker()
        windows = self._windows(audio)
        req_id = self._next_id
        self._next_id += 1
        loop = asyncio.get_running_loop()
        request = _Request(n_windows=windows.shape[0], done=loop.create_future(),
                           events=asyncio.Queue())
        self._requests[req_id] = request
        for w in range(windows.shape[0]):
            await self._queue.put(_WindowJob(request_id=req_id, window_idx=w, mel=windows[w]))
        return req_id, request

    # -- worker -------------------------------------------------------------

    def _ensure_worker(self) -> None:
        if self._worker is None or self._worker.done():
            self._worker = asyncio.get_running_loop().create_task(self._run())

    async def _run(self) -> None:
        # batch i runs in a worker thread while batch i+1 is collected; at
        # most one batch is in flight
        pending: asyncio.Task | None = None
        try:
            while True:
                jobs = [await self._first_job(pending)]
                # Adaptive flush, three regimes:
                # - device busy (a batch in flight): keep collecting
                #   until the batch is full or the device frees up, since a
                #   partial flush would only queue behind the running batch;
                # - device idle, fill within the smallest bucket (a lone
                #   request): flush idle_gap_ms after the last arrival;
                # - device idle, fill past the smallest bucket (a burst
                #   ramping up): hold to the max_wait_ms deadline, so that a
                #   gap in the arrivals does not flush a partial batch.
                # After a busy wait the deadline is re-armed with a short
                # grace, so that stragglers still join.
                deadline = time.monotonic() + self.max_wait_ms / 1000.0
                idle_gap = self.idle_gap_ms / 1000.0
                was_busy = False
                while len(jobs) < self.batch_size:
                    busy = pending is not None and not pending.done()
                    if busy:
                        timeout = 0.02  # poll tick
                    else:
                        if was_busy:  # device just freed: straggler grace
                            deadline = max(deadline, time.monotonic() + 2 * idle_gap)
                        remaining = deadline - time.monotonic()
                        if remaining <= 0 and self._queue.empty():
                            break
                        timeout = max(min(idle_gap, remaining), 0.001)
                    was_busy = busy
                    try:
                        jobs.append(await asyncio.wait_for(self._queue.get(), timeout=timeout))
                    except asyncio.TimeoutError:
                        if busy:
                            continue
                        if len(jobs) <= self.buckets[0] or deadline - time.monotonic() <= 0:
                            break  # lone-request plateau or hard deadline
                if pending is not None:
                    await pending
                pending = asyncio.create_task(asyncio.to_thread(self._run_batch, jobs))
        except asyncio.CancelledError:
            raise
        except Exception as exc:  # noqa: BLE001 - the waiters carry it
            # a failed batch must not strand its waiters: fail every
            # incomplete request and end; the next enqueue restarts the
            # worker, and queued jobs of failed requests are skipped
            self._fail_incomplete(exc)
            pending = None  # the failed batch: its exception is reported
        finally:
            if pending is not None:
                try:
                    await pending
                except Exception as exc:  # noqa: BLE001
                    self._fail_incomplete(exc)

    async def _first_job(self, pending: asyncio.Task | None) -> _WindowJob:
        """The next job; raises the exception of a batch that failed first."""
        while pending is not None and not pending.done():
            try:
                return await asyncio.wait_for(self._queue.get(), timeout=0.02)
            except asyncio.TimeoutError:
                continue
        if pending is not None:
            await pending
        return await self._queue.get()

    def _fail_incomplete(self, exc: BaseException) -> None:
        for request in self._requests.values():
            if not request.done.done():
                request.done.set_exception(exc)
                # streaming consumers read .events, never .done: retrieve
                # the exception so that it is not logged as never retrieved
                request.done.exception()
            request.events.put_nowait(exc)

    def _bucket(self, real: int) -> int:
        return next(b for b in self.buckets if b >= real)

    def _run_batch(self, jobs: list[_WindowJob]) -> None:
        self._complete(jobs, self._launch(jobs))

    def _launch(self, jobs: list[_WindowJob]) -> list:
        """Encode and decode one padded window batch -> its results."""
        with device_context(self.device), torch.inference_mode():
            real = len(jobs)
            bucket = self._bucket(real)
            mel = torch.stack([j.mel for j in jobs])
            if real < bucket:
                mel = F.pad(mel, (0, 0, 0, 0, 0, bucket - real))
            if self._ranks == 1:
                return self._run_slice(mel)
            with self._collective:
                if self._stopped:
                    raise RuntimeError("the batcher's ranks were stopped")
                self._send(_BATCH, mel)
                return self._run_slice(mel)

    def _run_slice(self, mel: torch.Tensor) -> list:
        """Encode and decode this rank's dp slice of a padded batch -> the
        whole batch's results, gathered over dp in rank order. Each rank's
        error, if any, is gathered with them, so that a failure on one rank
        raises :class:`RankFailure` on all."""
        if self._ranks == 1:
            return self._decode_slice(mel)
        try:
            out, err = self._decode_slice(mel), None
        except Exception as exc:  # noqa: BLE001 - reported to every rank below
            out, err = None, f"{type(exc).__name__}: {exc}"
        parts = all_gather_objects((err, out), self.mesh, None)
        failed = [f"rank {r}: {e}" for r, (e, _) in enumerate(parts) if e is not None]
        if failed:
            raise RankFailure("the batch failed on " + "; ".join(failed))
        # ranks in order; one rank of each tp group holds its dp slice's results
        return [r for _, out in parts[::self.mesh.tp] for r in out]

    def _decode_slice(self, mel: torch.Tensor) -> list:
        """This rank's dp slice of a padded batch, encoded and decoded."""
        bucket = mel.shape[0]
        # a packed tree is dequantized once (cached) by the encoder's
        # rows, and the decode loop rides the same dense tree
        params = maybe_dense_decode_params(self.params, rows=bucket * mel.shape[1],
                                           dtype=self.config.dtype)
        local = shard_batch(mel, self.mesh)
        states = encode(params, local, self.config)
        rows = None
        if self.mesh is not None:
            rows = (self.mesh.index("dp") * local.shape[0], bucket)
        return decode(params, states, self.tokenizer, self.config, self.decoding,
                      states_precomputed=True, rows=rows)

    def _complete(self, jobs: list[_WindowJob], results: list) -> None:
        real = len(jobs)
        self.stats["batches"] += 1
        self.stats["windows"] += real
        self.stats["fill_sum"] += real / self._bucket(real)
        for job, result in zip(jobs, results[:real]):
            request = self._requests.get(job.request_id)
            if request is None:  # a failed request's stale job
                continue
            request.results[job.window_idx] = result
            loop = request.done.get_loop()
            loop.call_soon_threadsafe(request.events.put_nowait, (job.window_idx, result))
            if len(request.results) == request.n_windows and not request.done.done():
                loop.call_soon_threadsafe(request.done.set_result, dict(request.results))

    # -- assembly -----------------------------------------------------------

    def _assemble(self, results: dict[int, Any]) -> dict[str, Any]:
        segments = []
        for w in sorted(results):
            segments += window_segments(results[w], w, len(segments), self.tokenizer,
                                        self.config)
        return {
            "text": "".join(s.text for s in segments),
            "segments": [s.to_dict() for s in segments],
            "language": self.tokenizer.language,
        }

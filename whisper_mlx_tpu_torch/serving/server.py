"""HTTP daemon of the PyTorch port.

Counterpart of ``whisper_mlx_tpu/serving/server.py``, the reference's
FastAPI surface rebuilt on aiohttp, with the same endpoints, wire format and
queue contract, serving on one torch device:

    python -m whisper_mlx_tpu_torch.serving.server --whisper-model DIR|large-v3 \
        [--device cuda] [--batch-slots N] [--ui] [--port 5997]

``--device`` defaults to ``cuda`` and the server exits when no GPU is
present: it never serves on the CPU unless asked (``--device cpu``). The
ASR model loads through ``cli.load_model`` on that device and takes the
serving configuration (``runtime/serving_config.py``: bf16, flash, int4
cross and int8 self caches on CUDA); ``/v1/transcribe`` without options
rides ``runtime/batcher.py:TranscriptionBatcher`` (kernels K1-K3), which
reads its own buckets and flush knobs. ``/v1/chat`` runs the chat service
(``serving/chat.py``) on the LLM engine (kernels K4, K5) on the same
device. Chats, transcriptions with options and model loads run in worker
threads, each setting the server's device as its own.

With ``WTPU_SERVE_DP`` of n >= 2 (``runtime/serving_config.py``) the daemon
is rank 0 of a job of n ranks: at startup it starts the n - 1 follower
ranks (this module with ``--asr-rank``), each of which loads the same model
through ``cli.load_model``, applies the serving configuration on its own
device (``cuda:r``, or the CPU) and runs the batcher's follower loop; the
batcher then splits each flushed window batch over the ranks
(``runtime/batcher.py``). Startup waits until every follower has loaded the
model and fails as soon as one exits; a batch that raises on any rank fails
its requests and the ranks go on. The followers end when the daemon's
cleanup stops the batcher.

Endpoint parity (reference :420-975):
    GET  /health                         — model/queue/profile/tool state
    GET  /v1/tools                       — tool specs
    GET  /v1/tools/{name}
    POST /v1/tools/{name}/invoke         — direct tool execution (no LLM)
    POST /v1/invoke-tool                 — legacy alias
    GET  /v1/profiles, /v1/profiles/{name}
    GET  /v1/profiles/{name}/tools       — ToolInfo list (reference :549-563)
    POST /v1/chat                        — stateless chat
    POST /v1/sessions                    — create
    GET  /v1/sessions                    — summaries
    GET  /v1/sessions/{id}, DELETE /v1/sessions/{id}
    POST /v1/sessions/{id}/chat          — session chat (queued)
    POST /v1/sessions/{id}/chat/stream   — SSE agent events
    GET  /v1/generation/status           — live queue state
    POST /v1/transcribe                  — whisper ASR (BASELINE config 5:
                                           quantized large-v3 behind the API)

Concurrency model: the reference serializes generation behind one
``asyncio.Lock`` with queue bookkeeping under a ``threading.Lock``
(reference :273-355) and surfaces ``queue_stats`` {was_queued,
queue_wait_ms, queue_position} per request (:212-233). That contract —
including the cooperative-yield race fix (reference :853 and
``tests/test_queue_race.py:3-15``) — is preserved here; continuous batching
across requests happens *below* this layer in the batched decode path.
"""

from __future__ import annotations

import argparse
import asyncio
import copy
import json
import logging
import threading
import time
import uuid
from typing import Any

import torch
from aiohttp import web

from whisper_mlx_tpu_torch.runtime.device import device_context, setup_device
from whisper_mlx_tpu_torch.serving.chat import ChatMessage, ChatService, ModelSize, create_chat_service
from whisper_mlx_tpu_torch.serving.profiles import ALL_PROFILES, get_profile
from whisper_mlx_tpu_torch.serving.sessions import get_session_store
from whisper_mlx_tpu_torch.serving.tools.registry import get_registry

logger = logging.getLogger("qwen.server")

GENERATION_TIMEOUT_S = 1800  # reference server.py:742,789


class AppState:
    """Generation guard + queue bookkeeping (reference server.py:273-355).

    Default (``batch_slots=1``) keeps the reference's single-writer lock.
    With ``batch_slots=N`` (env QWEN_BATCH_SLOTS / --batch-slots) the guard
    becomes an N-slot semaphore and generation routes through the continuous
    batching engine (inference/batch_engine.py) — N chats overlap on one
    resident decode batch. The ``queue_stats`` wire contract is unchanged:
    ``queue_position`` = requests ahead at arrival, ``active`` = oldest
    in-flight request id (or null).
    """

    def __init__(self, batch_slots: int = 1, device: str | torch.device = "cuda") -> None:
        self.batch_slots = max(1, batch_slots)
        self.device = setup_device(device)
        self.generation_lock: Any = (
            asyncio.Lock() if self.batch_slots == 1
            else asyncio.Semaphore(self.batch_slots)
        )
        self._queue_lock = threading.Lock()
        self._queue: list[str] = []
        self._active: list[str] = []
        self._services: dict[str, ChatService] = {}
        self._service_lock = threading.Lock()
        self.started_at = time.time()
        self.model_loaded = False

    # queue bookkeeping (reference :307-335)
    def add_to_queue(self, request_id: str) -> int:
        """→ number of requests ahead (queued + active)."""
        with self._queue_lock:
            position = len(self._queue) + len(self._active)
            self._queue.append(request_id)
            return position

    def mark_active(self, request_id: str) -> None:
        with self._queue_lock:
            if request_id in self._queue:
                self._queue.remove(request_id)
            self._active.append(request_id)

    def finish(self, request_id: str) -> None:
        with self._queue_lock:
            if request_id in self._active:
                self._active.remove(request_id)
            if request_id in self._queue:
                self._queue.remove(request_id)

    def queue_snapshot(self) -> dict[str, Any]:
        with self._queue_lock:
            return {
                "active": self._active[0] if self._active else None,
                "queued": list(self._queue),
                "queue_length": len(self._queue),
            }

    def get_chat_service(self, model_size: str = "large") -> ChatService:
        with self._service_lock:
            if model_size not in self._services:
                t0 = time.perf_counter()
                self._services[model_size] = create_chat_service(ModelSize(model_size),
                                                                 device=self.device)
                logger.info("chat service %s created in %.1fs", model_size,
                            time.perf_counter() - t0)
            return self._services[model_size]


def _json(data: Any, status: int = 200) -> web.Response:
    return web.json_response(data, status=status)


def _safe_get_session(session_id: str):
    """Invalid (traversal-shaped) ids are a 404, not a 500."""
    try:
        return get_session_store().get(session_id)
    except ValueError:
        return None


def _error(message: str, status: int) -> web.Response:
    return web.json_response({"detail": message}, status=status)


# ---------------------------------------------------------------------------
# handlers
# ---------------------------------------------------------------------------


async def health(request: web.Request) -> web.Response:
    state: AppState = request.app["state"]
    registry = get_registry()
    return _json({
        "status": "ok",
        "uptime_seconds": time.time() - state.started_at,
        "model_loaded": state.model_loaded,
        "profiles": sorted(ALL_PROFILES),
        "tools_count": len(registry.available_tools),
        "queue": state.queue_snapshot(),
    })


async def list_tools(request: web.Request) -> web.Response:
    registry = get_registry()
    specs = []
    for name in registry.available_tools:
        t = registry.get(name)
        specs.append(t.spec.to_dict() if t else {"name": name, "error": "failed to load"})
    return _json({"tools": specs})


async def get_tool(request: web.Request) -> web.Response:
    name = request.match_info["name"]
    t = get_registry().get(name)
    if t is None:
        return _error(f"unknown tool: {name}", 404)
    return _json(t.spec.to_dict())


async def invoke_tool(request: web.Request) -> web.Response:
    name = request.match_info.get("name")
    try:
        body = await request.json()
    except json.JSONDecodeError:
        body = {}
    if name is None:  # legacy POST /v1/invoke-tool {tool_name, arguments}
        name = body.get("tool_name", "")
        args = body.get("arguments", {})
    else:
        args = body.get("arguments", body)
    registry = get_registry()
    if name not in registry.available_tools:
        return _error(f"unknown tool: {name}", 404)
    t0 = time.perf_counter()
    result = await registry.execute_async(name, args if isinstance(args, dict) else {})
    try:
        parsed: Any = json.loads(result)
    except json.JSONDecodeError:
        parsed = result
    return _json({
        "tool_name": name,
        "result": parsed,
        "latency_ms": (time.perf_counter() - t0) * 1000,
    })


async def list_profiles(request: web.Request) -> web.Response:
    return _json({"profiles": [p.to_dict() for p in ALL_PROFILES.values()]})


async def get_profile_handler(request: web.Request) -> web.Response:
    try:
        return _json(get_profile(request.match_info["name"]).to_dict())
    except ValueError as exc:
        return _error(str(exc), 404)


async def get_profile_tools(request: web.Request) -> web.Response:
    """Reference wire contract ``daemon/server.py:549-563``: a bare JSON
    array of ToolInfo {name, description, parameters} for the profile."""
    try:
        profile = get_profile(request.match_info["name"])
    except ValueError as exc:
        return _error(str(exc), 404)
    registry = get_registry()
    infos = []
    for tool_name in profile.tools:
        t = registry.get(tool_name)
        if t is not None:
            infos.append(t.spec.to_dict())
    return _json(infos)


def _queue_stats(was_queued: bool, wait_ms: float, position: int) -> dict[str, Any]:
    return {
        "was_queued": was_queued,
        "queue_wait_ms": wait_ms,
        "queue_position": position,
    }


async def stateless_chat(request: web.Request) -> web.Response:
    state: AppState = request.app["state"]
    try:
        body = await request.json()
    except json.JSONDecodeError:
        return _error("invalid JSON body", 400)
    message = body.get("message")
    if not message:
        return _error("'message' is required", 422)
    profile = body.get("profile", "general")
    if profile not in ALL_PROFILES:
        return _error(f"unknown profile: {profile}", 404)
    model_size = body.get("model_size", "large")
    if model_size not in ("small", "medium", "large"):
        return _error(f"unknown model_size: {model_size}", 422)

    request_id = uuid.uuid4().hex[:8]
    position = state.add_to_queue(request_id)
    await asyncio.sleep(0)  # cooperative yield (reference :853 race fix)
    t_queue = time.perf_counter()
    try:
        async with asyncio.timeout(GENERATION_TIMEOUT_S):
            async with state.generation_lock:
                wait_ms = (time.perf_counter() - t_queue) * 1000
                state.mark_active(request_id)
                service = state.get_chat_service(model_size)
                state.model_loaded = True
                history = [
                    ChatMessage(role=m["role"], content=m["content"])
                    for m in body.get("history", [])
                ]
                response = await service.chat_async(
                    message, profile_name=profile, history=history,
                    max_tokens=body.get("max_tokens"),
                    temperature=body.get("temperature"),
                )
    except TimeoutError:
        return _error("generation timed out", 503)
    finally:
        state.finish(request_id)

    return _json({
        "response": response.response,
        "thinking": list(response.thinking),
        "tool_results": [
            {"name": r.name, "arguments": r.arguments,
             "result": r.result, "latency_ms": r.latency_ms}
            for r in response.tool_results
        ],
        "rounds": response.rounds,
        "latency_ms": response.latency_ms,
        "queue_stats": _queue_stats(position > 0, wait_ms, position),
    })


# -- sessions ---------------------------------------------------------------


async def create_session(request: web.Request) -> web.Response:
    try:
        body = await request.json()
    except json.JSONDecodeError:
        body = {}
    profile = body.get("profile", "general")
    if profile not in ALL_PROFILES:
        return _error(f"unknown profile: {profile}", 404)
    model_size = body.get("model_size", "large")
    if model_size not in ("small", "medium", "large"):
        return _error(f"unknown model_size: {model_size}", 422)
    session = get_session_store().create(
        profile=profile, model_size=model_size,
        title=body.get("title", ""),
    )
    return _json(session.to_dict(), status=201)


async def list_sessions(request: web.Request) -> web.Response:
    return _json({"sessions": get_session_store().list_summaries()})


async def get_session(request: web.Request) -> web.Response:
    session = _safe_get_session(request.match_info["id"])
    if session is None:
        return _error("session not found", 404)
    return _json(session.to_dict())


async def delete_session(request: web.Request) -> web.Response:
    try:
        deleted = get_session_store().delete(request.match_info["id"])
    except ValueError:
        deleted = False
    if not deleted:
        return _error("session not found", 404)
    return _json({"deleted": True})


async def session_chat(request: web.Request) -> web.Response:
    state: AppState = request.app["state"]
    store = get_session_store()
    session = _safe_get_session(request.match_info["id"])
    if session is None:
        return _error("session not found", 404)
    try:
        body = await request.json()
    except json.JSONDecodeError:
        return _error("invalid JSON body", 400)
    message = body.get("message")
    if not message:
        return _error("'message' is required", 422)

    history = [ChatMessage(role=m.role, content=m.content) for m in session.messages]
    session.add_message("user", message)
    store.save(session)

    request_id = session.id
    position = state.add_to_queue(request_id)
    await asyncio.sleep(0)  # cooperative yield — race fix
    t_queue = time.perf_counter()
    try:
        async with asyncio.timeout(GENERATION_TIMEOUT_S):
            async with state.generation_lock:
                wait_ms = (time.perf_counter() - t_queue) * 1000
                state.mark_active(request_id)
                service = state.get_chat_service(session.model_size)
                state.model_loaded = True
                # per-session tool context: run_python assets land under the
                # session id (reference server.py:885, data_store.py:36-38)
                from whisper_mlx_tpu_torch.serving.tools.mirror.data_store import (
                    reset_session_context, set_session_context,
                )

                ctx_token = set_session_context(session.id)
                try:
                    response = await service.chat_async(
                        message, profile_name=session.profile, history=history,
                    )
                finally:
                    reset_session_context(ctx_token)
    except TimeoutError:
        return _error("generation timed out", 503)
    finally:
        state.finish(request_id)

    tool_results = [
        {"name": r.name, "arguments": r.arguments,
         "result": r.result, "latency_ms": r.latency_ms}
        for r in response.tool_results
    ]
    session.add_message("assistant", response.response, rounds=response.rounds,
                        tool_results=tool_results)
    store.save(session)
    return _json({
        "session": session.summary(),
        "response": response.response,
        "thinking": list(response.thinking),
        "tool_results": tool_results,
        "rounds": response.rounds,
        "latency_ms": response.latency_ms,
        "queue_stats": _queue_stats(position > 0, wait_ms, position),
    })


async def session_chat_stream(request: web.Request) -> web.StreamResponse:
    """SSE agent-event stream (reference :821-975): events pumped through an
    asyncio.Queue into ``data: {json}\\n\\n`` frames."""
    state: AppState = request.app["state"]
    store = get_session_store()
    session = _safe_get_session(request.match_info["id"])
    if session is None:
        return _error("session not found", 404)
    try:
        body = await request.json()
    except json.JSONDecodeError:
        return _error("invalid JSON body", 400)
    message = body.get("message")
    if not message:
        return _error("'message' is required", 422)

    history = [ChatMessage(role=m.role, content=m.content) for m in session.messages]
    session.add_message("user", message)
    store.save(session)

    request_id = session.id
    position = state.add_to_queue(request_id)
    await asyncio.sleep(0)  # cooperative yield — race fix

    resp = web.StreamResponse(headers={
        "Content-Type": "text/event-stream",
        "Cache-Control": "no-cache",
        "Connection": "keep-alive",
    })
    await resp.prepare(request)

    queue: asyncio.Queue = asyncio.Queue()

    async def emit(kind: str, data: dict[str, Any]) -> None:
        await queue.put({"event": kind, "timestamp": time.time(), **data})

    async def run() -> None:
        t_queue = time.perf_counter()
        try:
            async with asyncio.timeout(GENERATION_TIMEOUT_S):
                async with state.generation_lock:
                    wait_ms = (time.perf_counter() - t_queue) * 1000
                    state.mark_active(request_id)
                    service = state.get_chat_service(session.model_size)
                    state.model_loaded = True
                    from whisper_mlx_tpu_torch.serving.tools.mirror.data_store import (
                        reset_session_context, set_session_context,
                    )

                    ctx_token = set_session_context(session.id)
                    try:
                        response = await service.chat_async(
                            message, profile_name=session.profile,
                            history=history, on_event=emit,
                        )
                    finally:
                        reset_session_context(ctx_token)
            session.add_message("assistant", response.response, rounds=response.rounds)
            store.save(session)
            await queue.put({
                "event": "complete",
                "timestamp": time.time(),
                "session": session.summary(),
                "response": response.response,
                "rounds": response.rounds,
                "latency_ms": response.latency_ms,
                "queue_stats": _queue_stats(position > 0, wait_ms, position),
            })
        except TimeoutError:
            await queue.put({"event": "error", "detail": "generation timed out"})
        except Exception as exc:
            logger.exception("stream chat failed")
            await queue.put({"event": "error", "detail": str(exc)})
        finally:
            state.finish(request_id)
            await queue.put(None)  # sentinel

    task = asyncio.create_task(run())
    try:
        while True:
            item = await queue.get()
            if item is None:
                break
            await resp.write(f"data: {json.dumps(item)}\n\n".encode())
    finally:
        await task
    await resp.write_eof()
    return resp


async def generation_status(request: web.Request) -> web.Response:
    state: AppState = request.app["state"]
    return _json(state.queue_snapshot())


# -- transcription (BASELINE config 5) --------------------------------------


async def transcribe_endpoint(request: web.Request) -> web.Response:
    """POST /v1/transcribe — multipart audio file or {"path": ...} JSON."""
    app = request.app
    if app.get("asr") is None:
        return _error("no ASR model loaded (start with --whisper-model)", 503)
    params, config, tokenizer = app["asr"]

    import numpy as np

    from whisper_mlx_tpu_torch.audio.decode import load_audio_serving
    from whisper_mlx_tpu_torch.inference.transcribe import transcribe

    async def _load(path: str) -> np.ndarray:
        # one-read loader (raw-PCM16 passthrough when eligible — half the
        # device-upload bytes; f32 decode from the same parse otherwise),
        # in a thread so the event loop keeps serving concurrent requests
        # while this request's file I/O runs
        return await asyncio.to_thread(load_audio_serving, path)

    options: dict[str, Any] = {}
    audio = None
    try:
        if request.content_type and request.content_type.startswith("multipart/"):
            reader = await request.multipart()
            async for part in reader:
                if part.name == "file":
                    import os
                    import re
                    import tempfile

                    # keep only a sane extension from the client name (decoder
                    # dispatch needs it); never trust the full filename
                    ext = os.path.splitext(part.filename or "")[1].lower()
                    suffix = ext if re.fullmatch(r"\.[a-z0-9]{1,5}", ext) else ".wav"
                    with tempfile.NamedTemporaryFile(suffix=suffix, delete=False) as f:
                        f.write(await part.read())
                        tmp_path = f.name
                    try:
                        audio = await _load(tmp_path)
                    finally:
                        os.unlink(tmp_path)
                elif part.name == "options":
                    options = json.loads(await part.text())
        else:
            body = await request.json()
            if "path" in body:
                audio = await _load(body["path"])
            options = body.get("options", {})
    except json.JSONDecodeError:
        # malformed 'options' part / JSON body is a different client error
        # from corrupt audio (JSONDecodeError ⊂ ValueError, so match first)
        return _error("invalid JSON body", 400)
    except (ValueError, OSError, RuntimeError) as exc:
        # corrupt/unreadable audio is a client error, not a server crash:
        # surface load_audio's canonical message as a structured 422
        return _error(f"audio decode failed: {exc}", 422)
    if audio is None:
        return _error("no audio provided (multipart 'file' or JSON 'path')", 422)

    t0 = time.perf_counter()
    batcher = app.get("batcher")
    if batcher is not None and not options:
        # continuous batching: windows from concurrent requests share device
        # batches (runtime/batcher.py) in place of the reference's
        # single-writer lock
        result = await batcher.transcribe(np.asarray(audio))
    else:
        if audio.dtype == np.int16:  # pcm16 fast path taken, options present
            audio = audio.astype(np.float32) / 32768.0
        device = app["state"].device
        # transcribe sets its tokenizer's language and task (detected or
        # given): this request gets a copy of its own, so that the batcher's
        # requests keep theirs (the reference shares one, and a request with
        # options changes the language of every later one: F7)
        result = await asyncio.to_thread(
            _on_device, device, transcribe, np.asarray(audio),
            params=params, config=config, tokenizer=copy.copy(tokenizer), device=device,
            verbose=False, **options,
        )
    result["latency_ms"] = (time.perf_counter() - t0) * 1000
    return _json(result)


async def transcribe_stream_endpoint(request: web.Request) -> web.StreamResponse:
    """POST /v1/transcribe/stream — SSE of per-window segments as they decode
    (BASELINE config 5 streaming stretch)."""
    app = request.app
    batcher = app.get("batcher")
    if batcher is None:
        return _error("no ASR model loaded (start with --whisper-model)", 503)

    import numpy as np

    from whisper_mlx_tpu_torch.audio.decode import load_audio_serving

    try:
        body = await request.json()
    except json.JSONDecodeError:
        return _error("invalid JSON body", 400)
    if "path" not in body:
        return _error("'path' is required", 422)
    try:
        audio = await asyncio.to_thread(load_audio_serving, body["path"])
    except (ValueError, OSError, RuntimeError) as exc:
        return _error(f"audio decode failed: {exc}", 422)

    resp = web.StreamResponse(headers={
        "Content-Type": "text/event-stream",
        "Cache-Control": "no-cache",
    })
    await resp.prepare(request)
    t0 = time.perf_counter()
    async for event in batcher.stream_transcribe(np.asarray(audio)):
        event["event"] = "window"
        await resp.write(f"data: {json.dumps(event)}\n\n".encode())
    await resp.write(
        f"data: {json.dumps({'event': 'complete', 'latency_ms': (time.perf_counter() - t0) * 1000})}\n\n".encode()
    )
    await resp.write_eof()
    return resp


def _load_asr(whisper_model: str, device: torch.device):
    """(params, config, tokenizer) in the serving configuration of ``device``."""
    from whisper_mlx_tpu_torch.cli import load_model
    from whisper_mlx_tpu_torch.runtime.serving_config import apply_asr_serving_config

    params, config, tokenizer = _on_device(device, load_model, whisper_model, None, device)
    # loaders return the parity config; serve the device's serving config
    # (bf16, flash, int4 cross and int8 self caches on CUDA)
    params, config = apply_asr_serving_config(params, config, device)
    return params, config, tokenizer


def _start_asr_ranks(whisper_model: str, device: torch.device, dp: int):
    """Rank 0's side of a data-parallel ASR job: start the follower ranks,
    wait until each has loaded the model (failing as soon as one exits),
    join the job and build the mesh. -> (mesh, follower processes)."""
    import tempfile
    from pathlib import Path

    from whisper_mlx_tpu_torch.parallel.launch import free_port, start, stop
    from whisper_mlx_tpu_torch.parallel.mesh import init_distributed
    from whisper_mlx_tpu_torch.runtime.serving_config import serving_mesh

    coordinator = f"127.0.0.1:{free_port()}"
    logs = Path(tempfile.mkdtemp(prefix="asr-ranks-"))
    procs = [start(["-m", "whisper_mlx_tpu_torch.serving.server", "--whisper-model",
                    whisper_model, "--device", device.type, "--asr-rank", str(r),
                    "--asr-world", str(dp), "--asr-coordinator", coordinator,
                    "--asr-ready", str(logs / f"rank{r}.ready")],
                   logs / f"rank{r}.log") for r in range(1, dp)]
    try:
        _await_followers(procs, logs)
        init_distributed(coordinator, dp, 0, device=device)
        return serving_mesh(device), procs
    except BaseException:
        stop(procs, grace_s=0)
        raise


def _await_followers(procs: list, logs) -> None:
    """Wait until every follower rank (``procs[r - 1]``) has written its
    ready file, raising ``RuntimeError`` with its log's tail as soon as one
    exits, or once the collectives' timeout has passed."""
    from whisper_mlx_tpu_torch.parallel.launch import tail
    from whisper_mlx_tpu_torch.parallel.mesh import TIMEOUT

    deadline = time.monotonic() + TIMEOUT.total_seconds()
    waiting = set(range(1, len(procs) + 1))
    while waiting:
        for r in sorted(waiting):
            if procs[r - 1].poll() is not None:
                raise RuntimeError(f"ASR follower rank {r} exited with code "
                                   f"{procs[r - 1].returncode} before joining:\n"
                                   f"{tail(logs / f'rank{r}.log')}")
            if (logs / f"rank{r}.ready").exists():
                waiting.discard(r)
        if waiting and time.monotonic() > deadline:
            raise RuntimeError(f"ASR follower ranks {sorted(waiting)} not ready after "
                               f"{TIMEOUT.total_seconds():g} s")
        time.sleep(0.05)


def run_asr_follower(whisper_model: str, device: str, rank: int, world: int,
                     coordinator: str, ready: str | None = None) -> int:
    """A follower rank of the daemon's data-parallel ASR job: load the
    model, write the file ``ready`` (rank 0 waits for it), join the job,
    then the batcher's follower loop until rank 0 stops it. -> the batches
    it ran."""
    from pathlib import Path

    import torch.distributed as dist

    from whisper_mlx_tpu_torch.parallel.mesh import init_distributed
    from whisper_mlx_tpu_torch.runtime.batcher import TranscriptionBatcher
    from whisper_mlx_tpu_torch.runtime.serving_config import serving_mesh

    dev = setup_device(f"cuda:{rank}" if torch.device(device).type == "cuda" else device)
    params, config, tokenizer = _load_asr(whisper_model, dev)
    if ready is not None:
        Path(ready).touch()
    init_distributed(coordinator, world, rank, device=dev)
    try:
        batcher = TranscriptionBatcher(params, config, tokenizer, device=dev,
                                       mesh=serving_mesh(dev))
        return batcher.follow()
    finally:
        dist.destroy_process_group()


def _on_device(device: torch.device, fn, /, *args, **kwargs):
    """``fn`` (in a worker thread) with the server's device as the thread's."""
    with device_context(device):
        return fn(*args, **kwargs)


# ---------------------------------------------------------------------------
# app assembly
# ---------------------------------------------------------------------------


def create_app(preload: bool = False, whisper_model: str | None = None,
               serve_ui: bool = False, batch_slots: int | None = None,
               device: str | torch.device = "cuda") -> web.Application:
    """The daemon's application on ``device`` (``cuda`` by default, which
    raises when no GPU is present)."""
    import os

    if batch_slots is None:
        try:
            batch_slots = int(os.environ.get("QWEN_BATCH_SLOTS", "1"))
        except ValueError:
            batch_slots = 1
    app = web.Application(client_max_size=256 * 1024 * 1024)
    app["state"] = AppState(batch_slots=batch_slots, device=device)
    app["asr"] = None

    if serve_ui:
        from pathlib import Path

        ui_dir = Path(__file__).resolve().parents[2] / "frontend"
        if ui_dir.exists():
            async def ui_index(request: web.Request) -> web.FileResponse:
                return web.FileResponse(ui_dir / "index.html")

            app.router.add_get("/ui", ui_index)
            app.router.add_get("/", ui_index)
            app.router.add_static("/ui/", ui_dir)
        else:
            logger.warning("frontend/ not found; --ui ignored")

    app.router.add_get("/health", health)
    app.router.add_get("/v1/tools", list_tools)
    app.router.add_get("/v1/tools/{name}", get_tool)
    app.router.add_post("/v1/tools/{name}/invoke", invoke_tool)
    app.router.add_post("/v1/invoke-tool", invoke_tool)
    app.router.add_get("/v1/profiles", list_profiles)
    app.router.add_get("/v1/profiles/{name}", get_profile_handler)
    app.router.add_get("/v1/profiles/{name}/tools", get_profile_tools)
    app.router.add_post("/v1/chat", stateless_chat)
    app.router.add_post("/v1/sessions", create_session)
    app.router.add_get("/v1/sessions", list_sessions)
    app.router.add_get("/v1/sessions/{id}", get_session)
    app.router.add_delete("/v1/sessions/{id}", delete_session)
    app.router.add_post("/v1/sessions/{id}/chat", session_chat)
    app.router.add_post("/v1/sessions/{id}/chat/stream", session_chat_stream)
    app.router.add_get("/v1/generation/status", generation_status)
    app.router.add_post("/v1/transcribe", transcribe_endpoint)
    app.router.add_post("/v1/transcribe/stream", transcribe_stream_endpoint)

    async def on_startup(app: web.Application) -> None:
        # lifespan parity (reference :364-406): registry populate, session
        # prune, optional model preload, sync scheduler
        get_registry()
        get_session_store().prune_empty(0)
        state: AppState = app["state"]
        if preload:
            await asyncio.to_thread(_on_device, state.device, state.get_chat_service,
                                    "large")
            state.model_loaded = True
        if whisper_model:
            from whisper_mlx_tpu_torch.runtime.batcher import TranscriptionBatcher
            from whisper_mlx_tpu_torch.runtime.serving_config import serving_dp

            dp = serving_dp(state.device)
            params, config, tokenizer = await asyncio.to_thread(_load_asr, whisper_model,
                                                                state.device)
            app["asr"] = (params, config, tokenizer)
            mesh = None
            if dp > 1:  # rank 0 of a data-parallel job: start the followers
                mesh, app["asr_ranks"] = await asyncio.to_thread(
                    _start_asr_ranks, whisper_model, state.device, dp)
            # the batcher reads its buckets and flush knobs itself
            app["batcher"] = TranscriptionBatcher(params, config, tokenizer,
                                                  device=state.device, mesh=mesh)
        try:
            from whisper_mlx_tpu_torch.serving.sync.scheduler import start_scheduler

            start_scheduler()
        except Exception as exc:
            logger.info("sync scheduler not started: %s", exc)

    async def on_cleanup(app: web.Application) -> None:
        batcher = app.get("batcher")
        if batcher is not None:
            batcher.shutdown()  # under a mesh, also stops the follower ranks
        if app.get("asr_ranks"):
            import torch.distributed as dist

            from whisper_mlx_tpu_torch.parallel.launch import stop

            await asyncio.to_thread(stop, app["asr_ranks"], 60.0)
            dist.destroy_process_group()
        try:
            from whisper_mlx_tpu_torch.serving.sync.scheduler import stop_scheduler

            stop_scheduler()
        except Exception:
            pass
        try:
            from whisper_mlx_tpu_torch.serving.tools.browser.manager import get_browser_manager

            await get_browser_manager().close()
        except Exception:
            pass

    app.on_startup.append(on_startup)
    app.on_cleanup.append(on_cleanup)
    return app


def main(argv: list[str] | None = None) -> int:
    logging.basicConfig(level=logging.INFO)
    parser = argparse.ArgumentParser("whisper_mlx_tpu_torch daemon")
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=5997)  # reference default
    parser.add_argument("--preload", action="store_true",
                        help="load the LLM at startup (reference behavior)")
    parser.add_argument("--whisper-model", default=None,
                        help="model dir/name for /v1/transcribe")
    parser.add_argument("--device", default="cuda",
                        help="torch device: cuda (the default; exits without a GPU) or cpu")
    parser.add_argument("--ui", action="store_true",
                        help="serve the web UI from frontend/ at /ui")
    parser.add_argument("--batch-slots", type=int, default=None,
                        help="continuous-batching slots for chat generation "
                             "(default 1 = reference single-writer lock; "
                             "env QWEN_BATCH_SLOTS)")
    parser.add_argument("--asr-rank", type=int, default=None, help=argparse.SUPPRESS)
    parser.add_argument("--asr-world", type=int, default=None, help=argparse.SUPPRESS)
    parser.add_argument("--asr-coordinator", default=None, help=argparse.SUPPRESS)
    parser.add_argument("--asr-ready", default=None, help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    if args.asr_rank is not None:  # a follower rank started by the daemon
        run_asr_follower(args.whisper_model, args.device, args.asr_rank, args.asr_world,
                         args.asr_coordinator, args.asr_ready)
        return 0
    try:
        device = setup_device(args.device)
    except (RuntimeError, ValueError) as exc:
        raise SystemExit(f"whisper_mlx_tpu_torch daemon: --device {args.device}: {exc}") from None
    if args.batch_slots is not None:
        import os

        os.environ["QWEN_BATCH_SLOTS"] = str(args.batch_slots)
    app = create_app(preload=args.preload, whisper_model=args.whisper_model,
                     serve_ui=args.ui, batch_slots=args.batch_slots, device=device)
    web.run_app(app, host=args.host, port=args.port)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

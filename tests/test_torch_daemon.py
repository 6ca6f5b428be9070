"""Port parity: the HTTP daemon of whisper_mlx_tpu_torch against the JAX
package's, in process on the CPU.

Both apps run the same scripted model (``QWEN_SCRIPTED_MODEL``, the golden
script of tests/test_golden_session.py) over fresh session stores and the
same seeded mirror data. Every endpoint of ``whisper_mlx_tpu/serving/
server.py`` gets the same requests on both; status codes and JSON must be
equal once ids, timestamps, latencies, queue waits and uptime are dropped,
SSE streams must carry the same events in the same order, and the error
paths (400, 404, 422, 503) must match. On a tiny mlx-format checkpoint and
a seeded 12 s WAV, ``/v1/transcribe`` must give the JAX daemon's text and
segment tokens at T = 0. Two subprocess tests start the port's server from
the command line: with ``--device cpu`` it serves and exits on SIGTERM;
without ``--device`` on a host with no GPU it exits non-zero naming the
device. Ports are free ones taken by binding to 0.
"""

from __future__ import annotations

import asyncio
import json
import os
import signal
import socket
import struct
import subprocess
import sys
import time
import urllib.request

import numpy as np
import pytest

import torch  # (torch before jax: the reverse order has deadlocked)
import jax  # noqa: F401
from aiohttp import FormData
from aiohttp.test_utils import TestClient, TestServer

from tests.conftest import make_speechy_audio
from whisper_mlx_tpu.serving import chat as j_chat
from whisper_mlx_tpu.serving import server as j_server
from whisper_mlx_tpu.serving import sessions as j_sessions
from whisper_mlx_tpu.serving.tools.mirror import data_store as j_ds
from whisper_mlx_tpu_torch.serving import chat as t_chat
from whisper_mlx_tpu_torch.serving import server as t_server
from whisper_mlx_tpu_torch.serving import sessions as t_sessions
from whisper_mlx_tpu_torch.serving.tools.mirror import data_store as t_ds

from tests.test_golden_session import SCRIPT

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VOLATILE = {"id", "created_at", "updated_at", "timestamp", "latency_ms", "queue_wait_ms",
            "uptime_seconds", "stages"}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def stores(tmp_path, monkeypatch):
    """Scripted model, fresh session stores and the same seeded mirror data
    for both packages; model singletons reset."""
    script = tmp_path / "script.json"
    script.write_text(json.dumps(SCRIPT))
    monkeypatch.setenv("QWEN_SCRIPTED_MODEL", str(script))
    monkeypatch.delenv("QWEN_BATCH_SLOTS", raising=False)
    linear, slack = tmp_path / "linear", tmp_path / "slack"
    linear.mkdir()
    slack.mkdir()
    rng = np.random.default_rng(3)
    (linear / "issues.jsonl").write_text("\n".join(json.dumps(
        {"identifier": f"ENG-{i}", "title": f"issue {i} {rng.integers(1000)}",
         "description": "", "state": {"name": "Todo"}, "assignee": {"displayName": "Alice"},
         "team": {"name": "Platform"}, "updatedAt": "2026-08-01", "createdAt": "2026-07-01"})
        for i in range(4)))
    (slack / "users.jsonl").write_text(json.dumps(
        {"id": "U1", "name": "alice", "real_name": "Alice A",
         "profile": {"display_name": "alice", "email": "alice@example.com"}}))
    for label, chat, sess, ds in (("t", t_chat, t_sessions, t_ds), ("j", j_chat, j_sessions, j_ds)):
        monkeypatch.setattr(chat.QwenModel, "_instances", {})
        monkeypatch.setattr(ds, "MIRROR_DATA_DIR", str(tmp_path / f"{label}_assets"))
        ds.set_data_store(ds.MirrorDataStore(linear_dir=linear, slack_dir=slack))
        sess.set_session_store(sess.SessionStore(tmp_path / f"{label}_sessions"))
    yield tmp_path
    for sess, ds in ((t_sessions, t_ds), (j_sessions, j_ds)):
        ds.set_data_store(None)
        sess.set_session_store(None)


def _stable(node):
    if isinstance(node, dict):
        return {k: _stable(v) for k, v in node.items() if k not in VOLATILE}
    if isinstance(node, list):
        return [_stable(v) for v in node]
    return node


async def _send(client, step, saved):
    path = step["path"].format(**saved)
    kw = {}
    if "json" in step:
        kw["json"] = step["json"]
    elif "data" in step:
        kw["data"] = step["data"]
    async with client.request(step.get("method", "GET"), path, **kw) as resp:
        ctype = resp.headers.get("Content-Type", "")
        if ctype.startswith("text/event-stream"):
            raw = (await resp.read()).decode()
            body = [json.loads(line[6:]) for line in raw.split("\n") if line.startswith("data: ")]
            return resp.status, "sse", body
        if ctype.startswith("application/json"):
            body = await resp.json()
            if step.get("save"):
                saved[step["save"]] = body["id"]
            return resp.status, "json", body
        return resp.status, ctype, (await resp.read()).decode()


def _run_both(steps, port_kw=None, jax_kw=None):
    """The same requests through the JAX app and the port's -> both answers."""
    async def run(app):
        client = TestClient(TestServer(app))
        await client.start_server()
        try:
            saved = {}
            return [await _send(client, step, saved) for step in steps]
        finally:
            await client.close()

    port_app = t_server.create_app(device="cpu", **(port_kw or {}))
    jax_app = j_server.create_app(**(jax_kw or {}))
    return asyncio.run(run(port_app)), asyncio.run(run(jax_app))


def _session(profile="mirror"):
    return {"method": "POST", "path": "/v1/sessions", "json": {"profile": profile},
            "save": "sid"}


def _post(path, body=None, **kw):
    return {"method": "POST", "path": path, "json": body, **kw}


# every route of whisper_mlx_tpu/serving/server.py:create_app, with its error paths
ENDPOINTS = {
    "health": [{"path": "/health"}],
    "list_tools": [{"path": "/v1/tools"}],
    "get_tool": [{"path": "/v1/tools/run_python"}, {"path": "/v1/tools/nope"}],
    "invoke_tool": [
        _post("/v1/tools/run_python/invoke", {"arguments": {"code": "print(6 * 7)"}}),
        _post("/v1/tools/lookup_user/invoke", {"query": "alice"}),
        {"method": "POST", "path": "/v1/tools/lookup_user/invoke", "data": "{"},
        _post("/v1/tools/nope/invoke", {})],
    "invoke_legacy": [
        _post("/v1/invoke-tool", {"tool_name": "run_python",
                                  "arguments": {"code": "print('ok')"}}),
        _post("/v1/invoke-tool", {"tool_name": "nope"})],
    "list_profiles": [{"path": "/v1/profiles"}],
    "get_profile": [{"path": "/v1/profiles/mirror"}, {"path": "/v1/profiles/nope"}],
    "profile_tools": [{"path": "/v1/profiles/code_runner/tools"},
                      {"path": "/v1/profiles/nope/tools"}],
    "chat": [
        _post("/v1/chat", {"message": "what is 2+2?", "profile": "mirror"}),
        _post("/v1/chat", {"message": "hello", "history": [
            {"role": "user", "content": "hi"}, {"role": "assistant", "content": "hey"}]}),
        {"method": "POST", "path": "/v1/chat", "data": "{"},
        _post("/v1/chat", {"profile": "general"}),
        _post("/v1/chat", {"message": "x", "profile": "nope"}),
        _post("/v1/chat", {"message": "x", "model_size": "gigantic"})],
    "create_session": [
        _post("/v1/sessions", {"profile": "code_runner", "title": "mine"}),
        {"method": "POST", "path": "/v1/sessions", "data": "{"},
        _post("/v1/sessions", {"profile": "nope"}),
        _post("/v1/sessions", {"model_size": "gigantic"})],
    "list_sessions": [
        _session(), _post("/v1/sessions/{sid}/chat", {"message": "what is 2+2?"}),
        _session("general"), {"path": "/v1/sessions"}],
    "get_session": [
        _session(), _post("/v1/sessions/{sid}/chat", {"message": "what is 2+2?"}),
        {"path": "/v1/sessions/{sid}"}, {"path": "/v1/sessions/nope123"},
        {"path": "/v1/sessions/a.b"}],
    "delete_session": [
        _session(), {"method": "DELETE", "path": "/v1/sessions/{sid}"},
        {"method": "DELETE", "path": "/v1/sessions/{sid}"},
        {"method": "DELETE", "path": "/v1/sessions/a.b"}, {"path": "/v1/sessions"}],
    "session_chat": [
        _session(), _post("/v1/sessions/{sid}/chat", {"message": "what is 2+2?"}),
        _post("/v1/sessions/{sid}/chat", {"message": "unscripted input"}),
        _post("/v1/sessions/nope123/chat", {"message": "x"}),
        {"method": "POST", "path": "/v1/sessions/{sid}/chat", "data": "{"},
        _post("/v1/sessions/{sid}/chat", {})],
    "session_chat_stream": [
        _session(), _post("/v1/sessions/{sid}/chat/stream", {"message": "what is 2+2?"}),
        _post("/v1/sessions/{sid}/chat/stream", {"message": "unscripted input"}),
        {"path": "/v1/sessions/{sid}"},
        _post("/v1/sessions/nope123/chat/stream", {"message": "x"}),
        {"method": "POST", "path": "/v1/sessions/{sid}/chat/stream", "data": "{"},
        _post("/v1/sessions/{sid}/chat/stream", {})],
    "generation_status": [_post("/v1/chat", {"message": "hi"}),
                          {"path": "/v1/generation/status"}],
    "transcribe_without_model": [_post("/v1/transcribe", {"path": "x.wav"})],
    "transcribe_stream_without_model": [_post("/v1/transcribe/stream", {"path": "x.wav"})],
    "ui": [{"path": "/ui"}, {"path": "/ui/app.js"}, {"path": "/"}],
}


@pytest.mark.parametrize("name", list(ENDPOINTS))
def test_endpoint_equal_jax(stores, name):
    ui = {"serve_ui": True}
    port, ref = _run_both(ENDPOINTS[name], ui, ui)
    assert [r[:2] for r in port] == [r[:2] for r in ref]
    assert [_stable(r[2]) for r in port] == [_stable(r[2]) for r in ref]
    statuses = [r[0] for r in port]
    if name.endswith("without_model"):
        assert statuses == [503]
    else:
        assert any(s in (200, 201) for s in statuses), statuses
    if name == "session_chat_stream":
        kinds = [e["event"] for e in port[1][2]]
        assert kinds.index("tool_call") < kinds.index("tool_result") < kinds.index("complete")
        assert "token" in kinds
        assert port[1][2][-1]["event"] == "complete"
        assert [m["role"] for m in port[3][2]["messages"]] == ["user", "assistant"] * 2
    if name == "chat":
        assert "so the answer is 4" in port[0][2]["response"]
        assert statuses[2:] == [400, 422, 404, 422]


def test_error_paths_cover_every_code(stores):
    codes = {r[0] for name in ("chat", "get_tool", "transcribe_without_model")
             for r in _run_both(ENDPOINTS[name])[0]}
    assert {400, 404, 422, 503} <= codes


def test_concurrent_chats_queue_equal_jax(stores):
    """Two chats at once with one generation slot: exactly one waits, at
    position 1, and the queue is empty after (the reference's contract)."""
    async def run(app):
        client = TestClient(TestServer(app))
        await client.start_server()
        try:
            async def chat():
                async with client.post("/v1/chat", json={"message": "what is 2+2?"}) as r:
                    return (await r.json())["queue_stats"]
            stats = await asyncio.gather(chat(), chat())
            async with client.get("/v1/generation/status") as r:
                return stats, await r.json()
        finally:
            await client.close()

    out = []
    for app in (t_server.create_app(device="cpu", batch_slots=1),
                j_server.create_app(batch_slots=1)):
        stats, status = asyncio.run(run(app))
        out.append((sorted((s["was_queued"], s["queue_position"]) for s in stats), status))
    assert out[0] == out[1] == ([(False, 0), (True, 1)],
                                {"active": None, "queued": [], "queue_length": 0})


def test_create_app_cuda_without_gpu_raises():
    with pytest.raises(RuntimeError, match="cuda"):
        t_server.create_app()


# -- transcription ---------------------------------------------------------------


def _wav_bytes(audio: np.ndarray) -> bytes:
    data = (np.clip(audio, -1, 1) * 32767).astype("<i2").tobytes()
    hdr = b"RIFF" + struct.pack("<I", 36 + len(data)) + b"WAVE"
    hdr += b"fmt " + struct.pack("<IHHIIHH", 16, 1, 1, 16_000, 32_000, 2, 16)
    return hdr + b"data" + struct.pack("<I", len(data)) + data


@pytest.fixture(scope="module")
def asr(tmp_path_factory):
    """The tiny mlx-format checkpoint (the JAX package's exporter, as
    tests/test_daemon_e2e.py writes it) and a seeded 12 s WAV."""
    from whisper_mlx_tpu.checkpoint.quant_loader import export_mlx_whisper
    from whisper_mlx_tpu.decoding.tokenizer import make_synthetic_tokenizer
    from whisper_mlx_tpu.models.whisper import WhisperConfig, init_params

    tmp = tmp_path_factory.mktemp("asr")
    tok = make_synthetic_tokenizer()
    config = WhisperConfig(n_mels=80, n_vocab=tok.n_vocab, n_audio_state=64, n_audio_head=4,
                           n_audio_layer=2, n_text_state=64, n_text_head=4, n_text_layer=2)
    export_mlx_whisper(init_params(config, seed=0), config, tmp / "ckpt")
    wav = tmp / "speech.wav"
    wav.write_bytes(_wav_bytes(make_speechy_audio(12.0, seed=4)))
    bad = tmp / "bad.wav"
    bad.write_bytes(wav.read_bytes()[:-1])  # odd data chunk: truncated PCM16
    return str(tmp / "ckpt"), str(wav), str(bad)


def _tokens(result) -> list:
    return [s["tokens"] for s in result["segments"]]


def _transcribe_both(stores, asr, steps):
    ckpt = asr[0]
    return _run_both(steps, {"whisper_model": ckpt}, {"whisper_model": ckpt})


def _upload(path, options=None):
    form = FormData()
    with open(path, "rb") as f:
        form.add_field("file", f.read(), filename="clip.wav", content_type="audio/wav")
    if options is not None:
        form.add_field("options", options)
    return {"method": "POST", "path": "/v1/transcribe", "data": form}


@pytest.mark.parametrize("kind", ["path", "upload", "options"])
def test_transcribe_equal_jax(stores, asr, kind):
    """T = 0 on the batcher (a path, an upload) and on the sequential
    transcribe (options): the same text and segment tokens."""
    _, wav, _ = asr
    step = {"path": _post("/v1/transcribe", {"path": wav}),
            "upload": _upload(wav),
            "options": _post("/v1/transcribe", {"path": wav, "options": {
                "temperature": 0.0, "condition_on_previous_text": False}})}[kind]
    (port,), (ref,) = _transcribe_both(stores, asr, [step])
    assert port[0] == ref[0] == 200, (port, ref)
    got, want = port[2], ref[2]
    assert got["text"] == want["text"]
    assert _tokens(got) == _tokens(want)
    assert [(s["start"], s["end"]) for s in got["segments"]] == \
        [(s["start"], s["end"]) for s in want["segments"]]
    assert sum(len(t) for t in _tokens(got)) > 0 and got["language"] == want["language"]


def test_transcribe_stream_and_errors_equal_jax(stores, asr):
    _, wav, bad = asr
    steps = [_post("/v1/transcribe/stream", {"path": wav}),
             _post("/v1/transcribe/stream", {}),
             _post("/v1/transcribe/stream", {"path": bad}),
             _post("/v1/transcribe", {}),
             _post("/v1/transcribe", {"path": bad}),
             {"method": "POST", "path": "/v1/transcribe", "data": "{"},
             _upload(wav, options="{")]
    port, ref = _transcribe_both(stores, asr, steps)
    assert [r[0] for r in port] == [r[0] for r in ref] == [200, 422, 422, 422, 422, 400, 400]
    assert [_stable(r[2]) for r in port[1:]] == [_stable(r[2]) for r in ref[1:]]
    assert "bad.wav" in port[4][2]["detail"]
    events, ref_events = port[0][2], ref[0][2]
    assert [e["event"] for e in events] == [e["event"] for e in ref_events] == ["window",
                                                                                 "complete"]
    assert [s["tokens"] for s in events[0]["segments"]] == \
        [s["tokens"] for s in ref_events[0]["segments"]]


# -- the server from the command line ----------------------------------------------


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _env(tmp_path) -> dict:
    script = tmp_path / "script.json"
    script.write_text(json.dumps(SCRIPT))
    env = dict(os.environ, QWEN_SCRIPTED_MODEL=str(script),
               QWEN_SESSIONS_DIR=str(tmp_path / "sessions"), QWEN_DATA_DIR=str(tmp_path / "data"),
               MIRROR_DATA_DIR=str(tmp_path / "mirror"), QWEN_HOME=str(tmp_path / "home"),
               LINEAR_MIRROR_DIR=str(tmp_path / "linear"),
               VIBEOS_SLACK_MIRROR_DIR=str(tmp_path / "slack"), CUDA_VISIBLE_DEVICES="")
    env.pop("QWEN_MODEL_PATH", None)
    return env


def test_server_subprocess_cpu(tmp_path):
    port = _free_port()
    base = f"http://127.0.0.1:{port}"
    proc = subprocess.Popen(
        [sys.executable, "-m", "whisper_mlx_tpu_torch.serving.server", "--device", "cpu",
         "--port", str(port)], cwd=ROOT, env=_env(tmp_path),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    try:
        deadline = time.time() + 60
        while True:
            try:
                with urllib.request.urlopen(base + "/health", timeout=2) as r:
                    health = json.loads(r.read())
                break
            except OSError:
                assert proc.poll() is None, proc.stdout.read().decode()[-2000:]
                assert time.time() < deadline, "the daemon never became healthy"
                time.sleep(0.3)
        assert health["tools_count"] == 24 and health["model_loaded"] is False
        req = urllib.request.Request(base + "/v1/chat", method="POST",
                                     data=json.dumps({"message": "what is 2+2?"}).encode(),
                                     headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as r:
            body = json.loads(r.read())
        assert "so the answer is 4" in body["response"] and body["rounds"] == 2
    finally:
        proc.send_signal(signal.SIGTERM)
        try:
            proc.wait(timeout=15)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
            pytest.fail("the daemon did not exit on SIGTERM")


def test_server_without_gpu_exits_naming_the_device(tmp_path):
    """No --device: cuda, and on a host without a GPU the server exits
    non-zero naming it; it never serves on the CPU unasked."""
    proc = subprocess.run(
        [sys.executable, "-m", "whisper_mlx_tpu_torch.serving.server",
         "--port", str(_free_port())], cwd=ROOT, env=_env(tmp_path),
        capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert "--device cuda" in proc.stderr and "cuda" in proc.stderr.split("--device cuda")[1]


def test_daemon_modules_import_without_jax():
    """Every module of the port's serving layer and agents, each tool
    included, imports neither jax nor the JAX package."""
    code = ("import importlib, pkgutil, sys\n"
            "import whisper_mlx_tpu_torch.serving as s, whisper_mlx_tpu_torch.agents as a\n"
            "names = [m.name for pkg in (s, a) for m in pkgutil.walk_packages(\n"
            "    pkg.__path__, pkg.__name__ + '.') if not m.name.endswith('.config')]\n"
            "for name in names:\n"
            "    importlib.import_module(name)\n"
            "assert len(names) > 50, names\n"
            "bad = [k for k in sys.modules if k == 'jax' or k.startswith('jax.')\n"
            "       or k == 'whisper_mlx_tpu' or k.startswith('whisper_mlx_tpu.')]\n"
            "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=120, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr


def test_transcribe_options_keep_served_language(stores, tmp_path):
    """F7: ``transcribe`` sets its tokenizer's language (detected here, on a
    multilingual vocabulary). The JAX daemon hands it the served tokenizer,
    so one request with options changes the language of every later
    request; the port's gives each such request a copy."""
    from whisper_mlx_tpu.checkpoint.quant_loader import export_mlx_whisper
    from whisper_mlx_tpu.models.whisper import WhisperConfig, init_params

    config = WhisperConfig(n_mels=80, n_vocab=51865, n_audio_state=64, n_audio_head=4,
                           n_audio_layer=2, n_text_state=64, n_text_head=4, n_text_layer=2)
    export_mlx_whisper(init_params(config, seed=0), config, tmp_path / "multi")
    wav = tmp_path / "clip.wav"
    wav.write_bytes(_wav_bytes(make_speechy_audio(3.0, seed=1)))
    steps = [_post("/v1/transcribe", {"path": str(wav), "options": {"temperature": 0.0,
                                                                     "sample_len": 4}})]
    languages = {}

    async def run(app, label):
        client = TestClient(TestServer(app))
        await client.start_server()
        try:
            out = [await _send(client, step, {}) for step in steps]
            languages[label] = (out[0][2]["language"], app["asr"][2].language,
                                app["batcher"].tokenizer.language)
        finally:
            await client.close()

    ckpt = str(tmp_path / "multi")
    asyncio.run(run(t_server.create_app(device="cpu", whisper_model=ckpt), "port"))
    asyncio.run(run(j_server.create_app(whisper_model=ckpt), "jax"))
    detected = languages["port"][0]
    assert detected != "en" and languages["jax"][0] == detected, languages
    assert languages["port"][1:] == ("en", "en")
    assert languages["jax"][1:] == (detected, detected)  # the reference's fault

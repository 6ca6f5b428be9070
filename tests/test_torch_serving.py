"""Port parity: the daemon's host modules of whisper_mlx_tpu_torch against
the JAX package on the CPU.

The tools, sync, profiles, sessions, the config shim and the scripted
engine are copies: each equals its JAX module once ``whisper_mlx_tpu.`` is
read as ``whisper_mlx_tpu_torch.``. Mirrors tests/test_serving_unit.py and
tests/test_tools.py on the port, with the JAX functions fed the same
inputs (strings and data made from a seed): the chat helpers, the
registry's 24 specs, the profiles, the session store, BM25, the tools over
seeded mirror and Google data, the sync scheduler without credentials, the
legacy agent loop and the chat service over the scripted engine.
"""

from __future__ import annotations

import asyncio
import dataclasses
import json
import logging
from pathlib import Path

import numpy as np
import pytest

import torch  # noqa: F401  (torch before jax: the reverse order has deadlocked)
import jax  # noqa: F401

from whisper_mlx_tpu.agents import agent as j_agent
from whisper_mlx_tpu.serving import chat as j_chat
from whisper_mlx_tpu.serving import profiles as j_profiles
from whisper_mlx_tpu.serving import sessions as j_sessions
from whisper_mlx_tpu.serving.sync import storage as j_storage
from whisper_mlx_tpu.serving.tools import registry as j_registry
from whisper_mlx_tpu.serving.tools.google.fts import bm25 as j_bm25
from whisper_mlx_tpu.serving.tools.mirror import data_store as j_ds
from whisper_mlx_tpu_torch.agents import agent as t_agent
from whisper_mlx_tpu_torch.serving import chat as t_chat
from whisper_mlx_tpu_torch.serving import profiles as t_profiles
from whisper_mlx_tpu_torch.serving import sessions as t_sessions
from whisper_mlx_tpu_torch.serving.sync import auth as t_auth
from whisper_mlx_tpu_torch.serving.sync import scheduler as t_scheduler
from whisper_mlx_tpu_torch.serving.sync import storage as t_storage
from whisper_mlx_tpu_torch.serving.tools import registry as t_registry
from whisper_mlx_tpu_torch.serving.tools.google.fts import bm25 as t_bm25
from whisper_mlx_tpu_torch.serving.tools.mirror import data_store as t_ds

ROOT = Path(__file__).resolve().parents[1]
J_SERVING = ROOT / "whisper_mlx_tpu" / "serving"
T_SERVING = ROOT / "whisper_mlx_tpu_torch" / "serving"
# every module of these is a copy of the JAX package's
COPIED = sorted(
    [str(p.relative_to(J_SERVING)) for d in ("tools", "sync", "profiles")
     for p in (J_SERVING / d).rglob("*.py")]
    + ["sessions.py", "config.py", "scripted.py"])

SCRIPT = {
    "rules": [
        {"match": "what is 2+2",
         "response": ("<think>I should compute this with the python tool.</think>\n"
                      "<tool_call>{\"name\": \"run_python\", "
                      "\"arguments\": {\"code\": \"print(2+2)\"}}</tool_call>")},
        {"match": "<tool_response>",
         "response": "The tool returned: {{tool_response}} — so the answer is 4."},
    ],
    "default": "I have no script for that.",
}

WORDS = ["budget", "report", "deploy", "login", "dark", "mode", "lunch", "review",
         "policy", "vacation", "quarterly", "finance", "meeting", "notes", "bug", "fix"]


def _asdict(items) -> list:
    return [dataclasses.asdict(x) for x in items]


def test_copied_modules_listed():
    assert len(COPIED) == 53
    assert "tools/registry.py" in COPIED and "sync/scheduler.py" in COPIED


@pytest.mark.parametrize("rel", COPIED)
def test_copy_equals_jax_module(rel):
    ref = (J_SERVING / rel).read_text()
    assert (T_SERVING / rel).read_text() == ref.replace("whisper_mlx_tpu.",
                                                        "whisper_mlx_tpu_torch.")


# -- chat helpers ------------------------------------------------------------


def _random_agent_text(rng) -> str:
    """Plain words, thinking, well-formed and malformed tool calls."""
    parts = []
    for _ in range(int(rng.integers(3, 9))):
        kind = int(rng.integers(6))
        words = " ".join(WORDS[i] for i in rng.integers(len(WORDS), size=int(rng.integers(1, 6))))
        if kind == 0:
            parts.append(words)
        elif kind == 1:
            parts.append(f"<think>{words}\n{words}</think>")
        elif kind == 2:
            args = {WORDS[int(rng.integers(len(WORDS)))]: words, "n": int(rng.integers(100))}
            parts.append(f"<tool_call>\n{json.dumps({'name': words.split()[0], 'arguments': args})}"
                         f"\n</tool_call>")
        elif kind == 3:
            parts.append(f"<tool_call>{{{words}}}</tool_call>")  # not JSON
        elif kind == 4:
            bad = {"name": int(rng.integers(9))} if rng.integers(2) else \
                {"name": "x", "arguments": [words]}
            parts.append(f"<tool_call>{json.dumps(bad)}</tool_call>")
        else:
            parts.append("<think>  </think>")
    return " ".join(parts)


@pytest.mark.parametrize("seed", range(4))
def test_chat_helpers_equal_jax(seed):
    rng = np.random.default_rng(seed)
    for _ in range(25):
        text = _random_agent_text(rng)
        assert _asdict(t_chat.parse_tool_calls(text)) == _asdict(j_chat.parse_tool_calls(text))
        assert t_chat.extract_final_response(text) == j_chat.extract_final_response(text)
        assert t_chat.extract_thinking(text) == j_chat.extract_thinking(text)


def test_chat_helpers_reference_cases():
    text = ('let me check <tool_call>\n{"name": "search_emails", '
            '"arguments": {"query": "invoice"}}\n</tool_call> and also '
            '<tool_call>{"name": "get_email", "arguments": {"id": "x"}}</tool_call>')
    calls = t_chat.parse_tool_calls(text)
    assert [c.name for c in calls] == ["search_emails", "get_email"]
    assert calls[0].arguments == {"query": "invoice"}
    assert t_chat.parse_tool_calls("<tool_call>not json</tool_call>") == []
    text = "<think>hmm\nok</think>The answer is 4.<tool_call>{}</tool_call>"
    assert t_chat.extract_final_response(text) == "The answer is 4."
    assert t_chat.extract_thinking(text) == ["hmm\nok"]
    assert t_chat.format_tools_prompt([]) == ""


@pytest.mark.parametrize("profile", ["general", "mirror", "code_runner"])
def test_tools_prompt_equal_jax(profile):
    names = list(t_profiles.get_profile(profile).tools)
    t_specs = [t.spec for t in t_registry.get_registry().get_tools(names)]
    j_specs = [t.spec for t in j_registry.get_registry().get_tools(names)]
    out = t_chat.format_tools_prompt(t_specs)
    assert out == j_chat.format_tools_prompt(j_specs)
    assert out.count('{"type": "function"') == len(names)


# -- registry and profiles -----------------------------------------------------


def test_registry_specs_equal_jax():
    t_reg, j_reg = t_registry.get_registry(), j_registry.get_registry()
    assert t_reg.available_tools == j_reg.available_tools
    assert len(t_reg.available_tools) == 24
    assert "search_emails_fts" not in t_reg.available_tools
    for name in t_reg.available_tools:
        tool = t_reg.get(name)
        assert tool is not None and type(tool).__module__.startswith("whisper_mlx_tpu_torch.")
        assert tool.spec.to_dict() == j_reg.get(name).spec.to_dict(), name


def test_registry_execute_errors_equal_jax():
    for reg in (t_registry.ToolRegistry(), j_registry.ToolRegistry()):
        assert "error" in json.loads(reg.execute("nope", {}))
    t_reg, j_reg = t_registry.get_registry(), j_registry.get_registry()
    bad = {"bogus_arg": 1}
    assert t_reg.execute("lookup_user", bad) == j_reg.execute("lookup_user", bad)
    out = asyncio.run(t_reg.execute_async("nope", {}))
    assert out == asyncio.run(j_reg.execute_async("nope", {}))


def test_profiles_equal_jax():
    assert sorted(t_profiles.ALL_PROFILES) == ["code_runner", "general", "mirror"]
    for name in t_profiles.ALL_PROFILES:
        tp, jp = t_profiles.get_profile(name), j_profiles.get_profile(name)
        assert tp.to_dict() == jp.to_dict()
        assert tp.system_prompt == jp.system_prompt
        assert len(tp.context_augmenters) == len(jp.context_augmenters)
    assert [len(t_profiles.get_profile(n).tools) for n in ("general", "mirror", "code_runner")] \
        == [24, 9, 10]
    for mod in (t_profiles, j_profiles):
        with pytest.raises(ValueError):
            mod.get_profile("nope")


# -- sessions ------------------------------------------------------------------

_VOLATILE = ("id", "created_at", "updated_at", "timestamp")


def _stable(node):
    if isinstance(node, dict):
        return {k: _stable(v) for k, v in node.items() if k not in _VOLATILE}
    if isinstance(node, list):
        return [_stable(v) for v in node]
    return node


def _session_run(mod, directory, rng_seed):
    rng = np.random.default_rng(rng_seed)
    store = mod.SessionStore(directory)
    out = []
    sessions = [store.create(profile=p, title="") for p in ("mirror", "general", "code_runner")]
    for s in sessions:
        for _ in range(int(rng.integers(1, 4))):
            words = " ".join(WORDS[i] for i in rng.integers(len(WORDS), size=30))
            s.add_message("user", words)
            s.add_message("assistant", words[::-1], rounds=int(rng.integers(1, 5)))
        store.save(s)
        loaded = store.get(s.id)
        out.append(loaded.to_dict())
        assert len(loaded.title) <= 60
    empty = store.create()
    out.append(store.prune_empty(0))
    out.append(store.get(empty.id))
    out.append(sorted(_stable(store.list_summaries()), key=lambda d: d["profile"]))
    out.append(store.delete(sessions[0].id))
    out.append(store.get(sessions[0].id))
    for bad in ("../../etc/passwd", "a/b"):
        with pytest.raises(ValueError):
            store.get(bad)
    return _stable(out)


def test_session_store_equal_jax(tmp_path):
    assert _session_run(t_sessions, tmp_path / "t", 5) == _session_run(j_sessions,
                                                                         tmp_path / "j", 5)


# -- BM25 ----------------------------------------------------------------------


@pytest.mark.parametrize("seed", range(3))
def test_bm25_ranking_equal_jax(seed):
    rng = np.random.default_rng(seed)
    docs = [" ".join(WORDS[i] for i in rng.integers(len(WORDS), size=int(rng.integers(2, 12))))
            for _ in range(40)]
    t_scorer, j_scorer = t_bm25.BM25Scorer.from_documents(docs), \
        j_bm25.BM25Scorer.from_documents(docs)
    for _ in range(10):
        query = " ".join(WORDS[i] for i in rng.integers(len(WORDS), size=2))
        ranked = t_scorer.rank(query)
        assert ranked == j_scorer.rank(query)
        assert t_bm25.tokenize(query) == j_bm25.tokenize(query)
    assert t_scorer.rank("the a an") == []


# -- tools over seeded data ----------------------------------------------------


@pytest.fixture
def mirror_data(tmp_path):
    """Seeded Linear and Slack mirrors, served to both packages' tools."""
    rng = np.random.default_rng(7)
    linear, slack = tmp_path / "linear", tmp_path / "slack"
    linear.mkdir()
    slack.mkdir()
    people, states, teams = ["Alice", "Bob", "Carol"], ["Todo", "In Progress", "Done"], \
        ["Platform", "Frontend"]

    def words(n):
        return " ".join(WORDS[i] for i in rng.integers(len(WORDS), size=n))

    issues = [{"identifier": f"ENG-{i}", "title": words(3), "description": words(8),
               "state": {"name": states[int(rng.integers(3))]},
               "assignee": {"displayName": people[int(rng.integers(3))]},
               "team": {"name": teams[int(rng.integers(2))]},
               "updatedAt": f"2026-08-{1 + i:02d}", "createdAt": f"2026-07-{1 + i:02d}",
               "comments": [{"id": f"c{i}", "body": words(4),
                             "user": {"displayName": people[i % 3]},
                             "createdAt": f"2026-07-{2 + i:02d}"}]}
              for i in range(1, 13)]
    (linear / "issues.jsonl").write_text("\n".join(json.dumps(i) for i in issues))
    (linear / "events.jsonl").write_text("\n".join(json.dumps(
        {"id": f"e{i}", "issueIdentifier": f"ENG-{1 + i % 12}", "type": "comment",
         "actor": {"displayName": people[i % 3]}, "createdAt": f"2026-08-{1 + i:02d}"})
        for i in range(8)))
    for channel in ("general", "eng"):
        msgs = []
        for i in range(10):
            msg = {"ts": f"{100 + 10 * i}.{i}", "user": f"U{i % 3}", "text": words(5)}
            if i % 4 == 3:
                msg["thread_ts"] = msgs[0]["ts"]
            msgs.append(msg)
        (slack / f"{channel}.jsonl").write_text("\n".join(json.dumps(m) for m in msgs))
    (slack / "users.jsonl").write_text("\n".join(json.dumps(
        {"id": f"U{i}", "name": p.lower(), "real_name": f"{p} A",
         "profile": {"display_name": p.lower(), "email": f"{p.lower()}@example.com"}})
        for i, p in enumerate(people)))
    for mod in (t_ds, j_ds):
        mod.set_data_store(mod.MirrorDataStore(linear_dir=linear, slack_dir=slack))
    yield
    for mod in (t_ds, j_ds):
        mod.set_data_store(None)


MIRROR_CALLS = [
    ("search_linear_issues", {"query": "budget"}),
    ("search_linear_issues", {"state": "Todo"}),
    ("search_linear_issues", {"assignee": "ali", "limit": 2, "page": 2}),
    ("search_linear_issues", {"team": "front", "limit": 3}),
    ("get_linear_issue", {"identifier": "ENG-3"}),
    ("get_linear_issue", {"identifier": "NOPE-9"}),
    ("list_linear_events", {}),
    ("list_linear_events", {"issue": "ENG-2"}),
    ("search_slack_messages", {"query": "deploy"}),
    ("search_slack_messages", {"query": "review", "channel": "eng"}),
    ("get_slack_thread", {"channel": "general", "thread_ts": "100.0"}),
    ("list_recent_slack_activity", {}),
    ("lookup_user", {"query": "bob"}),
    ("lookup_user", {"query": "nobody"}),
    ("run_python", {"code": "print(sum(range(101)))"}),
    ("run_python", {"code": "import sys; sys.exit(3)"}),
]


@pytest.mark.parametrize("name,args", MIRROR_CALLS, ids=[f"{n}-{i}" for i, (n, _) in
                                                         enumerate(MIRROR_CALLS)])
def test_mirror_tools_equal_jax(mirror_data, tmp_path, monkeypatch, name, args):
    monkeypatch.setattr(t_ds, "MIRROR_DATA_DIR", str(tmp_path / "t_assets"))
    monkeypatch.setattr(j_ds, "MIRROR_DATA_DIR", str(tmp_path / "j_assets"))
    out = t_registry.get_registry().execute(name, args)
    assert out == j_registry.get_registry().execute(name, args)
    assert json.loads(out)


def test_current_datetime_equal_jax():
    t_out = json.loads(t_registry.get_registry().execute("get_current_datetime", {}))
    j_out = json.loads(j_registry.get_registry().execute("get_current_datetime", {}))
    assert set(t_out) == set(j_out) >= {"utc", "local", "date", "ranges"}
    if t_out["date"] == j_out["date"]:  # not across midnight
        assert t_out["ranges"] == j_out["ranges"]


@pytest.fixture
def google_data(tmp_path, monkeypatch):
    rng = np.random.default_rng(11)
    for mod in (t_storage, j_storage):
        monkeypatch.setattr(mod, "DATA_DIR", tmp_path / "google")
    for i in range(12):
        subject = " ".join(WORDS[j] for j in rng.integers(len(WORDS), size=3))
        t_storage.save_email("work", {
            "id": f"m{i}", "date": f"2026-08-{1 + i:02d}",
            "from": ["boss@corp.com", "hr@corp.com"][i % 2], "to": "me@corp.com",
            "subject": subject, "snippet": subject[:10],
            "body": " ".join(WORDS[j] for j in rng.integers(len(WORDS), size=12)),
            "attachments": [{"filename": "a.xlsx"}] if i % 3 == 0 else []})
        t_storage.save_event("work", {
            "id": f"ev{i}", "summary": subject, "calendar": "Work",
            "start": {"dateTime": f"2026-08-{1 + i:02d}T10:00:00Z"},
            "attendees": [{"email": ["boss@corp.com", "me@corp.com"][i % 2]}]})
    for fts in ("search_emails_fts", "search_calendar_fts"):  # module caches of the index
        for pkg in ("whisper_mlx_tpu", "whisper_mlx_tpu_torch"):
            mod = __import__(f"{pkg}.serving.tools.google.{fts}", fromlist=["_index"])
            monkeypatch.setattr(mod, "_index", None)
    yield


GOOGLE_CALLS = [
    ("search_emails", {"query": "budget"}),
    ("search_emails", {"from": "hr"}),
    ("search_emails", {"has_attachment": True}),
    ("search_emails", {"after": "2026-08-05", "limit": 3}),
    ("get_email", {"id": "m1"}),
    ("get_email", {"id": "nope"}),
    ("search_calendar", {"query": "review"}),
    ("search_calendar", {"attendee": "boss"}),
    ("get_calendar_event", {"id": "ev2"}),
    ("search_emails_fts", {"query": "budget review"}),
    ("search_calendar_fts", {"query": "lunch meeting"}),
]


@pytest.mark.parametrize("name,args", GOOGLE_CALLS, ids=[f"{n}-{i}" for i, (n, _) in
                                                         enumerate(GOOGLE_CALLS)])
def test_google_tools_equal_jax(google_data, name, args):
    if name.endswith("_fts"):  # unregistered (reference parity): called directly
        outs = []
        for pkg in ("whisper_mlx_tpu_torch", "whisper_mlx_tpu"):
            mod = __import__(f"{pkg}.serving.tools.google.{name}", fromlist=[name])
            outs.append(getattr(mod, name).execute(**args))
        assert outs[0] == outs[1]
        assert json.loads(outs[0])["total_indexed"] > 0
        return
    out = t_registry.get_registry().execute(name, args)
    assert out == j_registry.get_registry().execute(name, args)
    assert json.loads(out)


def test_storage_stats_equal_jax(google_data):
    assert t_storage.get_storage_stats() == j_storage.get_storage_stats()
    assert t_storage.get_storage_stats()["work"]["emails"] == 12


@pytest.mark.parametrize("name,args", [("browser_navigate", {"url": "https://x.com"}),
                                       ("ocr_document", {"path": "/nonexistent.png"}),
                                       ("browser_get_text", {})])
def test_missing_dependency_tools_equal_jax(name, args):
    out = asyncio.run(t_registry.get_registry().execute_async(name, args))
    assert out == asyncio.run(j_registry.get_registry().execute_async(name, args))
    assert "error" in json.loads(out)


# -- sync scheduler --------------------------------------------------------------


def test_start_scheduler_without_credentials(tmp_path, monkeypatch, caplog):
    """The daemon starts the scheduler inside ``except Exception``: here it
    must import and run. No account: idle, no thread. An account whose
    credentials need google-auth (absent): one cycle skips both syncs with
    AuthUnavailable, through the port's gmail and calendar modules."""
    monkeypatch.setattr(t_auth, "ACCOUNTS_DIR", tmp_path / "accounts")
    assert t_auth.list_accounts() == []
    t_scheduler.start_scheduler()
    assert t_scheduler._thread is None
    t_scheduler.stop_scheduler()

    (tmp_path / "accounts" / "work").mkdir(parents=True)
    (tmp_path / "accounts" / "work" / "credentials.json").write_text("{}")
    assert t_auth.list_accounts() == ["work"]
    with caplog.at_level(logging.INFO, logger="qwen.sync.scheduler"):
        asyncio.run(t_scheduler._sync_cycle())
    skipped = [r.getMessage() for r in caplog.records if "skipped" in r.getMessage()]
    assert len(skipped) == 2, caplog.text
    assert all("work" in m for m in skipped)
    t_scheduler.start_scheduler()
    try:
        assert t_scheduler._thread is not None and t_scheduler._thread.is_alive()
    finally:
        t_scheduler.stop_scheduler()
    assert t_scheduler._thread is None


# -- the legacy agent loop and the chat service -----------------------------------


class _FakeModel:
    def __init__(self, script):
        self.script, self.n = script, 0

    def generate(self, messages, max_tokens, temperature):
        out = self.script[min(self.n, len(self.script) - 1)]
        self.n += 1
        return out


def _agent_run(mod, reg_mod, script, rounds):
    agent = mod.ToolCallingAgent(
        model=_FakeModel(script), tools=[reg_mod.get_registry().get("lookup_user")],
        verbose=False, max_tool_rounds=rounds)
    return agent.run("who is alice?"), agent.history, agent.model.n


@pytest.mark.parametrize("script,rounds", [
    (['<tool_call>{"name": "lookup_user", "arguments": {"query": "alice"}}</tool_call>',
      "<think>still thinking...</think>", "Alice is alice@example.com."], 5),
    (['<tool_call>{"name": "nope", "arguments": {}}</tool_call>', "done"], 5),
    (['<tool_call>{"name": "lookup_user", "arguments": {}}</tool_call>'], 2),
])
def test_tool_calling_agent_equal_jax(mirror_data, script, rounds):
    out = _agent_run(t_agent, t_registry, script, rounds)
    assert out == _agent_run(j_agent, j_registry, script, rounds)
    assert out[0]


def test_agent_make_model_device():
    model = t_agent.make_model("small", device="cpu")
    assert model.device == torch.device("cpu") and model.model_size == t_chat.ModelSize.SMALL
    with pytest.raises(RuntimeError, match="cuda"):
        t_agent.make_model("small")  # cuda by default: no GPU here


@pytest.fixture
def scripted(tmp_path, monkeypatch):
    path = tmp_path / "script.json"
    path.write_text(json.dumps(SCRIPT))
    monkeypatch.setenv("QWEN_SCRIPTED_MODEL", str(path))
    monkeypatch.setattr(t_chat.QwenModel, "_instances", {})
    monkeypatch.setattr(j_chat.QwenModel, "_instances", {})
    monkeypatch.setattr(t_ds, "MIRROR_DATA_DIR", str(tmp_path / "t_assets"))
    monkeypatch.setattr(j_ds, "MIRROR_DATA_DIR", str(tmp_path / "j_assets"))


def test_scripted_model_serves(scripted):
    """QWEN_SCRIPTED_MODEL serves the scripted engine, as in the reference."""
    from whisper_mlx_tpu_torch.inference.generate import GenerationResult
    from whisper_mlx_tpu_torch.serving.scripted import ScriptedEngine

    model = t_chat.QwenModel.get(t_chat.ModelSize.LARGE, None, "cpu")
    assert isinstance(model.engine, ScriptedEngine)
    res = model.engine.generate("what is 2+2?")
    assert isinstance(res, GenerationResult) and "run_python" in res.text
    assert model.generate([{"role": "user", "content": "hi"}]) == SCRIPT["default"]


def _response(resp) -> dict:
    d = dataclasses.asdict(resp)
    d.pop("latency_ms")
    for r in d["tool_results"]:
        r.pop("latency_ms")
    return d


@pytest.mark.parametrize("message,profile", [("what is 2+2?", "mirror"),
                                             ("unscripted input", "general")])
def test_chat_service_equal_jax(scripted, message, profile):
    t_svc = t_chat.create_chat_service(device="cpu")
    j_svc = j_chat.create_chat_service()
    assert t_svc.model.device == torch.device("cpu")
    t_resp = t_svc.chat(message, profile_name=profile)
    assert _response(t_resp) == _response(j_svc.chat(message, profile_name=profile))

    async def events(svc):
        seen = []

        async def on_event(kind, data):
            seen.append({"kind": kind, **{k: v for k, v in data.items() if k != "latency_ms"}})

        resp = await svc.chat_async(message, profile_name=profile, on_event=on_event)
        await asyncio.sleep(0)  # token events posted from the worker thread
        return _response(resp), seen

    t_async, j_async = asyncio.run(events(t_svc)), asyncio.run(events(j_svc))
    assert t_async == j_async
    assert t_async[0] == _response(t_resp)
    assert "token" in [e["kind"] for e in t_async[1]]


def test_chat_service_cuda_without_gpu_raises():
    with pytest.raises(RuntimeError, match="cuda"):
        t_chat.create_chat_service(t_chat.ModelSize.SMALL)


def test_config_shim_equal_jax():
    import importlib
    import sys

    with pytest.warns(DeprecationWarning):
        sys.modules.pop("whisper_mlx_tpu_torch.serving.config", None)
        t_config = importlib.import_module("whisper_mlx_tpu_torch.serving.config")
    with pytest.warns(DeprecationWarning):
        sys.modules.pop("whisper_mlx_tpu.serving.config", None)
        j_config = importlib.import_module("whisper_mlx_tpu.serving.config")
    assert list(t_config.TOOL_SPECS) == list(j_config.TOOL_SPECS)
    assert t_config.TOOL_SPECS["run_python"] == j_config.TOOL_SPECS["run_python"]
    assert t_config.ChatService is t_chat.ChatService

"""Chat service: agent orchestration over the LLM engine.

Counterpart of ``whisper_mlx_tpu/serving/chat.py``: the frozen message and
response dataclasses, the prompt helpers (``format_tools_prompt``,
``parse_tool_calls``, ``extract_final_response``, ``extract_thinking``),
the lazily loaded model singleton ``QwenModel`` and the sync and async
agent loops of ``ChatService``, with the same text.

Model sizes map to the reference's mlx-community ids; ``QWEN_MODEL_PATH``
(or ``model_path``) loads a local HF or mlx-format checkpoint directory with
its tokenizer, and without one a tiny random model serves, so the engine
runs without weights. ``QWEN_SCRIPTED_MODEL`` serves the deterministic
scripted engine (``serving/scripted.py``) instead of a model.
``QWEN_BATCH_SLOTS`` > 1 routes requests through the continuous-batching
engine. ``QWEN_DRAFT_PATH``, with a model path, loads a draft checkpoint
the same way for greedy speculative decoding (``inference/speculative.py``);
without a model path it is ignored, as in the reference.

The model lives on an explicit device, ``cuda`` by default (which raises
when no GPU is present); ``create_chat_service`` and ``ChatService`` pass
it on to ``QwenModel.get``. Every thread that launches a chat's work
sets it as its current device: the calling thread of a generation (the
server runs chats in worker threads), and with ``QWEN_BATCH_SLOTS`` above
1 the continuous-batching engine's worker, which decodes. On CUDA the
model runs in bf16 with the flash prefill (kernel K4) and the quantized
matmul (K5; K6 under ``WTPU_MBT_RESIDENT=1`` or ``WTPU_QMM_MB``, K7 under
``WTPU_QWEN_A8=1``, which ``LLMEngine`` reads); on the CPU it keeps the
reference's fp32 configuration.
"""


from __future__ import annotations

import asyncio
import dataclasses
import json
import logging
import os
import re
import threading
import time
from dataclasses import dataclass
from enum import Enum
from typing import Any, Awaitable, Callable

import torch

from whisper_mlx_tpu_torch.runtime.device import device_context, setup_device
from whisper_mlx_tpu_torch.serving.profiles import Profile, get_profile
from whisper_mlx_tpu_torch.serving.tools.base import ToolSpec
from whisper_mlx_tpu_torch.serving.tools.registry import ToolRegistry, get_registry

logger = logging.getLogger("qwen.chat")


# -- data types (reference chat.py:27-59) ------------------------------------


@dataclass(frozen=True)
class ChatMessage:
    role: str
    content: str


@dataclass(frozen=True)
class ToolCall:
    name: str
    arguments: dict[str, Any]


@dataclass(frozen=True)
class ToolResult:
    name: str
    arguments: dict[str, Any]
    result: str
    latency_ms: float


@dataclass(frozen=True)
class ChatResponse:
    response: str
    thinking: tuple[str, ...] = ()
    tool_results: tuple[ToolResult, ...] = ()
    rounds: int = 0
    latency_ms: float = 0.0


# -- prompt helpers ----------------------------------------------------------


def format_tools_prompt(specs: list[ToolSpec]) -> str:
    """Tool-definition block in the Qwen tool-call convention
    (reference chat.py:65-87)."""
    if not specs:
        return ""
    lines = [
        "# Tools",
        "",
        "You may call one or more functions to assist with the user query.",
        "",
        "You are provided with function signatures within <tools></tools> XML tags:",
        "<tools>",
    ]
    for spec in specs:
        lines.append(json.dumps({"type": "function", "function": spec.to_dict()}))
    lines += [
        "</tools>",
        "",
        "For each function call, return a json object with function name and "
        'arguments within <tool_call></tool_call> XML tags:',
        "<tool_call>",
        '{"name": <function-name>, "arguments": <args-json-object>}',
        "</tool_call>",
    ]
    return "\n".join(lines)


_TOOL_CALL_RE = re.compile(r"<tool_call>\s*(\{.*?\})\s*</tool_call>", re.DOTALL)
_THINK_RE = re.compile(r"<think>(.*?)</think>", re.DOTALL)


def parse_tool_calls(text: str) -> list[ToolCall]:
    """Extract <tool_call> JSON blocks (reference chat.py:95-110)."""
    calls = []
    for m in _TOOL_CALL_RE.finditer(text):
        try:
            obj = json.loads(m.group(1))
        except json.JSONDecodeError:
            continue
        name = obj.get("name")
        if isinstance(name, str):
            args = obj.get("arguments") or {}
            calls.append(ToolCall(name=name, arguments=args if isinstance(args, dict) else {}))
    return calls


def extract_final_response(text: str) -> str:
    """Strip thinking + tool-call markup (reference chat.py:113-119)."""
    text = _THINK_RE.sub("", text)
    text = _TOOL_CALL_RE.sub("", text)
    return text.strip()


def extract_thinking(text: str) -> list[str]:
    """Collect <think> blocks (reference chat.py:130-133)."""
    return [m.group(1).strip() for m in _THINK_RE.finditer(text) if m.group(1).strip()]


# -- model registry (reference chat.py:142-147) ------------------------------



class ModelSize(str, Enum):
    SMALL = "small"  # Qwen2.5-7B-Instruct-4bit in the reference
    MEDIUM = "medium"  # Qwen2.5-14B-Instruct-4bit
    LARGE = "large"  # Qwen3-32B-4bit

    @property
    def model_id(self) -> str:
        return {
            ModelSize.SMALL: "mlx-community/Qwen2.5-7B-Instruct-4bit",
            ModelSize.MEDIUM: "mlx-community/Qwen2.5-14B-Instruct-4bit",
            ModelSize.LARGE: "mlx-community/Qwen3-32B-4bit",
        }[self]


def serving_config(config, device: torch.device):
    """bf16 with the flash prefill on CUDA (the kernels' configuration); the
    config as loaded on the CPU."""
    if device.type == "cuda":
        return dataclasses.replace(config, dtype=torch.bfloat16, flash_attention=True)
    return config


class QwenModel:
    """Lazily loaded engine singleton per model size, path and device."""

    _instances: dict[str, "QwenModel"] = {}
    _lock = threading.Lock()

    def __init__(self, model_size: ModelSize = ModelSize.LARGE,
                 model_path: str | None = None, device: str | torch.device = "cuda"):
        self.model_size = model_size
        self.model_path = model_path
        self.device = setup_device(device)
        self._engine = None
        self._load_lock = threading.Lock()

    @classmethod
    def get(cls, model_size: ModelSize = ModelSize.LARGE, model_path: str | None = None,
            device: str | torch.device = "cuda") -> "QwenModel":
        key = f"{model_size}:{model_path}:{torch.device(device)}"
        with cls._lock:
            if key not in cls._instances:
                cls._instances[key] = cls(model_size, model_path, device)
            return cls._instances[key]

    @property
    def engine(self):
        with self._load_lock:
            if self._engine is None:
                self._engine = self._load()
            return self._engine

    def _load(self):
        from whisper_mlx_tpu_torch.inference.generate import LLMEngine

        scripted = os.environ.get("QWEN_SCRIPTED_MODEL")
        if scripted:
            # deterministic golden-session engine (serving/scripted.py):
            # full agent loop + real tools with assertable outputs
            from whisper_mlx_tpu_torch.serving.scripted import ScriptedEngine

            logger.warning("serving SCRIPTED model from %s", scripted)
            return ScriptedEngine.from_file(scripted)
        path = self.model_path or os.environ.get("QWEN_MODEL_PATH")
        draft_path = os.environ.get("QWEN_DRAFT_PATH")
        t0 = time.perf_counter()
        draft = None
        if path:
            from whisper_mlx_tpu_torch.checkpoint.qwen_loader import load_qwen
            from whisper_mlx_tpu_torch.decoding.llm_tokenizer import load_llm_tokenizer

            dtype = torch.bfloat16 if self.device.type == "cuda" else torch.float32
            params, config = load_qwen(path, dtype=dtype, device=self.device)
            tokenizer = load_llm_tokenizer(path)
            if draft_path:
                draft_params, draft_config = load_qwen(draft_path, dtype=dtype,
                                                       device=self.device)
                draft = (draft_params, serving_config(draft_config, self.device))
        else:
            from whisper_mlx_tpu_torch.decoding.llm_tokenizer import ByteFallbackTokenizer
            from whisper_mlx_tpu_torch.models.qwen import QwenConfig, init_params

            tokenizer = ByteFallbackTokenizer()
            config = QwenConfig(
                vocab_size=tokenizer.vocab_size, hidden_size=64, intermediate_size=128,
                num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
                rope_theta=10_000.0, tie_word_embeddings=True)
            params = _to(init_params(config, seed=0), self.device)
            logger.warning("no QWEN_MODEL_PATH set: serving a tiny random model")
        config = serving_config(config, self.device)
        engine = LLMEngine(params, config, tokenizer, draft=draft)
        logger.info("model %s loaded in %.1fs", self.model_size, time.perf_counter() - t0)
        return engine

    @staticmethod
    def _batch_slots() -> int:
        try:
            return max(1, int(os.environ.get("QWEN_BATCH_SLOTS", "1")))
        except ValueError:
            return 1

    def generate(self, messages: list[dict[str, str]], max_tokens: int = 1024,
                 temperature: float = 0.7, on_token=None) -> str:
        # chats run in worker threads: none may fall back to another card
        with device_context(self.device):
            return self._generate(messages, max_tokens, temperature, on_token)

    def _generate(self, messages, max_tokens, temperature, on_token) -> str:
        from whisper_mlx_tpu_torch.inference.generate import apply_chat_template

        prompt = apply_chat_template(messages)
        slots = self._batch_slots()
        if slots > 1:
            handle = self.engine.continuous(slots).submit(
                prompt, max_tokens=max_tokens, temperature=temperature)
            if on_token is None:
                return handle.result_text()
            return _relay(handle.text_stream(), on_token)
        if on_token is not None:
            return _relay(self.engine.stream_generate(
                prompt, max_tokens=max_tokens, temperature=temperature), on_token)
        return self.engine.generate(prompt, max_tokens=max_tokens,
                                    temperature=temperature).text


def _relay(chunks, on_token) -> str:
    out = []
    for chunk in chunks:
        out.append(chunk)
        on_token(chunk)
    return "".join(out)


def _to(node, device):
    if isinstance(node, dict):
        return {k: _to(v, device) for k, v in node.items()}
    if isinstance(node, list):
        return [_to(v, device) for v in node]
    return node.to(device)


# -- chat service (reference chat.py:221-490) --------------------------------

EventCallback = Callable[[str, dict[str, Any]], Awaitable[None]]


class ChatService:
    def __init__(self, model: QwenModel, registry: ToolRegistry | None = None):
        self.model = model
        self.registry = registry or get_registry()

    def _build_messages(
        self, profile: Profile, history: list[ChatMessage], user_message: str
    ) -> list[dict[str, str]]:
        specs = [t.spec for t in self.registry.get_tools(list(profile.tools))]
        system = profile.system_prompt
        for augment in profile.context_augmenters:
            try:
                system += "\n\n" + augment()
            except Exception:
                pass
        tools_prompt = format_tools_prompt(specs)
        if tools_prompt:
            system = system + "\n\n" + tools_prompt
        messages = [{"role": "system", "content": system}]
        messages += [{"role": m.role, "content": m.content} for m in history]
        messages.append({"role": "user", "content": user_message})
        return messages

    # sync agent loop (reference chat.py:239-334)
    def chat(
        self,
        message: str,
        profile_name: str = "general",
        history: list[ChatMessage] | None = None,
        max_tokens: int | None = None,
        temperature: float | None = None,
    ) -> ChatResponse:
        t0 = time.perf_counter()
        profile = get_profile(profile_name)
        messages = self._build_messages(profile, history or [], message)
        thinking: list[str] = []
        tool_results: list[ToolResult] = []
        rounds = 0

        for rounds in range(1, profile.max_tool_rounds + 1):
            text = self.model.generate(
                messages,
                max_tokens=max_tokens or profile.max_tokens,
                temperature=profile.temperature if temperature is None else temperature,
            )
            thinking.extend(extract_thinking(text))
            calls = parse_tool_calls(text)
            if not calls:
                return ChatResponse(
                    response=extract_final_response(text),
                    thinking=tuple(thinking),
                    tool_results=tuple(tool_results),
                    rounds=rounds,
                    latency_ms=(time.perf_counter() - t0) * 1000,
                )
            tool_msgs = []
            for call in calls:
                ct0 = time.perf_counter()
                result = self.registry.execute(call.name, call.arguments)
                tool_results.append(ToolResult(
                    name=call.name, arguments=call.arguments, result=result,
                    latency_ms=(time.perf_counter() - ct0) * 1000,
                ))
                tool_msgs.append(f"<tool_response>\n{result}\n</tool_response>")
            messages.append({"role": "assistant", "content": text})
            messages.append({"role": "user", "content": "\n".join(tool_msgs)})

        return ChatResponse(
            response="(tool-round limit reached without a final answer)",
            thinking=tuple(thinking),
            tool_results=tuple(tool_results),
            rounds=rounds,
            latency_ms=(time.perf_counter() - t0) * 1000,
        )

    # async agent loop with SSE events (reference chat.py:347-490)
    async def chat_async(
        self,
        message: str,
        profile_name: str = "general",
        history: list[ChatMessage] | None = None,
        on_event: EventCallback | None = None,
        max_tokens: int | None = None,
        temperature: float | None = None,
    ) -> ChatResponse:
        async def emit(kind: str, data: dict[str, Any]) -> None:
            if on_event is not None:
                await on_event(kind, data)

        t0 = time.perf_counter()
        profile = get_profile(profile_name)
        messages = self._build_messages(profile, history or [], message)
        thinking: list[str] = []
        tool_results: list[ToolResult] = []
        rounds = 0

        loop = asyncio.get_running_loop()
        for rounds in range(1, profile.max_tool_rounds + 1):
            await emit("generating", {"round": rounds})

            def _on_token(chunk: str) -> None:
                # thread → loop: enqueue a token event (SSE live text)
                asyncio.run_coroutine_threadsafe(
                    emit("token", {"round": rounds, "text": chunk}), loop
                )

            text = await asyncio.to_thread(
                self.model.generate,
                messages,
                max_tokens or profile.max_tokens,
                profile.temperature if temperature is None else temperature,
                _on_token if on_event is not None else None,
            )
            for block in extract_thinking(text):
                thinking.append(block)
                await emit("thinking", {"round": rounds, "content": block})
            calls = parse_tool_calls(text)
            if not calls:
                response = extract_final_response(text)
                await emit("response", {"content": response})
                return ChatResponse(
                    response=response, thinking=tuple(thinking),
                    tool_results=tuple(tool_results), rounds=rounds,
                    latency_ms=(time.perf_counter() - t0) * 1000,
                )
            tool_msgs = []
            for call in calls:
                await emit("tool_call", {"name": call.name, "arguments": call.arguments})
                ct0 = time.perf_counter()
                result = await self.registry.execute_async(call.name, call.arguments)
                latency = (time.perf_counter() - ct0) * 1000
                tool_results.append(ToolResult(
                    name=call.name, arguments=call.arguments,
                    result=result, latency_ms=latency,
                ))
                await emit("tool_result", {
                    "name": call.name, "latency_ms": latency,
                    "result_preview": result[:500],
                })
                tool_msgs.append(f"<tool_response>\n{result}\n</tool_response>")
            messages.append({"role": "assistant", "content": text})
            messages.append({"role": "user", "content": "\n".join(tool_msgs)})

        response = "(tool-round limit reached without a final answer)"
        await emit("response", {"content": response})
        return ChatResponse(
            response=response, thinking=tuple(thinking),
            tool_results=tuple(tool_results), rounds=rounds,
            latency_ms=(time.perf_counter() - t0) * 1000,
        )


def create_chat_service(
    model_size: ModelSize = ModelSize.LARGE, model_path: str | None = None,
    device: str | torch.device = "cuda",
) -> ChatService:
    """Factory (reference chat.py:508-512) over the model on ``device``."""
    return ChatService(QwenModel.get(model_size, model_path, device))

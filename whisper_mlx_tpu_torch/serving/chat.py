"""The lazily loaded Qwen chat model of the daemon.

Counterpart of ``ModelSize`` and ``QwenModel`` in
``whisper_mlx_tpu/serving/chat.py``: model sizes map to the reference's
mlx-community ids; ``QWEN_MODEL_PATH`` (or ``model_path``) loads a local
HF or mlx-format checkpoint directory with its tokenizer, and without one
a tiny random model serves, so the engine runs without weights.
``QWEN_BATCH_SLOTS`` > 1 routes requests through the continuous-batching
engine. ``QWEN_DRAFT_PATH``, with a model path, loads a draft checkpoint
the same way for greedy speculative decoding (``inference/speculative.py``);
without a model path it is ignored, as in the reference.

The model lives on an explicit device, ``cuda`` by default (which raises
when no GPU is present). On CUDA the model runs in bf16 with the flash
prefill (kernel K4) and the quantized matmul (K5; K6 under
``WTPU_MBT_RESIDENT=1`` or ``WTPU_QMM_MB``, K7 under ``WTPU_QWEN_A8=1``, which
``LLMEngine`` reads); on the CPU it keeps the reference's fp32
configuration. ``ChatService``, the prompt and tool
helpers, profiles, tools and the server are ROADMAP.md M13.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import threading
import time
from enum import Enum

import torch

from whisper_mlx_tpu_torch.runtime.device import setup_device

logger = logging.getLogger("qwen.chat")


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

        if os.environ.get("QWEN_SCRIPTED_MODEL"):
            raise NotImplementedError("QWEN_SCRIPTED_MODEL (the scripted engine) is not "
                                      "ported: ROADMAP.md M13")
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

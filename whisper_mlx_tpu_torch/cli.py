"""Transcription CLI of the PyTorch port, with the reference launcher's flags.

    python -m whisper_mlx_tpu_torch.cli input.wav -f txt --output-name out \
        --model large-v3 --condition-on-previous-text False \
        --hallucination-silence-threshold 1 [--device cuda]

Counterpart of ``whisper_mlx_tpu/cli.py``. ``--model`` names a size in
``WHISPER_CONFIGS`` (random weights from seed 0, built on the device, with
the synthetic tokenizer, as the JAX CLI does without a checkpoint) or
``test-tiny``. Loading checkpoint directories is ROADMAP.md M9.
``--device`` defaults to ``cuda`` and raises when no GPU is present.
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

from whisper_mlx_tpu_torch.decoding.tokenizer import make_synthetic_tokenizer
from whisper_mlx_tpu_torch.inference.transcribe import transcribe
from whisper_mlx_tpu_torch.inference.writers import get_writer
from whisper_mlx_tpu_torch.models.whisper import WHISPER_CONFIGS, WhisperConfig, init_params
from whisper_mlx_tpu_torch.runtime.device import setup_device
from whisper_mlx_tpu_torch.runtime.serving_config import apply_asr_serving_config


def str2bool(v: str) -> bool:
    if v.lower() in ("true", "1", "yes"):
        return True
    if v.lower() in ("false", "0", "no"):
        return False
    raise argparse.ArgumentTypeError(f"expected bool, got {v!r}")


def optional_float(v: str):
    return None if v.lower() == "none" else float(v)


def optional_int(v: str):
    return None if v.lower() == "none" else int(v)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("whisper_mlx_tpu_torch", description=__doc__)
    p.add_argument("audio", nargs="+", help="audio file(s) to transcribe")
    p.add_argument("--model", default="tiny", help="model name (random weights)")
    p.add_argument("--model-dir", default=None, help="cache dir for model ids")
    p.add_argument("--device", default="cuda", help="torch device: cuda or cpu")
    p.add_argument("--output-dir", "-o", default=".", help="output directory")
    p.add_argument("--output-name", default=None, help="output file basename")
    p.add_argument("--output-format", "-f", default="txt",
                   choices=["txt", "json", "srt", "vtt", "tsv", "all"])
    p.add_argument("--task", default="transcribe", choices=["transcribe", "translate"])
    p.add_argument("--language", default=None)
    p.add_argument("--temperature", type=float, default=0.0)
    p.add_argument("--temperature-increment-on-fallback", type=optional_float, default=0.2)
    p.add_argument("--best-of", type=optional_int, default=5)
    p.add_argument("--beam-size", type=optional_int, default=None)
    p.add_argument("--patience", type=optional_float, default=None)
    p.add_argument("--length-penalty", type=optional_float, default=None)
    p.add_argument("--suppress-tokens", default="-1")
    p.add_argument("--initial-prompt", default=None)
    p.add_argument("--condition-on-previous-text", type=str2bool, default=True)
    p.add_argument("--compression-ratio-threshold", type=optional_float, default=2.4)
    p.add_argument("--logprob-threshold", type=optional_float, default=-1.0)
    p.add_argument("--no-speech-threshold", type=optional_float, default=0.6)
    p.add_argument("--hallucination-silence-threshold", type=optional_float, default=None)
    p.add_argument("--word-timestamps", type=str2bool, default=False)
    p.add_argument("--clip-timestamps", default="0")
    p.add_argument("--batch-windows", type=str2bool, default=False)
    p.add_argument("--draft-model", default=None)
    p.add_argument("--verbose", type=str2bool, default=True)
    return p


def load_model(model: str, model_dir: str | None, device):
    """Resolve --model to (params, config, tokenizer) on ``device``."""
    path = Path(model)
    if path.exists() or (model_dir and (Path(model_dir) / model.replace("/", "--")).exists()):
        raise NotImplementedError("loading checkpoints: ROADMAP.md M9")
    if model == "test-tiny":
        tokenizer = make_synthetic_tokenizer()
        config = WhisperConfig(
            n_mels=80, n_vocab=tokenizer.n_vocab,
            n_audio_state=64, n_audio_head=4, n_audio_layer=2,
            n_text_state=64, n_text_head=4, n_text_layer=2,
        )
        return init_params(config, 0, device), config, tokenizer
    if model in WHISPER_CONFIGS:
        print(f"warning: no local checkpoint for {model!r}; using random weights",
              file=sys.stderr)
        config = WHISPER_CONFIGS[model]
        return init_params(config, 0, device), config, make_synthetic_tokenizer()
    raise SystemExit(f"model not found: {model}")


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    if args.draft_model:
        raise NotImplementedError("draft-model speculative decoding: ROADMAP.md M11")
    device = setup_device(args.device)

    temperature = args.temperature
    if (inc := args.temperature_increment_on_fallback) is not None:
        temperature = tuple(np_arange(temperature, 1.0 + 1e-6, inc))
    else:
        temperature = [temperature]

    params, config, tokenizer = load_model(args.model, args.model_dir, device)
    params, config = apply_asr_serving_config(params, config, device)
    writer = get_writer(args.output_format, args.output_dir)
    for audio_path in args.audio:
        t0 = time.perf_counter()
        result = transcribe(
            audio_path,
            params=params, config=config, tokenizer=tokenizer, device=device,
            temperature=temperature,
            compression_ratio_threshold=args.compression_ratio_threshold,
            logprob_threshold=args.logprob_threshold,
            no_speech_threshold=args.no_speech_threshold,
            condition_on_previous_text=args.condition_on_previous_text,
            initial_prompt=args.initial_prompt,
            word_timestamps=args.word_timestamps,
            hallucination_silence_threshold=args.hallucination_silence_threshold,
            clip_timestamps=args.clip_timestamps,
            task=args.task,
            language=args.language,
            best_of=args.best_of,
            beam_size=args.beam_size,
            patience=args.patience,
            length_penalty=args.length_penalty,
            suppress_tokens=args.suppress_tokens,
            verbose=args.verbose,
            batch_windows=args.batch_windows,
        )
        name = args.output_name or Path(audio_path).stem
        writer(result, name)
        dt = time.perf_counter() - t0
        if args.verbose:
            print(f"{audio_path}: wrote {name}.{args.output_format} in {dt:.1f}s",
                  file=sys.stderr)
    return 0


def np_arange(start: float, stop: float, step: float) -> list[float]:
    out, x = [], start
    while x < stop:
        out.append(round(x, 10))
        x += step
    return out


if __name__ == "__main__":
    raise SystemExit(main())

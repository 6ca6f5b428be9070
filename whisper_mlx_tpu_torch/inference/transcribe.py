"""transcribe(): the long-form seek loop with the temperature-fallback ladder.

Counterpart of the sequential mode of ``whisper_mlx_tpu/inference/
transcribe.py``: mel over the whole file plus 30 s of padding, 30 s seek
windows, per-window decode with the fallback ladder (T=0 greedy, or beam
search with ``beam_size``/``patience``; T>0 best_of sampling),
compression-ratio / logprob rejection, the no-speech skip and the
timestamp-driven seek advance. The mel stays on the device; each window is
encoded once and its states reused across the ladder.

Not in this slice (each raises ``NotImplementedError``): word timestamps
(ROADMAP.md M8) and with them the ``hallucination_silence_threshold``
re-seek, which the reference applies only to aligned words; batched
windows and the serving batcher (M7); a draft model (M11).
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Any, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from whisper_mlx_tpu_torch.audio.decode import load_audio
from whisper_mlx_tpu_torch.audio.mel import (
    FRAMES_PER_SECOND,
    HOP_LENGTH,
    N_FRAMES,
    N_SAMPLES,
    SAMPLE_RATE,
    log_mel_spectrogram,
)
from whisper_mlx_tpu_torch.decoding.task import (
    DecodingOptions,
    DecodingResult,
    decode,
    detect_language,
)
from whisper_mlx_tpu_torch.decoding.tokenizer import WhisperTokenizer
from whisper_mlx_tpu_torch.models.whisper import Params, WhisperConfig, encode
from whisper_mlx_tpu_torch.runtime.device import setup_device
from whisper_mlx_tpu_torch.runtime.profiling import StageTimer


@dataclass
class Segment:
    id: int
    seek: int
    start: float
    end: float
    text: str
    tokens: list[int]
    temperature: float
    avg_logprob: float
    compression_ratio: float
    no_speech_prob: float

    def to_dict(self) -> dict[str, Any]:
        return {
            "id": self.id, "seek": self.seek, "start": self.start, "end": self.end,
            "text": self.text, "tokens": self.tokens, "temperature": self.temperature,
            "avg_logprob": self.avg_logprob, "compression_ratio": self.compression_ratio,
            "no_speech_prob": self.no_speech_prob,
        }


def _pad_frames(mel: torch.Tensor) -> torch.Tensor:
    """Zero-pad a (frames, n_mels) mel to a full 3000-frame window."""
    return F.pad(mel, (0, 0, 0, N_FRAMES - mel.shape[0])) if mel.shape[0] < N_FRAMES else mel


@torch.inference_mode()
def transcribe(
    audio: str | np.ndarray,
    *,
    params: Params,
    config: WhisperConfig,
    tokenizer: WhisperTokenizer,
    device: str | torch.device,
    temperature: float | Sequence[float] = (0.0, 0.2, 0.4, 0.6, 0.8, 1.0),
    compression_ratio_threshold: float | None = 2.4,
    logprob_threshold: float | None = -1.0,
    no_speech_threshold: float | None = 0.6,
    condition_on_previous_text: bool = True,
    initial_prompt: str | None = None,
    word_timestamps: bool = False,
    hallucination_silence_threshold: float | None = None,
    clip_timestamps: str | list[float] = "0",
    verbose: bool | None = None,
    batch_windows: bool = False,
    draft_params: Params | None = None,
    stage_timer: StageTimer | None = None,
    **decode_options: Any,
) -> dict[str, Any]:
    """-> ``{"text", "segments", "language", "stages"}``.

    ``params`` must already live on ``device``; a CUDA device without a GPU
    raises. ``hallucination_silence_threshold`` is accepted for the CLI's
    flag surface and, as in the reference, only acts with word timestamps.
    """
    if word_timestamps:
        raise NotImplementedError("word_timestamps: ROADMAP.md M8")
    if batch_windows:
        raise NotImplementedError("batch_windows and the serving batcher: ROADMAP.md M7")
    if draft_params is not None:
        raise NotImplementedError("draft-model speculative decoding: ROADMAP.md M11")
    device = setup_device(device)
    if isinstance(audio, (str, bytes)) or hasattr(audio, "__fspath__"):
        audio = load_audio(audio)
    audio = np.asarray(audio, np.float32)
    stage_timer = stage_timer or StageTimer()

    # mel over content + 30 s of zero padding (so the last window is full)
    padded = np.concatenate([audio, np.zeros(N_SAMPLES, np.float32)])
    with stage_timer.stage("mel"):
        mel_all = log_mel_spectrogram(torch.from_numpy(padded).to(device),
                                      n_mels=config.n_mels)
    content_frames = mel_all.shape[0] - N_FRAMES

    language = decode_options.pop("language", None)
    task = decode_options.pop("task", "transcribe")
    if language is None:
        if config.n_vocab < 51865:
            language = "en"  # English-only / synthetic models
        else:
            with stage_timer.stage("detect_language"):
                states0 = encode(params, _pad_frames(mel_all[:N_FRAMES])[None], config)
                codes, _probs = detect_language(params, states0, tokenizer, config)
                language = codes[0]
            if verbose:
                print(f"detected language: {language}")
    tokenizer.language = language
    tokenizer.task = task

    if isinstance(temperature, (int, float)):
        temperatures = [float(temperature)]
    else:
        temperatures = list(temperature)

    # clip_timestamps -> seek clip ranges in frames
    if isinstance(clip_timestamps, str):
        clip_points = [float(t) for t in clip_timestamps.split(",")] if clip_timestamps else [0.0]
    else:
        clip_points = list(clip_timestamps) or [0.0]
    seek_points = [round(t * FRAMES_PER_SECOND) for t in clip_points]
    if len(seek_points) % 2 == 1:
        seek_points.append(content_frames)
    seek_clips = list(zip(seek_points[::2], seek_points[1::2]))

    input_stride = N_FRAMES // config.n_audio_ctx  # 2 mel frames per token
    time_precision = input_stride * HOP_LENGTH / SAMPLE_RATE  # 0.02 s

    all_tokens: list[int] = []
    all_segments: list[Segment] = []
    prompt_reset_since = 0
    if initial_prompt is not None:
        all_tokens.extend(tokenizer.encode(" " + initial_prompt.strip()))

    def decode_with_fallback(segment_mel: torch.Tensor, prompt: list[int]) -> DecodingResult:
        with stage_timer.stage("encode"):
            states = encode(params, segment_mel[None], config)
        result: DecodingResult | None = None
        for t in temperatures:
            opts = DecodingOptions(task=task, language=language, temperature=t,
                                   prompt=prompt if prompt else None, **decode_options)
            if t > 0:
                # beam/patience only apply at t==0 (reference ladder semantics)
                opts = replace(opts, beam_size=None, patience=None,
                               best_of=opts.best_of or 5)
            gen = torch.Generator(device=device).manual_seed(
                int(t * 1000) + 17 * len(all_segments))
            with stage_timer.stage("decode"):
                result = decode(params, states, tokenizer, config, opts,
                                states_precomputed=True, generator=gen)[0]
            needs_fallback = False
            if (compression_ratio_threshold is not None
                    and result.compression_ratio > compression_ratio_threshold):
                needs_fallback = True
            if (logprob_threshold is not None
                    and result.avg_logprob < logprob_threshold):
                needs_fallback = True
            if (no_speech_threshold is not None
                    and result.no_speech_prob > no_speech_threshold
                    and logprob_threshold is not None
                    and result.avg_logprob < logprob_threshold):
                needs_fallback = False  # silence: don't ladder, skip outside
            if not needs_fallback:
                break
        return result

    for seek_clip_start, seek_clip_end in seek_clips:
        seek = seek_clip_start
        while seek < min(seek_clip_end, content_frames):
            time_offset = seek * HOP_LENGTH / SAMPLE_RATE
            segment_size = min(N_FRAMES, content_frames - seek, seek_clip_end - seek)
            mel_segment = _pad_frames(mel_all[seek : seek + segment_size])
            segment_duration = segment_size * HOP_LENGTH / SAMPLE_RATE

            prompt = all_tokens[prompt_reset_since:]
            result = decode_with_fallback(mel_segment, prompt)
            tokens = np.asarray(result.tokens)

            if no_speech_threshold is not None:
                should_skip = result.no_speech_prob > no_speech_threshold
                if (logprob_threshold is not None
                        and result.avg_logprob > logprob_threshold):
                    should_skip = False  # confident text overrides no-speech
                if should_skip:
                    seek += segment_size
                    continue

            previous_seek = seek
            current_segments: list[Segment] = []

            ts_begin = tokenizer.timestamp_begin
            timestamp_tokens = tokens >= ts_begin
            single_timestamp_ending = (
                len(tokens) >= 2 and not timestamp_tokens[-2] and timestamp_tokens[-1]
            )
            consecutive = np.where(timestamp_tokens[:-1] & timestamp_tokens[1:])[0] + 1

            def make_segment(start, end, seg_tokens):
                text_tokens = [t for t in seg_tokens if t < tokenizer.eot]
                return Segment(
                    id=len(all_segments) + len(current_segments),
                    seek=previous_seek,
                    start=start, end=end,
                    text=tokenizer.decode(text_tokens),
                    tokens=list(map(int, seg_tokens)),
                    temperature=result.temperature,
                    avg_logprob=result.avg_logprob,
                    compression_ratio=result.compression_ratio,
                    no_speech_prob=result.no_speech_prob,
                )

            if len(consecutive) > 0:
                slices = consecutive.tolist()
                if single_timestamp_ending:
                    slices.append(len(tokens))
                last_slice = 0
                for current_slice in slices:
                    seg = tokens[last_slice:current_slice]
                    start_pos = seg[0] - ts_begin
                    end_pos = seg[-1] - ts_begin
                    current_segments.append(make_segment(
                        time_offset + start_pos * time_precision,
                        time_offset + end_pos * time_precision,
                        seg,
                    ))
                    last_slice = current_slice
                if single_timestamp_ending:
                    seek += segment_size
                else:
                    last_ts_pos = int(tokens[last_slice - 1] - ts_begin)
                    seek += last_ts_pos * input_stride
            else:
                duration = segment_duration
                timestamps = tokens[timestamp_tokens]
                if len(timestamps) > 0 and timestamps[-1] != ts_begin:
                    duration = float(timestamps[-1] - ts_begin) * time_precision
                current_segments.append(make_segment(
                    time_offset, time_offset + duration, tokens
                ))
                seek += segment_size

            if seek <= previous_seek:
                # a degenerate 0.00/0.00 timestamp pair would stall the loop
                seek = previous_seek + segment_size

            for seg in current_segments:
                # reference keeps degenerate segments but blanks their content
                if seg.start == seg.end or not seg.text.strip():
                    seg.text = ""
                    seg.tokens = []
                all_segments.append(seg)
                all_tokens.extend(seg.tokens)

            if not condition_on_previous_text or result.temperature > 0.5:
                prompt_reset_since = len(all_tokens)

            if verbose:
                for seg in current_segments:
                    print(f"[{seg.start:7.2f} → {seg.end:7.2f}] {seg.text}")

    return {
        "text": "".join(s.text for s in all_segments),
        "segments": [s.to_dict() for s in all_segments],
        "language": language,
        "stages": stage_timer.summary(),
    }

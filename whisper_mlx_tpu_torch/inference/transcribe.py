"""transcribe(): the long-form seek loop with the temperature-fallback ladder.

Counterpart of ``whisper_mlx_tpu/inference/transcribe.py``. Two modes:

- **sequential** (default): mel over the whole file plus 30 s of padding,
  30 s seek windows, per-window decode with the fallback ladder (T=0
  greedy, or beam search with ``beam_size``/``patience``; T>0 best_of
  sampling), compression-ratio / logprob rejection, the no-speech skip and
  the timestamp-driven seek advance. The mel stays on the device; each
  window is encoded once and its states reused across the ladder.
- **batched** (``batch_windows=True``): fixed-stride windows, encoded and
  decoded ``window_batch_size`` at a time, every window independent (no
  conditioning on previous text), the next chunk's encode and first rung
  started before this chunk's host tail; retry rungs decode only the
  windows still pending. Text can differ from the sequential mode at
  window boundaries.

With ``word_timestamps`` each segment gets ``words`` from the
cross-attention DTW alignment (``inference/word_timestamps.py``); in the
sequential mode the seek then follows the last aligned word, and
``hallucination_silence_threshold`` re-seeks past anomalous segments
surrounded by silence.

With ``draft_params`` (and ``draft_config``, the target's by default) the
sequential mode's T = 0 rung runs draft-assisted greedy decoding
(``decoding/speculative.py``, ``spec_k`` proposals a verify) unless a beam
is asked for: token-identical to plain greedy. The batched mode ignores the
draft, as the reference does.

``mesh=`` (``parallel/mesh.py:make_mesh``): every rank of the job calls
``transcribe`` with the same arguments (SPMD) and gets the same dict. The
tree is sharded over the mesh (``parallel/sharding.py:shard_model``: a
tensor-parallel fp tree, a quantized one whole). In the batched mode
``window_batch_size`` and the retry rungs' buckets are rounded up to
multiples of dp, each rank encodes and decodes its contiguous slice of a
chunk, and the results are gathered in window order; sampled rungs draw
the whole chunk's noise on every rank, so the tokens equal one device's.
The sequential mode decodes every window on every rank (tensor
parallelism still splits each step).
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
from whisper_mlx_tpu_torch.decoding.speculative import spec_decode_task
from whisper_mlx_tpu_torch.decoding.tokenizer import WhisperTokenizer
from whisper_mlx_tpu_torch.inference.word_timestamps import add_word_timestamps
from whisper_mlx_tpu_torch.models.whisper import Params, WhisperConfig, encode
from whisper_mlx_tpu_torch.ops.quant import maybe_dense_decode_params
from whisper_mlx_tpu_torch.parallel.mesh import Mesh, all_gather_cat, all_gather_objects
from whisper_mlx_tpu_torch.parallel.sharding import dp_round, shard_batch, shard_model
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
    words: list[dict] | None = None

    def to_dict(self) -> dict[str, Any]:
        d = {
            "id": self.id, "seek": self.seek, "start": self.start, "end": self.end,
            "text": self.text, "tokens": self.tokens, "temperature": self.temperature,
            "avg_logprob": self.avg_logprob, "compression_ratio": self.compression_ratio,
            "no_speech_prob": self.no_speech_prob,
        }
        if self.words is not None:
            d["words"] = self.words
        return d


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
    prepend_punctuations: str = "\"'“¿([{-",
    append_punctuations: str = "\"'.。,，!！?？:：”)]}、",
    verbose: bool | None = None,
    batch_windows: bool = False,
    window_batch_size: int = 8,
    mesh: Any | None = None,
    draft_params: Params | None = None,
    draft_config: WhisperConfig | None = None,
    spec_k: int = 4,
    stage_timer: StageTimer | None = None,
    **decode_options: Any,
) -> dict[str, Any]:
    """-> ``{"text", "segments", "language", "stages"}``.

    ``params`` must already live on ``device``; a CUDA device without a GPU
    raises. ``hallucination_silence_threshold`` acts only with word
    timestamps in the sequential mode, as in the reference.
    """
    if mesh is not None and not isinstance(mesh, Mesh):
        raise TypeError(f"mesh=: expected a parallel.mesh.Mesh, got {type(mesh).__name__}")
    params, config = shard_model(params, config, mesh)
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
    content_duration = content_frames * HOP_LENGTH / SAMPLE_RATE

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

    if batch_windows:
        return _transcribe_batched(
            mel_all, content_frames, params, config, tokenizer, device,
            temperatures, compression_ratio_threshold, logprob_threshold,
            no_speech_threshold, initial_prompt, window_batch_size,
            word_timestamps, decode_options, stage_timer, mesh,
        )

    input_stride = N_FRAMES // config.n_audio_ctx  # 2 mel frames per token
    time_precision = input_stride * HOP_LENGTH / SAMPLE_RATE  # 0.02 s

    all_tokens: list[int] = []
    all_segments: list[Segment] = []
    prompt_reset_since = 0
    last_speech_timestamp = 0.0  # end of the last aligned word (hallucination re-seek)
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
            # best_of is a T > 0 option (decode ignores it at T = 0), so the
            # draft path needs only greedy and no beam
            use_spec = t == 0 and draft_params is not None and opts.beam_size is None
            with stage_timer.stage("decode"):
                if use_spec:
                    result = spec_decode_task(params, draft_params, states, tokenizer, config,
                                              draft_config or config, opts, k=spec_k,
                                              states_precomputed=True)[0]
                else:
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

            if word_timestamps:
                with stage_timer.stage("align"):
                    add_word_timestamps(
                        current_segments, params, config, tokenizer, mel_segment,
                        time_offset, prepend_punctuations, append_punctuations,
                        num_frames=segment_size,
                    )
                # aligned times beat predicted ones: a window that did not end
                # on a timestamp pair re-seeks to its last aligned word's end
                if not single_timestamp_ending:
                    last_word_end = _get_end(current_segments)
                    if last_word_end is not None and last_word_end > time_offset:
                        seek = round(last_word_end * FRAMES_PER_SECOND)

                if hallucination_silence_threshold is not None:
                    seek, drop_window = _hallucination_reseek(
                        current_segments,
                        seek=seek,
                        previous_seek=previous_seek,
                        segment_size=segment_size,
                        time_offset=time_offset,
                        segment_duration=segment_duration,
                        content_frames=content_frames,
                        content_duration=content_duration,
                        threshold=hallucination_silence_threshold,
                        last_speech_timestamp=last_speech_timestamp,
                        single_timestamp_ending=single_timestamp_ending,
                    )
                    if drop_window:
                        continue

                last_word_end = _get_end(current_segments)
                if last_word_end is not None:
                    last_speech_timestamp = last_word_end

            for seg in current_segments:
                # reference keeps degenerate segments but blanks their content
                if seg.start == seg.end or not seg.text.strip():
                    seg.text = ""
                    seg.tokens = []
                    seg.words = [] if seg.words is not None else None
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


# --- hallucination-silence helpers (whisper's anomaly heuristic) ------------

_ANOMALY_PUNCT = "\"'“¿([{-\"'.。,，!！?？:：”)]}、"


def _word_anomaly_score(word: dict) -> float:
    """How implausible one aligned word looks: low probability, impossibly
    short or suspiciously long durations all add to the score."""
    probability = word.get("probability", 0.0)
    duration = word["end"] - word["start"]
    score = 0.0
    if probability < 0.15:
        score += 1.0
    if duration < 0.133:
        score += (0.133 - duration) * 15.0
    if duration > 2.0:
        score += duration - 2.0
    return score


def _is_segment_anomaly(segment: Segment | None) -> bool:
    """A segment is anomalous when its first few non-punctuation words are
    together implausible (score >= 3, or nearly every word scores)."""
    if segment is None or not segment.words:
        return False
    words = [w for w in segment.words if w["word"].strip() not in _ANOMALY_PUNCT]
    words = words[:8]
    if not words:
        return False
    score = sum(_word_anomaly_score(w) for w in words)
    return score >= 3.0 or score + 0.01 >= len(words)


def _next_words_segment(segments: list[Segment]) -> Segment | None:
    return next((s for s in segments if s.words), None)


def _get_end(segments: list[Segment]) -> float | None:
    """End time of the last aligned word across ``segments`` (None if none)."""
    return next(
        (w["end"] for s in reversed(segments) for w in reversed(s.words or [])),
        None,
    )


def _hallucination_reseek(
    current_segments: list[Segment],
    *,
    seek: int,
    previous_seek: int,
    segment_size: int,
    time_offset: float,
    segment_duration: float,
    content_frames: int,
    content_duration: float,
    threshold: float,
    last_speech_timestamp: float,
    single_timestamp_ending: bool,
) -> tuple[int, bool]:
    """The ``hallucination_silence_threshold`` seek logic. May truncate
    ``current_segments`` in place; returns ``(new_seek, drop_window)``, where
    ``drop_window`` means: discard the window and decode again from
    ``new_seek``.

    Three rules, in order:
    1. a long silent tail after the last aligned word -> re-window there;
    2. an anomalous first segment after a silent lead-in longer than the
       threshold -> drop the window, re-seek to the anomaly's start;
    3. an anomalous segment with silence on both sides mid-window -> cut
       the segment list there and re-seek just past its start.
    """
    window_end_time = time_offset + segment_duration
    if not single_timestamp_ending:
        last_word_end = _get_end(current_segments)
        if last_word_end is not None and last_word_end > time_offset:
            remaining = window_end_time - last_word_end
            if remaining > threshold:
                seek = round(last_word_end * FRAMES_PER_SECOND)
            else:
                seek = previous_seek + segment_size

    first_segment = _next_words_segment(current_segments)
    if first_segment is not None and _is_segment_anomaly(first_segment):
        gap = first_segment.start - time_offset
        if gap > threshold:
            return previous_seek + round(gap * FRAMES_PER_SECOND), True

    hal_last_end = last_speech_timestamp
    for si, segment in enumerate(current_segments):
        if not segment.words:
            continue
        if _is_segment_anomaly(segment):
            next_segment = _next_words_segment(current_segments[si + 1:])
            if next_segment is not None:
                hal_next_start = next_segment.words[0]["start"]
            else:
                hal_next_start = time_offset + segment_duration
            silence_before = (
                segment.start - hal_last_end > threshold
                or segment.start < threshold
                or segment.start - time_offset < 2.0
            )
            silence_after = (
                hal_next_start - segment.end > threshold
                or _is_segment_anomaly(next_segment)
                or window_end_time - segment.end < 2.0
            )
            if silence_before and silence_after:
                seek = round(max(time_offset + 1, segment.start) * FRAMES_PER_SECOND)
                if content_duration - segment.end < threshold:
                    seek = content_frames
                current_segments[si:] = []
                break
        hal_last_end = segment.end
    return seek, False


# ---------------------------------------------------------------------------
# batched mode
# ---------------------------------------------------------------------------


def _rung_passes(r: DecodingResult, compression_ratio_threshold: float | None,
                 logprob_threshold: float | None, no_speech_threshold: float | None) -> bool:
    """The batched ladder's acceptance of one window's result (silence is
    accepted here and skipped at assembly)."""
    ok = True
    if (compression_ratio_threshold is not None
            and r.compression_ratio > compression_ratio_threshold):
        ok = False
    if logprob_threshold is not None and r.avg_logprob < logprob_threshold:
        ok = False
    if no_speech_threshold is not None and r.no_speech_prob > no_speech_threshold:
        ok = True
    return ok


def window_segments(r: DecodingResult, w: int, first_id: int, tokenizer: WhisperTokenizer,
                    config: WhisperConfig) -> list[Segment]:
    """Segments of fixed-stride window ``w`` from its decode result: split
    at each consecutive timestamp pair, timed by the timestamps inside, the
    text-less ones left out. Shared by the batched mode and the batcher."""
    input_stride = N_FRAMES // config.n_audio_ctx
    time_precision = input_stride * HOP_LENGTH / SAMPLE_RATE
    time_offset = w * N_FRAMES * HOP_LENGTH / SAMPLE_RATE
    tokens = np.asarray(r.tokens)
    ts_begin = tokenizer.timestamp_begin
    ts_mask = tokens >= ts_begin
    consecutive = np.where(ts_mask[:-1] & ts_mask[1:])[0] + 1
    bounds = [0] + consecutive.tolist() + [len(tokens)]
    out: list[Segment] = []
    for b0, b1 in zip(bounds[:-1], bounds[1:]):
        seg_toks = tokens[b0:b1]
        if len(seg_toks) == 0:
            continue
        ts_in = seg_toks[seg_toks >= ts_begin]
        s = time_offset + (float(ts_in[0] - ts_begin) * time_precision if len(ts_in) else 0.0)
        e = time_offset + (float(ts_in[-1] - ts_begin) * time_precision if len(ts_in) else 30.0)
        text = tokenizer.decode([t for t in seg_toks.tolist() if t < tokenizer.eot])
        if not text.strip():
            continue
        out.append(Segment(
            id=first_id + len(out), seek=w * N_FRAMES, start=s, end=e, text=text,
            tokens=list(map(int, seg_toks)), temperature=r.temperature,
            avg_logprob=r.avg_logprob, compression_ratio=r.compression_ratio,
            no_speech_prob=r.no_speech_prob,
        ))
    return out


def _transcribe_batched(
    mel_all: torch.Tensor,
    content_frames: int,
    params: Params,
    config: WhisperConfig,
    tokenizer: WhisperTokenizer,
    device: torch.device,
    temperatures: list[float],
    compression_ratio_threshold: float | None,
    logprob_threshold: float | None,
    no_speech_threshold: float | None,
    initial_prompt: str | None,
    window_batch_size: int,
    word_timestamps: bool,
    decode_options: dict,
    stage_timer: StageTimer,
    mesh: Mesh | None = None,
) -> dict[str, Any]:
    """Fixed-stride windows, decoded ``window_batch_size`` at a time; every
    window is independent (no conditioning on previous text, as the
    reference launcher runs). The windows are device slices of ``mel_all``,
    whose 30 s tail of padding makes every slice full length. With
    ``mesh`` each rank runs its dp slice of every chunk (module docstring)."""
    window_batch_size = dp_round(window_batch_size, mesh)
    n_windows = max(1, -(-content_frames // N_FRAMES))
    mel_batch = mel_all[: n_windows * N_FRAMES].reshape(n_windows, N_FRAMES, -1)

    prompt = tokenizer.encode(" " + initial_prompt.strip()) if initial_prompt else None
    all_segments: list[Segment] = []

    # a packed 4/8-bit tree is converted here by the decode loop's rows, so
    # that the encoder runs on the same tree decode() will use
    params = maybe_dense_decode_params(
        params,
        window_batch_size * (decode_options.get("beam_size")
                             or decode_options.get("best_of") or 1),
        dtype=config.dtype)

    def _rung_opts(t: float) -> DecodingOptions:
        opts = DecodingOptions(task=tokenizer.task, language=tokenizer.language,
                               temperature=t, prompt=prompt, **decode_options)
        if t > 0:
            opts = replace(opts, beam_size=None, patience=None)
        return opts

    def _generator(t: float) -> torch.Generator:
        return torch.Generator(device=device).manual_seed(int(t * 1000))

    def _decode(local: torch.Tensor, total: int, t: float) -> list:
        """One rung over this rank's dp slice ``local`` of ``total`` windows'
        states; the results of every slice, gathered in order."""
        rows = None
        if mesh is not None:
            rows = (mesh.index("dp") * local.shape[0], total)
        out = decode(params, local, tokenizer, config, _rung_opts(t),
                     states_precomputed=True, generator=_generator(t), rows=rows)
        return [r for part in all_gather_objects(out, mesh, "dp") for r in part]

    for start in range(0, n_windows, window_batch_size):
        chunk = mel_batch[start: start + window_batch_size]
        real = chunk.shape[0]
        if real < window_batch_size:  # one shape for every chunk
            chunk = F.pad(chunk, (0, 0, 0, 0, 0, window_batch_size - real))
        with stage_timer.stage("encode"):
            local_states = encode(params, shard_batch(chunk, mesh), config)
        states = None  # the whole chunk's, gathered over dp for a retry rung
        results: list[DecodingResult | None] = [None] * real
        pending = list(range(real))
        for ti, t in enumerate(temperatures):
            if not pending:
                break
            with stage_timer.stage("decode"):
                if ti == 0:
                    idx_map = list(range(real))
                    batch_results = _decode(local_states, window_batch_size, t)
                else:
                    # retry rungs decode only the pending windows, gathered
                    # to the next power of two (a multiple of dp, capped at
                    # the batch)
                    if states is None:
                        states = all_gather_cat(local_states, mesh, "dp")
                    bucket = min(dp_round(1 << (len(pending) - 1).bit_length(), mesh),
                                 window_batch_size)
                    sel = (pending + [pending[-1]] * (bucket - len(pending)))[:bucket]
                    idx_map = pending
                    sub = states[torch.tensor(sel, device=states.device)]
                    batch_results = _decode(shard_batch(sub, mesh), bucket, t)
            still = []
            for j, i in enumerate(idx_map):
                r = batch_results[j]
                results[i] = r  # the latest attempt, kept if the ladder runs out
                if not _rung_passes(r, compression_ratio_threshold, logprob_threshold,
                                    no_speech_threshold):
                    still.append(i)
            pending = still

        for i in range(real):
            w = start + i
            r = results[i]
            if (no_speech_threshold is not None
                    and r.no_speech_prob > no_speech_threshold
                    and (logprob_threshold is None or r.avg_logprob < logprob_threshold)):
                continue
            segs = window_segments(r, w, len(all_segments), tokenizer, config)
            if word_timestamps and segs:
                with stage_timer.stage("align"):
                    add_word_timestamps(segs, params, config, tokenizer, chunk[i],
                                        w * N_FRAMES * HOP_LENGTH / SAMPLE_RATE)
            all_segments.extend(segs)

    return {
        "text": "".join(s.text for s in all_segments),
        "segments": [s.to_dict() for s in all_segments],
        "language": tokenizer.language,
        "stages": stage_timer.summary(),
    }

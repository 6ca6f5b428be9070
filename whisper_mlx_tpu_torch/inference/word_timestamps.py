"""Word-level timestamps: cross-attention DTW alignment.

Counterpart of ``whisper_mlx_tpu/inference/word_timestamps.py``: a
teacher-forced decoder pass that returns the cross-attention weights of
the alignment heads, per-head normalization and a median filter, DTW over
the token x frame cost matrix, word grouping by the tokenizer, and
punctuation merging.

The pass re-encodes the window (kernel K2 on the card) and runs one
``decode_step`` prefill over the whole token sequence with
``collect_cross_attn=True``: fp caches, both attentions through
``models/whisper.py:attention_for_alignment`` (plain tensor ops, as the
reference leaves them to XLA), the linears through ``linear`` (a packed
4-bit tree: kernel K5). Only the alignment heads' weights go to the host.
DTW runs on the host: the C++ one (``native/``) where ``g++`` built it,
else NumPy, with identical paths.

Alignment heads: an explicit argument, else the checkpoint's
(``config.alignment_heads``), else every head of the decoder's upper half.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from whisper_mlx_tpu_torch.decoding.tokenizer import WhisperTokenizer
from whisper_mlx_tpu_torch.models.whisper import (
    Params,
    WhisperConfig,
    cross_kv,
    decode_step,
    encode,
    init_kv_cache,
)

AUDIO_TIME_PER_TOKEN = 0.02


def default_alignment_heads(config: WhisperConfig) -> list[tuple[int, int]]:
    """All heads of the upper half of decoder layers (fallback mask)."""
    lo = config.n_text_layer // 2
    return [(l, h) for l in range(lo, config.n_text_layer) for h in range(config.n_text_head)]


def median_filter(x: np.ndarray, width: int,
                  device: torch.device | str = "cpu") -> np.ndarray:
    """Median filter along the last axis, reflect-padded.

    An odd width's median is one of the window's values, so ``torch.median``
    over the windows on ``device`` gives NumPy's result exactly, in far less
    time than NumPy's per-window median (the alignment pass filters every
    alignment head x T x 1500 frames: 320 heads on large-v3 without a
    checkpoint's mask); an even width takes NumPy's mean of the two middle
    values.
    """
    if width <= 1 or x.shape[-1] <= width:
        return x
    pad = width // 2
    xp = np.pad(x, [(0, 0)] * (x.ndim - 1) + [(pad, pad)], mode="reflect")
    if width % 2 == 0:
        windows = np.lib.stride_tricks.sliding_window_view(xp, width, axis=-1)
        return np.median(windows, axis=-1)
    windows = torch.from_numpy(xp).to(device).unfold(-1, width, 1)
    return windows.median(dim=-1).values.cpu().numpy()


def dtw_numpy(cost: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """:func:`dtw` in NumPy (the path where no ``g++`` built the library)."""
    N, M = cost.shape
    D = np.full((N + 1, M + 1), np.inf, dtype=np.float64)
    D[0, 0] = 0.0
    trace = np.zeros((N + 1, M + 1), dtype=np.int8)
    for i in range(1, N + 1):
        row = cost[i - 1]
        prev = D[i - 1]
        cur = D[i]
        # c[j] = row[j-1] + min(prev[j-1] (diag), prev[j] (down), cur[j-1] (right))
        m_diag = prev[:-1]
        m_down = prev[1:]
        c_prev = np.inf
        for j in range(1, M + 1):
            c0, c1, c2 = m_diag[j - 1], m_down[j - 1], c_prev
            if c0 < c1 and c0 < c2:
                best, move = c0, 0  # diagonal
            elif c1 < c0 and c1 < c2:
                best, move = c1, 1  # down (advance token only)
            else:
                best, move = c2, 2  # right (advance frame only)
            c_prev = row[j - 1] + best
            cur[j] = c_prev
            trace[i, j] = move
    i, j = N, M
    text_idx, time_idx = [], []
    while i > 0 and j > 0:
        text_idx.append(i - 1)
        time_idx.append(j - 1)
        move = trace[i, j]
        if move == 0:
            i, j = i - 1, j - 1
        elif move == 1:
            i -= 1
        else:
            j -= 1
    return np.array(text_idx[::-1]), np.array(time_idx[::-1])


def dtw(cost: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Monotone alignment path minimizing summed cost.

    ``cost`` is (tokens, frames). Returns (text_indices, time_indices), the
    3-move (down, right, diagonal) DTW traceback, through the C++ library
    where ``g++`` built it, else :func:`dtw_numpy`. Ties break as the
    openai / transformers comparator does (diagonal or down only when
    strictly smaller than both others, else right), so both paths give the
    reference's paths on tied costs.
    """
    from whisper_mlx_tpu_torch import native

    lib = native.load()
    return lib.dtw(cost) if lib is not None else dtw_numpy(cost)


def alignment_path(
    w: np.ndarray,  # (heads, tokens, 1500) post-softmax cross-attention
    num_frames: int,
    *,
    n_skip_rows: int,
    medfilt_width: int = 7,
    device: torch.device | str = "cpu",
) -> tuple[np.ndarray, np.ndarray]:
    """Normalize -> median-filter (on ``device``) -> head mean -> DTW.

    Rows ``[n_skip_rows : -1]`` enter the DTW (the sot-sequence rows and the
    row at EOT are dropped). The weights are sliced to ``num_frames // 2``
    frames and renormalized over the kept frames, which equals openai's
    softmax after the slice.
    """
    w = w[:, :, : num_frames // 2].astype(np.float32)
    w = w / np.maximum(w.sum(-1, keepdims=True), 1e-9)
    mean = w.mean(axis=-2, keepdims=True)
    std = w.std(axis=-2, keepdims=True)
    w = (w - mean) / np.maximum(std, 1e-9)
    w = median_filter(w, medfilt_width, device)
    matrix = w.mean(axis=0)  # (T, frames)
    matrix = matrix[n_skip_rows:-1]  # rows for [no_timestamps, *text_tokens]
    return dtw(-matrix.astype(np.float64))


@dataclass
class WordTiming:
    word: str
    tokens: list[int]
    start: float
    end: float
    probability: float


@torch.inference_mode()
def find_alignment(
    params: Params,
    config: WhisperConfig,
    tokenizer: WhisperTokenizer,
    text_tokens: list[int],
    mel_window: torch.Tensor | np.ndarray,  # (3000, n_mels): one 30 s window
    num_frames: int,
    *,
    medfilt_width: int = 7,
    alignment_heads: list[tuple[int, int]] | None = None,
) -> list[WordTiming]:
    """Word timings of ``text_tokens`` in one window. ``mel_window`` is a
    tensor on the params' device (a numpy array goes to the CPU)."""
    if not text_tokens:
        return []
    heads = (alignment_heads
             or (list(config.alignment_heads) if config.alignment_heads else None)
             or default_alignment_heads(config))
    sot_seq = list(tokenizer.sot_sequence)
    tokens = sot_seq + [tokenizer.no_timestamps] + list(text_tokens) + [tokenizer.eot]
    n_real = len(tokens)

    # the weights need full-precision caches
    config = dataclasses.replace(config, kv_bits=0, self_kv_bits=0)
    # EOT-pad the prefill to a multiple of 32, as the reference does to
    # bound its compiled shapes: causality makes the pad rows inert, and
    # every read below takes the n_real true rows
    n_pad = min(-(-n_real // 32) * 32, config.n_text_ctx)
    tokens_in = tokens + [tokenizer.eot] * (n_pad - n_real)
    mel = torch.as_tensor(mel_window)
    device = mel.device
    states = encode(params, mel[None], config)
    xkv = cross_kv(params, states, config)
    cache = init_kv_cache(config, 1, device, max_len=n_pad)
    logits, _, cross = decode_step(
        params, torch.tensor([tokens_in], dtype=torch.long, device=device), 0, cache, xkv,
        config, collect_cross_attn=True)
    # token probabilities (text vocab only) at the positions predicting text_tokens
    lg = logits[0, len(sot_seq): len(sot_seq) + len(text_tokens), : tokenizer.eot]
    sampled = lg.float().cpu().numpy()
    probs = np.exp(sampled - sampled.max(-1, keepdims=True))
    probs /= probs.sum(-1, keepdims=True)
    text_token_probs = probs[np.arange(len(text_tokens)), text_tokens]

    # cross: (layers, 1, heads, T, 1500) -> the alignment heads (H, n_real, 1500)
    w = torch.stack([cross[l, 0, h, :n_real] for l, h in heads]).float().cpu().numpy()
    text_indices, time_indices = alignment_path(
        w, num_frames, n_skip_rows=len(sot_seq), medfilt_width=medfilt_width, device=device)

    words, word_tokens = tokenizer.split_to_word_tokens(list(text_tokens) + [tokenizer.eot])
    if len(word_tokens) <= 1:
        return []
    word_boundaries = np.pad(np.cumsum([len(t) for t in word_tokens[:-1]]), (1, 0))

    jumps = np.pad(np.diff(text_indices), (1, 0), constant_values=1).astype(bool)
    jump_times = time_indices[jumps] * AUDIO_TIME_PER_TOKEN
    start_times = jump_times[word_boundaries[:-1]]
    end_times = jump_times[np.minimum(word_boundaries[1:], len(jump_times) - 1)]
    word_probs = [
        float(np.mean(text_token_probs[i:j])) if j > i else 0.0
        for i, j in zip(word_boundaries[:-1], word_boundaries[1:])
    ]
    return [
        WordTiming(word=w_, tokens=t_, start=float(s), end=float(e), probability=p)
        for w_, t_, s, e, p in zip(words[:-1], word_tokens[:-1], start_times, end_times,
                                   word_probs)
    ]


def merge_punctuations(alignment: list[WordTiming], prepended: str, appended: str) -> None:
    """Fold leading/trailing punctuation into adjacent words (in place)."""
    i, j = len(alignment) - 2, len(alignment) - 1
    while i >= 0:
        prev, fol = alignment[i], alignment[j]
        if prev.word.startswith(" ") and prev.word.strip() in prepended:
            fol.word = prev.word + fol.word
            fol.tokens = prev.tokens + fol.tokens
            prev.word = ""
            prev.tokens = []
        else:
            j = i
        i -= 1
    i, j = 0, 1
    while j < len(alignment):
        prev, fol = alignment[i], alignment[j]
        if not prev.word.endswith(" ") and fol.word in appended:
            prev.word = prev.word + fol.word
            prev.tokens = prev.tokens + fol.tokens
            fol.word = ""
            fol.tokens = []
        else:
            i = j
        j += 1


def add_word_timestamps(
    segments: list,  # list[Segment] from inference.transcribe
    params: Params,
    config: WhisperConfig,
    tokenizer: WhisperTokenizer,
    mel_window: torch.Tensor | np.ndarray,
    time_offset: float,
    prepend_punctuations: str = "\"'“¿([{-",
    append_punctuations: str = "\"'.。,，!！?？:：”)]}、",
    num_frames: int | None = None,
    alignment_heads: list[tuple[int, int]] | None = None,
) -> None:
    """Attach ``words`` lists to each segment of one window (in place)."""
    if not segments:
        return
    text_tokens_per_segment = [
        [t for t in seg.tokens if t < tokenizer.eot] for seg in segments
    ]
    text_tokens = [t for seg in text_tokens_per_segment for t in seg]
    alignment = find_alignment(
        params, config, tokenizer, text_tokens, mel_window,
        num_frames=num_frames or mel_window.shape[0],
        alignment_heads=alignment_heads,
    )
    word_durations = np.array([w.end - w.start for w in alignment if w.end > w.start])
    median_duration = float(np.median(word_durations)) if len(word_durations) else 0.0
    median_duration = min(0.7, median_duration)
    max_duration = median_duration * 2

    # truncate absurdly long words (a hallucination symptom)
    if len(word_durations) > 0:
        sentence_end_marks = ".。!！?？"
        for i in range(1, len(alignment)):
            if alignment[i].end - alignment[i].start > max_duration:
                if alignment[i].word in sentence_end_marks:
                    alignment[i].end = alignment[i].start + max_duration
                elif alignment[i - 1].word in sentence_end_marks:
                    alignment[i].start = alignment[i].end - max_duration

    merge_punctuations(alignment, prepend_punctuations, append_punctuations)

    word_index = 0
    for segment, seg_tokens in zip(segments, text_tokens_per_segment):
        saved: list[dict] = []
        remaining = len(seg_tokens)
        while word_index < len(alignment) and remaining > 0:
            timing = alignment[word_index]
            if timing.word:
                saved.append({
                    "word": timing.word,
                    "start": round(time_offset + timing.start, 2),
                    "end": round(time_offset + timing.end, 2),
                    "probability": timing.probability,
                })
            remaining -= len(timing.tokens)
            word_index += 1
        segment.words = saved
        # snap segment boundaries to word boundaries
        if saved:
            segment.start = saved[0]["start"]
            segment.end = saved[-1]["end"]

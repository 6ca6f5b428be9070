"""WER computation and basic text normalization (the WER harness).

A copy of ``whisper_mlx_tpu/inference/wer.py`` (which imports only
``re``), kept equal by ``tests/test_torch_audio_serving.py``: word error
rate by Levenshtein alignment and the standard English pre-WER cleanup
(lowercase, punctuation strip, whitespace collapse, common contraction
expansion). It is scored on strings; no dataset comes with it.
"""

from __future__ import annotations

import re

_CONTRACTIONS = {
    "won't": "will not", "can't": "cannot", "n't": " not",
    "'re": " are", "'ve": " have", "'ll": " will", "'m": " am",
    "'d": " would",
}
_PUNCT = re.compile(r"[^\w\s']")
_WS = re.compile(r"\s+")


def normalize_text(text: str) -> str:
    """Basic English normalization (subset of the published Whisper
    normalizer: case/punctuation/contraction/whitespace)."""
    text = text.lower()
    for contraction, expansion in _CONTRACTIONS.items():
        text = text.replace(contraction, expansion)
    text = text.replace("'", "")
    text = _PUNCT.sub(" ", text)
    return _WS.sub(" ", text).strip()


def edit_distance(ref: list[str], hyp: list[str]) -> tuple[int, int, int, int]:
    """→ (substitutions, deletions, insertions, total_edits) via Levenshtein
    with backtrace counts."""
    m, n = len(ref), len(hyp)
    # dp[i][j] = (cost, subs, dels, ins)
    prev = [(j, 0, 0, j) for j in range(n + 1)]
    for i in range(1, m + 1):
        cur = [(i, 0, i, 0)] + [None] * n
        for j in range(1, n + 1):
            if ref[i - 1] == hyp[j - 1]:
                cur[j] = prev[j - 1]
            else:
                sub_c, sub_s, sub_d, sub_i = prev[j - 1]
                del_c, del_s, del_d, del_i = prev[j]
                ins_c, ins_s, ins_d, ins_i = cur[j - 1]
                best = min(sub_c, del_c, ins_c)
                if best == sub_c:
                    cur[j] = (sub_c + 1, sub_s + 1, sub_d, sub_i)
                elif best == del_c:
                    cur[j] = (del_c + 1, del_s, del_d + 1, del_i)
                else:
                    cur[j] = (ins_c + 1, ins_s, ins_d, ins_i + 1)
        prev = cur
    cost, subs, dels, ins = prev[n]
    return subs, dels, ins, cost


def wer(reference: str, hypothesis: str, normalize: bool = True) -> dict:
    """Word error rate + error breakdown."""
    if normalize:
        reference = normalize_text(reference)
        hypothesis = normalize_text(hypothesis)
    ref_words = reference.split()
    hyp_words = hypothesis.split()
    subs, dels, ins, edits = edit_distance(ref_words, hyp_words)
    n = max(len(ref_words), 1)
    return {
        "wer": edits / n,
        "substitutions": subs,
        "deletions": dels,
        "insertions": ins,
        "reference_words": len(ref_words),
    }


def corpus_wer(pairs: list[tuple[str, str]], normalize: bool = True) -> dict:
    """Aggregate WER over (reference, hypothesis) pairs (edit-weighted)."""
    total_edits = 0
    total_words = 0
    per_utterance = []
    for ref, hyp in pairs:
        r = wer(ref, hyp, normalize=normalize)
        total_edits += r["substitutions"] + r["deletions"] + r["insertions"]
        total_words += r["reference_words"]
        per_utterance.append(r["wer"])
    return {
        "wer": total_edits / max(total_words, 1),
        "utterances": len(pairs),
        "total_reference_words": total_words,
    }

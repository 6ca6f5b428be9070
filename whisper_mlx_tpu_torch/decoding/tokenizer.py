"""Whisper tokenizer: byte-level BPE + the special-token layout, host-side.

The reference gets this from the ``mlx_whisper``/tiktoken dependency
(SURVEY.md §2.1 "Tokenizer" row: byte-level GPT-2-style BPE, 100 languages +
task/timestamp specials). Implemented from scratch here:

- GPT-2 byte↔unicode table, merge-rank BPE, and the GPT-2 split regex;
- the multilingual Whisper special layout computed from the language list,
  so both the 99-language (vocab 51865) and the large-v3 100-language
  (vocab 51866, +``yue``) layouts come out right;
- loads real ``vocab.json``/``merges.txt`` (HF format) or a tiktoken
  ``.tiktoken`` rank file when available; fully offline-testable with a
  synthetic vocab otherwise.

Tokenization is host-side in both the reference and this design — only
token ids cross the device boundary.
"""

from __future__ import annotations

import base64
import functools
import json
from dataclasses import dataclass, field
from pathlib import Path

import regex as re

# 99 languages of multilingual Whisper, in official token order; large-v3
# appends Cantonese ("yue") as the 100th.
LANGUAGES = {
    "en": "english", "zh": "chinese", "de": "german", "es": "spanish",
    "ru": "russian", "ko": "korean", "fr": "french", "ja": "japanese",
    "pt": "portuguese", "tr": "turkish", "pl": "polish", "ca": "catalan",
    "nl": "dutch", "ar": "arabic", "sv": "swedish", "it": "italian",
    "id": "indonesian", "hi": "hindi", "fi": "finnish", "vi": "vietnamese",
    "he": "hebrew", "uk": "ukrainian", "el": "greek", "ms": "malay",
    "cs": "czech", "ro": "romanian", "da": "danish", "hu": "hungarian",
    "ta": "tamil", "no": "norwegian", "th": "thai", "ur": "urdu",
    "hr": "croatian", "bg": "bulgarian", "lt": "lithuanian", "la": "latin",
    "mi": "maori", "ml": "malayalam", "cy": "welsh", "sk": "slovak",
    "te": "telugu", "fa": "persian", "lv": "latvian", "bn": "bengali",
    "sr": "serbian", "az": "azerbaijani", "sl": "slovenian", "kn": "kannada",
    "et": "estonian", "mk": "macedonian", "br": "breton", "eu": "basque",
    "is": "icelandic", "hy": "armenian", "ne": "nepali", "mn": "mongolian",
    "bs": "bosnian", "kk": "kazakh", "sq": "albanian", "sw": "swahili",
    "gl": "galician", "mr": "marathi", "pa": "punjabi", "si": "sinhala",
    "km": "khmer", "sn": "shona", "yo": "yoruba", "so": "somali",
    "af": "afrikaans", "oc": "occitan", "ka": "georgian", "be": "belarusian",
    "tg": "tajik", "sd": "sindhi", "gu": "gujarati", "am": "amharic",
    "yi": "yiddish", "lo": "lao", "uz": "uzbek", "fo": "faroese",
    "ht": "haitian creole", "ps": "pashto", "tk": "turkmen", "nn": "nynorsk",
    "mt": "maltese", "sa": "sanskrit", "lb": "luxembourgish", "my": "myanmar",
    "bo": "tibetan", "tl": "tagalog", "mg": "malagasy", "as": "assamese",
    "tt": "tatar", "haw": "hawaiian", "ln": "lingala", "ha": "hausa",
    "ba": "bashkir", "jw": "javanese", "su": "sundanese",
}
LANGUAGES_V3 = {**LANGUAGES, "yue": "cantonese"}

_GPT2_SPLIT = re.compile(
    r"""'s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+| ?[^\s\p{L}\p{N}]+|\s+(?!\S)|\s+"""
)


@functools.lru_cache(maxsize=1)
def bytes_to_unicode() -> dict[int, str]:
    """GPT-2's reversible byte→printable-unicode table."""
    bs = list(range(ord("!"), ord("~") + 1)) + list(range(ord("¡"), ord("¬") + 1)) + list(range(ord("®"), ord("ÿ") + 1))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, (chr(c) for c in cs)))


class ByteLevelBPE:
    """GPT-2-style byte-level BPE over a vocab + merge-rank table."""

    def __init__(self, vocab: dict[str, int], merges: list[tuple[str, str]]):
        self.encoder = dict(vocab)
        self.decoder = {v: k for k, v in vocab.items()}
        self.ranks = {m: i for i, m in enumerate(merges)}
        self.byte_enc = bytes_to_unicode()
        self.byte_dec = {v: k for k, v in self.byte_enc.items()}
        self._bpe_cache: dict[str, list[str]] = {}

    def _bpe(self, token: str) -> list[str]:
        cached = self._bpe_cache.get(token)
        if cached is not None:
            return cached
        word = list(token)
        while len(word) > 1:
            pairs = {(word[i], word[i + 1]) for i in range(len(word) - 1)}
            best = min(pairs, key=lambda p: self.ranks.get(p, float("inf")))
            if best not in self.ranks:
                break
            first, second = best
            merged: list[str] = []
            i = 0
            while i < len(word):
                if i < len(word) - 1 and word[i] == first and word[i + 1] == second:
                    merged.append(first + second)
                    i += 2
                else:
                    merged.append(word[i])
                    i += 1
            word = merged
        self._bpe_cache[token] = word
        return word

    def encode(self, text: str) -> list[int]:
        ids: list[int] = []
        for chunk in _GPT2_SPLIT.findall(text):
            mapped = "".join(self.byte_enc[b] for b in chunk.encode("utf-8"))
            for piece in self._bpe(mapped):
                ids.append(self.encoder[piece])
        return ids

    def decode(self, ids: list[int]) -> str:
        text = "".join(self.decoder[i] for i in ids if i in self.decoder)
        return bytes(self.byte_dec[c] for c in text).decode("utf-8", errors="replace")


@dataclass
class WhisperTokenizer:
    """BPE + Whisper special tokens; all special ids derived from layout.

    Layout (multilingual): ``eot`` = n_base, then sot, one token per
    language, translate, transcribe, startoflm, startofprev, nospeech,
    notimestamps, then 1501 timestamp tokens <|0.00|>..<|30.00|>.
    """

    bpe: ByteLevelBPE
    n_base: int = 50257  # text-vocab size before specials
    num_languages: int = 99  # 0 = English-only (.en) layout
    language: str = "en"
    task: str = "transcribe"

    eot: int = field(init=False)
    sot: int = field(init=False)
    translate: int = field(init=False)
    transcribe: int = field(init=False)
    sot_lm: int = field(init=False)
    sot_prev: int = field(init=False)
    no_speech: int = field(init=False)
    no_timestamps: int = field(init=False)
    timestamp_begin: int = field(init=False)

    def __post_init__(self):
        self.eot = self.n_base
        self.sot = self.n_base + 1
        lang_base = self.sot + 1
        self._lang_codes = list(LANGUAGES_V3 if self.num_languages == 100 else LANGUAGES)[: self.num_languages]
        self._lang_token = {code: lang_base + i for i, code in enumerate(self._lang_codes)}
        self.translate = lang_base + self.num_languages
        self.transcribe = self.translate + 1
        self.sot_lm = self.transcribe + 1
        self.sot_prev = self.sot_lm + 1
        self.no_speech = self.sot_prev + 1
        self.no_timestamps = self.no_speech + 1
        self.timestamp_begin = self.no_timestamps + 1

    # -- special-token helpers ------------------------------------------------

    @property
    def n_vocab(self) -> int:
        return self.timestamp_begin + 1501  # timestamps 0.00..30.00 at 0.02 s

    @property
    def multilingual(self) -> bool:
        return self.num_languages > 0

    @property
    def sot_sequence(self) -> tuple[int, ...]:
        if not self.multilingual:  # .en models: bare sot
            return (self.sot,)
        return (self.sot, self.language_token(self.language),
                self.transcribe if self.task == "transcribe" else self.translate)

    @property
    def sot_sequence_including_notimestamps(self) -> tuple[int, ...]:
        return self.sot_sequence + (self.no_timestamps,)

    def language_token(self, code: str) -> int:
        try:
            return self._lang_token[code]
        except KeyError:
            raise ValueError(f"unknown language: {code!r}") from None

    @property
    def all_language_tokens(self) -> tuple[int, ...]:
        return tuple(self._lang_token.values())

    @property
    def all_language_codes(self) -> tuple[str, ...]:
        return tuple(self._lang_codes)

    def timestamp_to_seconds(self, token: int) -> float:
        return (token - self.timestamp_begin) * 0.02

    # -- text -----------------------------------------------------------------

    def encode(self, text: str) -> list[int]:
        return self.bpe.encode(text)

    def decode(self, ids: list[int]) -> str:
        return self.bpe.decode([i for i in ids if i < self.eot])

    def decode_with_timestamps(self, ids: list[int]) -> str:
        parts: list[str] = []
        chunk: list[int] = []
        for i in ids:
            if i >= self.timestamp_begin:
                if chunk:
                    parts.append(self.decode(chunk))
                    chunk = []
                parts.append(f"<|{self.timestamp_to_seconds(i):.2f}|>")
            else:
                chunk.append(i)
        if chunk:
            parts.append(self.decode(chunk))
        return "".join(parts)

    def split_to_word_tokens(self, tokens: list[int]) -> tuple[list[str], list[list[int]]]:
        """Group text tokens into words for word-level timestamps.

        Languages without spaces (zh/ja/th/lo/my/yue) split per decoded
        character-ish unit; others split on leading space / punctuation
        boundaries of the decoded pieces.
        """
        if self.language in {"zh", "ja", "th", "lo", "my", "yue"}:
            return self._split_tokens_on_unicode(tokens)
        return self._split_tokens_on_spaces(tokens)

    def _split_tokens_on_unicode(self, tokens: list[int]):
        replacement = "�"
        decoded_full = self.decode_with_timestamps(tokens)
        words, word_tokens = [], []
        current: list[int] = []
        unicode_offset = 0
        for tok in tokens:
            current.append(tok)
            decoded = self.decode_with_timestamps(current)
            if replacement not in decoded or decoded_full[unicode_offset + decoded.index(replacement)] == replacement:
                words.append(decoded)
                word_tokens.append(current)
                current = []
                unicode_offset += len(decoded)
        return words, word_tokens

    def _split_tokens_on_spaces(self, tokens: list[int]):
        subwords, subword_tokens = self._split_tokens_on_unicode(tokens)
        words: list[str] = []
        word_tokens: list[list[int]] = []
        for sw, st in zip(subwords, subword_tokens):
            special = st[0] >= self.eot
            with_space = sw.startswith(" ")
            punctuation = sw.strip() in "!\"#$%&'()*+,-./:;<=>?@[\\]^_`{|}~"
            if special or with_space or punctuation or not words:
                words.append(sw)
                word_tokens.append(list(st))
            else:
                words[-1] += sw
                word_tokens[-1].extend(st)
        return words, word_tokens

    @functools.cached_property
    def non_speech_tokens(self) -> tuple[int, ...]:
        """Token ids suppressed by default (music/symbol annotations etc.).

        Mirrors the published suppress list: symbols and annotation markers
        that tend to hallucinate, plus speaker-dash variants where the vocab
        has them, always including the space-prefixed variants.
        """
        symbols = list('"#()*+/:;<=>@[\\]^_`{|}~「」『』') + (
            "<< >> <<< >>> -- --- -( -[ (' (\" (( )) ((( ))) [[ ]] {{ }} ♪♪ ♪♪♪".split()
        )
        miscellaneous = set("♩♪♫♬♭♮♯")
        result = set()
        for symbol in symbols + list(miscellaneous):
            for tok_str in (symbol, " " + symbol):
                try:
                    ids = self.bpe.encode(tok_str)
                except KeyError:
                    continue
                if len(ids) == 1:
                    result.add(ids[0])
                elif symbol in miscellaneous and ids:
                    result.add(ids[0])
        # dash/quote speaker markers: FIRST token added unconditionally
        # (published whisper semantics, unlike the len==1 rule above)
        for tok_str in (" -", " '"):
            try:
                ids = self.bpe.encode(tok_str)
                if ids:
                    result.add(ids[0])
            except KeyError:
                pass
        return tuple(sorted(result))


# ---------------------------------------------------------------------------
# loading
# ---------------------------------------------------------------------------


def load_tokenizer(
    path: str | Path,
    language: str = "en",
    task: str = "transcribe",
    num_languages: int | None = None,
) -> WhisperTokenizer:
    """Load from an HF model dir (vocab.json + merges.txt) or a tiktoken
    ``*.tiktoken`` base64 rank file."""
    path = Path(path)
    if path.is_dir():
        tiktoken_files = sorted(path.glob("*.tiktoken"))
        if (path / "vocab.json").exists():
            vocab = json.loads((path / "vocab.json").read_text())
            merges = [
                tuple(line.split())
                for line in (path / "merges.txt").read_text().splitlines()
                if line and not line.startswith("#version")
            ]
            bpe = ByteLevelBPE(vocab, merges)  # type: ignore[arg-type]
            n_base = len(vocab)
        elif tiktoken_files:
            return load_tokenizer(tiktoken_files[0], language, task, num_languages)
        else:
            raise FileNotFoundError(f"no tokenizer files under {path}")
    else:
        # tiktoken format: "<base64-token> <rank>" lines; merges implied by rank
        vocab = {}
        for line in Path(path).read_text().splitlines():
            if not line:
                continue
            b64, rank = line.split()
            token = "".join(bytes_to_unicode()[b] for b in base64.b64decode(b64))
            vocab[token] = int(rank)
        merges = _merges_from_ranks(vocab)
        bpe = ByteLevelBPE(vocab, merges)
        n_base = len(vocab)
    if num_languages is None:
        num_languages = 99
    return WhisperTokenizer(bpe, n_base=n_base, num_languages=num_languages,
                            language=language, task=task)


def _merges_from_ranks(vocab: dict[str, int]) -> list[tuple[str, str]]:
    """Reconstruct merge list from a rank-ordered vocab (tiktoken style)."""
    by_rank = sorted(vocab.items(), key=lambda kv: kv[1])
    merges = []
    for token, _rank in by_rank:
        if len(token) < 2:
            continue
        best = None
        for i in range(1, len(token)):
            left, right = token[:i], token[i:]
            if left in vocab and right in vocab:
                r = max(vocab[left], vocab[right])
                if best is None or r < best[0]:
                    best = (r, left, right)
        if best:
            merges.append((best[1], best[2]))
    return merges


def make_synthetic_tokenizer(language: str = "en", task: str = "transcribe") -> WhisperTokenizer:
    """Tiny offline tokenizer for tests: byte-level vocab (no merges) +
    the full Whisper special layout at n_base=256."""
    byte_vocab = {c: i for i, c in enumerate(bytes_to_unicode().values())}
    bpe = ByteLevelBPE(byte_vocab, merges=[])
    return WhisperTokenizer(bpe, n_base=256, num_languages=99, language=language, task=task)

"""Output writer family: txt / json / srt / vtt / tsv (+ "all").

The reference CLI writes transcripts via ``mlx_whisper ... -f txt``
(reference ``run:3``; SURVEY.md §2.1 "Output writers" row). The ``txt``
format is the one exercised by the reference launcher contract
(``./run input.mp3 output`` → ``output.txt``).
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Callable, TextIO


def _format_timestamp(seconds: float, always_include_hours: bool = False, decimal_marker: str = ".") -> str:
    assert seconds >= 0
    ms = round(seconds * 1000.0)
    hours, ms = divmod(ms, 3_600_000)
    minutes, ms = divmod(ms, 60_000)
    secs, ms = divmod(ms, 1_000)
    hours_marker = f"{hours:02d}:" if always_include_hours or hours > 0 else ""
    return f"{hours_marker}{minutes:02d}:{secs:02d}{decimal_marker}{ms:03d}"


def write_txt(result: dict[str, Any], file: TextIO) -> None:
    for segment in result["segments"]:
        print(segment["text"].strip(), file=file, flush=True)


def write_json(result: dict[str, Any], file: TextIO) -> None:
    json.dump(result, file)


def write_srt(result: dict[str, Any], file: TextIO) -> None:
    for i, segment in enumerate(result["segments"], start=1):
        print(
            f"{i}\n"
            f"{_format_timestamp(segment['start'], True, ',')} --> "
            f"{_format_timestamp(segment['end'], True, ',')}\n"
            f"{segment['text'].strip().replace('-->', '->')}\n",
            file=file, flush=True,
        )


def write_vtt(result: dict[str, Any], file: TextIO) -> None:
    print("WEBVTT\n", file=file)
    for segment in result["segments"]:
        print(
            f"{_format_timestamp(segment['start'])} --> {_format_timestamp(segment['end'])}\n"
            f"{segment['text'].strip().replace('-->', '->')}\n",
            file=file, flush=True,
        )


def write_tsv(result: dict[str, Any], file: TextIO) -> None:
    print("start", "end", "text", sep="\t", file=file)
    for segment in result["segments"]:
        print(round(1000 * segment["start"]), round(1000 * segment["end"]),
              segment["text"].strip().replace("\t", " "), sep="\t", file=file, flush=True)


WRITERS: dict[str, Callable[[dict[str, Any], TextIO], None]] = {
    "txt": write_txt,
    "json": write_json,
    "srt": write_srt,
    "vtt": write_vtt,
    "tsv": write_tsv,
}


def get_writer(output_format: str, output_dir: str | Path) -> Callable[[dict[str, Any], str], None]:
    """→ writer(result, output_name) that writes ``output_dir/name.fmt``.

    ``output_format="all"`` writes every format (reference CLI surface).
    """
    output_dir = Path(output_dir)
    output_dir.mkdir(parents=True, exist_ok=True)
    formats = list(WRITERS) if output_format == "all" else [output_format]
    for fmt in formats:
        if fmt not in WRITERS:
            raise ValueError(f"unknown output format {fmt!r}; choose from {list(WRITERS)} or 'all'")

    def writer(result: dict[str, Any], output_name: str) -> None:
        for fmt in formats:
            path = output_dir / f"{output_name}.{fmt}"
            with open(path, "w", encoding="utf-8") as f:
                WRITERS[fmt](result, f)

    return writer

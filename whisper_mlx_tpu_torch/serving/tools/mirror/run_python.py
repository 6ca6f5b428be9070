"""Sandboxed Python execution tool
(reference ``daemon/tools/mirror/run_python.py:88-175``).

Same isolation model as the reference: fork a subprocess, run the snippet
with a hard timeout, capture stdout/stderr, force matplotlib's Agg backend,
scan the per-session assets dir for images produced by the snippet and
inline them as base64 data URIs.
"""

from __future__ import annotations

import base64
import json
import subprocess
import sys
import tempfile
from pathlib import Path

from whisper_mlx_tpu_torch.serving.tools.base import tool
from whisper_mlx_tpu_torch.serving.tools.mirror.data_store import get_session_assets_dir

MAX_OUTPUT_CHARS = 20_000
_IMAGE_EXTS = (".png", ".jpg", ".jpeg", ".gif", ".svg")

_PRELUDE = """\
import os
os.environ.setdefault("MPLBACKEND", "Agg")
os.chdir({assets_dir!r})
"""


@tool(
    name="run_python",
    description=(
        "Execute a Python snippet in an isolated subprocess with a timeout. "
        "stdout/stderr are returned; matplotlib is available (Agg backend) "
        "and any image files the snippet saves into its working directory "
        "are returned as base64 data URIs."
    ),
    parameters={
        "code": {"type": "string", "description": "Python source to execute"},
        "timeout_seconds": {
            "type": "integer",
            "description": "wall-clock limit (default 30, max 120)",
        },
    },
    required=["code"],
)
def run_python(code: str, timeout_seconds: int = 30) -> str:
    timeout_seconds = max(1, min(int(timeout_seconds or 30), 120))
    assets_dir = get_session_assets_dir()
    before = {p.name for p in assets_dir.iterdir()} if assets_dir.exists() else set()

    with tempfile.NamedTemporaryFile("w", suffix=".py", delete=False) as f:
        f.write(_PRELUDE.format(assets_dir=str(assets_dir)))
        f.write(code)
        script = f.name
    try:
        proc = subprocess.run(
            [sys.executable, script],
            capture_output=True,
            text=True,
            timeout=timeout_seconds,
        )
        timed_out = False
        stdout, stderr, rc = proc.stdout, proc.stderr, proc.returncode
    except subprocess.TimeoutExpired as exc:
        timed_out = True
        stdout = (exc.stdout or b"").decode() if isinstance(exc.stdout, bytes) else (exc.stdout or "")
        stderr = (exc.stderr or b"").decode() if isinstance(exc.stderr, bytes) else (exc.stderr or "")
        rc = -1
    finally:
        Path(script).unlink(missing_ok=True)

    images = []
    if assets_dir.exists():
        for p in sorted(assets_dir.iterdir()):
            if p.name not in before and p.suffix.lower() in _IMAGE_EXTS:
                try:
                    data = p.read_bytes()
                    if len(data) <= 2_000_000:
                        mime = "image/svg+xml" if p.suffix == ".svg" else f"image/{p.suffix.lstrip('.').replace('jpg', 'jpeg')}"
                        images.append({
                            "filename": p.name,
                            "data_uri": f"data:{mime};base64,{base64.b64encode(data).decode()}",
                        })
                except OSError:
                    continue

    return json.dumps({
        "stdout": stdout[:MAX_OUTPUT_CHARS],
        "stderr": stderr[:MAX_OUTPUT_CHARS],
        "returncode": rc,
        "timed_out": timed_out,
        "images": images,
    })


TOOL = run_python

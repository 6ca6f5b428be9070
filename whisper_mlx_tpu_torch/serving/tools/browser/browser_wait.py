"""Timed wait, capped at 300 s (reference ``browser_wait.py``)."""
import asyncio
import json
from whisper_mlx_tpu_torch.serving.tools.base import tool

@tool(
    name="browser_wait",
    description="Wait for N seconds (max 300) — e.g. for a page to finish running code.",
    parameters={"seconds": {"type": "number"}},
    required=["seconds"],
)
async def browser_wait(seconds: float) -> str:
    seconds = max(0.0, min(float(seconds), 300.0))
    await asyncio.sleep(seconds)
    return json.dumps({"waited_seconds": seconds})

TOOL = browser_wait

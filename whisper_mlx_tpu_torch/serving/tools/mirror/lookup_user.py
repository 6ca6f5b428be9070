"""User lookup across mirrors (reference ``lookup_user.py``)."""

from __future__ import annotations

import json

from whisper_mlx_tpu_torch.serving.tools.base import tool
from whisper_mlx_tpu_torch.serving.tools.mirror.data_store import get_data_store


@tool(
    name="lookup_user",
    description="Resolve a person by name/handle/email across the Slack mirror's user table.",
    parameters={
        "query": {"type": "string", "description": "name, handle, email or user id"},
    },
    required=["query"],
)
def lookup_user(query: str) -> str:
    matches = get_data_store().resolve_user(query)
    if not matches:
        return json.dumps({"error": f"no user matching {query!r}"})
    return json.dumps({
        "users": [
            {
                "id": d.get("id"),
                "name": d.get("name"),
                "real_name": d.get("real_name"),
                "display_name": (d.get("profile") or {}).get("display_name"),
                "email": (d.get("profile") or {}).get("email"),
            }
            for d in matches[:10]
        ],
    })


TOOL = lookup_user

"""Full email fetch (reference ``get_email.py``)."""

from __future__ import annotations

import json

from whisper_mlx_tpu_torch.serving.tools.base import tool
from whisper_mlx_tpu_torch.serving.sync import storage


@tool(
    name="get_email",
    description="Fetch one synced email by id (full body + attachment list).",
    parameters={
        "id": {"type": "string", "description": "message id"},
        "account": {"type": "string", "description": "account shortname (optional)"},
    },
    required=["id"],
)
def get_email(id: str, account: str = "") -> str:
    accounts = storage.resolve_account(account or None)
    for acct in accounts:
        e = storage.load_email(acct, id)
        if e is not None:
            return json.dumps({
                "id": e.get("id"),
                "account": acct,
                "date": e.get("date"),
                "from": e.get("from"),
                "to": e.get("to"),
                "cc": e.get("cc"),
                "subject": e.get("subject"),
                "body": (e.get("body") or "")[:20_000],
                "attachments": e.get("attachments", []),
            })
    return json.dumps({"error": f"email not found: {id}"})


TOOL = get_email

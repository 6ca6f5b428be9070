"""Sync storage: filesystem layout for mirrored Gmail/Calendar data
(reference ``daemon/sync/storage.py``).

Layout (reference :1-14):
    ~/.qwen/data/{account}/gmail/emails/*.json
    ~/.qwen/data/{account}/gmail/attachments/{msg_id}/{filename}
    ~/.qwen/data/{account}/gmail/sync_state.json
    ~/.qwen/data/{account}/calendar/events/*.json
    ~/.qwen/data/{account}/calendar/sync_state.json

Account resolution maps an email address to its short account name by
scanning stored data (reference :53-116); filenames are sanitized
(reference :195-286); cross-account loaders at :302-361; stats :364-388.
"""

from __future__ import annotations

import json
import os
import re
import time
from pathlib import Path
from typing import Any

DATA_DIR = Path(os.environ.get("QWEN_DATA_DIR", os.path.expanduser("~/.qwen/data")))

_FILENAME_SAFE = re.compile(r"[^A-Za-z0-9._-]+")


def sanitize_filename(name: str, max_len: int = 120) -> str:
    cleaned = _FILENAME_SAFE.sub("_", name).strip("._") or "unnamed"
    return cleaned[:max_len]


def _account_dir(account: str, service: str) -> Path:
    return DATA_DIR / account / service


def list_accounts() -> list[str]:
    if not DATA_DIR.exists():
        return []
    return sorted(p.name for p in DATA_DIR.iterdir() if p.is_dir())


def resolve_account(query: str | None) -> list[str]:
    """email-or-shortname → matching account names (reference :53-116)."""
    accounts = list_accounts()
    if not query:
        return accounts
    q = query.lower()
    exact = [a for a in accounts if a.lower() == q]
    if exact:
        return exact
    # scan stored emails' to/from for the address
    matches = []
    for account in accounts:
        for email in load_emails(account)[:50]:
            if q in (email.get("to", "") + email.get("from", "")).lower():
                matches.append(account)
                break
    return matches or [a for a in accounts if q in a.lower()]


# -- email ------------------------------------------------------------------


def save_email(account: str, email: dict[str, Any]) -> Path:
    d = _account_dir(account, "gmail") / "emails"
    d.mkdir(parents=True, exist_ok=True)
    path = d / f"{sanitize_filename(email['id'])}.json"
    path.write_text(json.dumps(email))
    return path


def load_email(account: str, msg_id: str) -> dict[str, Any] | None:
    path = _account_dir(account, "gmail") / "emails" / f"{sanitize_filename(msg_id)}.json"
    if not path.exists():
        return None
    return json.loads(path.read_text())


def load_emails(account: str) -> list[dict[str, Any]]:
    d = _account_dir(account, "gmail") / "emails"
    if not d.exists():
        return []
    out = []
    for p in sorted(d.glob("*.json")):
        try:
            out.append(json.loads(p.read_text()))
        except (json.JSONDecodeError, OSError):
            continue
    return out


def load_all_emails() -> list[dict[str, Any]]:
    """Cross-account (reference :302-331); each email gains ``account``."""
    out = []
    for account in list_accounts():
        for email in load_emails(account):
            email = dict(email, account=account)
            out.append(email)
    return out


def existing_email_ids(account: str) -> set[str]:
    d = _account_dir(account, "gmail") / "emails"
    if not d.exists():
        return set()
    return {p.stem for p in d.glob("*.json")}


def save_attachment(account: str, msg_id: str, filename: str, data: bytes) -> Path:
    d = _account_dir(account, "gmail") / "attachments" / sanitize_filename(msg_id)
    d.mkdir(parents=True, exist_ok=True)
    path = d / sanitize_filename(filename)
    path.write_bytes(data)
    return path


# -- calendar ---------------------------------------------------------------


def save_event(account: str, event: dict[str, Any]) -> Path:
    d = _account_dir(account, "calendar") / "events"
    d.mkdir(parents=True, exist_ok=True)
    path = d / f"{sanitize_filename(event['id'])}.json"
    path.write_text(json.dumps(event))
    return path


def load_event(account: str, event_id: str) -> dict[str, Any] | None:
    path = _account_dir(account, "calendar") / "events" / f"{sanitize_filename(event_id)}.json"
    if not path.exists():
        return None
    return json.loads(path.read_text())


def load_events(account: str) -> list[dict[str, Any]]:
    d = _account_dir(account, "calendar") / "events"
    if not d.exists():
        return []
    out = []
    for p in sorted(d.glob("*.json")):
        try:
            out.append(json.loads(p.read_text()))
        except (json.JSONDecodeError, OSError):
            continue
    return out


def load_all_events() -> list[dict[str, Any]]:
    out = []
    for account in list_accounts():
        for event in load_events(account):
            out.append(dict(event, account=account))
    return out


# -- sync state (reference :176-191) ----------------------------------------


def load_sync_state(account: str, service: str) -> dict[str, Any]:
    path = _account_dir(account, service) / "sync_state.json"
    if not path.exists():
        return {}
    try:
        return json.loads(path.read_text())
    except json.JSONDecodeError:
        return {}


def save_sync_state(account: str, service: str, state: dict[str, Any]) -> None:
    d = _account_dir(account, service)
    d.mkdir(parents=True, exist_ok=True)
    state = dict(state, last_sync=time.time())
    (d / "sync_state.json").write_text(json.dumps(state))


def get_storage_stats() -> dict[str, Any]:
    """Per-account email/event counts (reference :364-388)."""
    stats = {}
    for account in list_accounts():
        stats[account] = {
            "emails": len(list((_account_dir(account, "gmail") / "emails").glob("*.json")))
            if (_account_dir(account, "gmail") / "emails").exists() else 0,
            "events": len(list((_account_dir(account, "calendar") / "events").glob("*.json")))
            if (_account_dir(account, "calendar") / "events").exists() else 0,
        }
    return stats

"""Email search over synced storage (reference ``search_emails.py``):
criteria filters from/to/subject/query/dates/attachments/account."""

from __future__ import annotations

import json

from whisper_mlx_tpu_torch.serving.tools.base import tool
from whisper_mlx_tpu_torch.serving.sync import storage


def _email_matches(
    e: dict, query: str, from_: str, to: str, subject: str,
    after: str, before: str, has_attachment: bool | None,
) -> bool:
    if from_ and from_.lower() not in e.get("from", "").lower():
        return False
    if to and to.lower() not in e.get("to", "").lower():
        return False
    if subject and subject.lower() not in e.get("subject", "").lower():
        return False
    if query:
        hay = " ".join(
            str(e.get(k, "")) for k in ("subject", "from", "to", "snippet", "body")
        ).lower()
        if query.lower() not in hay:
            return False
    date = e.get("date", "")
    if after and date and date[:10] < after[:10]:
        return False
    if before and date and date[:10] >= before[:10]:
        return False
    if has_attachment is not None and bool(e.get("attachments")) != has_attachment:
        return False
    return True


@tool(
    name="search_emails",
    description=(
        "Search synced emails with criteria: free-text query, from/to/"
        "subject substrings, date range (after/before, ISO dates), "
        "attachment presence and account."
    ),
    parameters={
        "query": {"type": "string", "description": "free text over subject/body"},
        "from": {"type": "string", "description": "sender substring"},
        "to": {"type": "string", "description": "recipient substring"},
        "subject": {"type": "string", "description": "subject substring"},
        "after": {"type": "string", "description": "ISO date lower bound"},
        "before": {"type": "string", "description": "ISO date upper bound (exclusive)"},
        "has_attachment": {"type": "boolean"},
        "account": {"type": "string", "description": "account shortname or address"},
        "limit": {"type": "integer", "description": "max results (default 10, max 50)"},
    },
)
def search_emails(
    query: str = "", subject: str = "", after: str = "", before: str = "",
    has_attachment: bool | None = None, account: str = "", limit: int = 10,
    **kw,
) -> str:
    from_ = kw.get("from", kw.get("from_", ""))
    to = kw.get("to", "")
    limit = max(1, min(int(limit or 10), 50))
    accounts = storage.resolve_account(account or None)
    emails = []
    for acct in accounts:
        for e in storage.load_emails(acct):
            if _email_matches(e, query, from_, to, subject, after, before, has_attachment):
                emails.append(dict(e, account=acct))
    emails.sort(key=lambda e: e.get("date", ""), reverse=True)
    return json.dumps({
        "total": len(emails),
        "emails": [
            {
                "id": e.get("id"),
                "account": e.get("account"),
                "date": e.get("date"),
                "from": e.get("from"),
                "to": e.get("to"),
                "subject": e.get("subject"),
                "snippet": (e.get("snippet") or e.get("body", ""))[:200],
                "has_attachments": bool(e.get("attachments")),
            }
            for e in emails[:limit]
        ],
    })


TOOL = search_emails

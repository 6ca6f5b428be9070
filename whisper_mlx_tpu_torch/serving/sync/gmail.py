"""Gmail sync (reference ``daemon/sync/gmail.py``).

Paged message listing with an ``after:<date>`` lookback query (reference
:229-259), already-synced-ID skip for idempotent resync (reference
:269-271), full fetch with header parsing + multipart body decode
(reference :63-112) and attachment download (reference :114-164).
"""

from __future__ import annotations

import base64
import logging
from datetime import datetime, timedelta
from typing import Any

from whisper_mlx_tpu_torch.serving.sync import storage
from whisper_mlx_tpu_torch.serving.sync.auth import AuthUnavailable, get_credentials

logger = logging.getLogger("qwen.sync.gmail")

PAGE_SIZE = 100  # reference :248-259


def _header(payload: dict, name: str) -> str:
    for h in payload.get("headers", []):
        if h.get("name", "").lower() == name.lower():
            return h.get("value", "")
    return ""


def _decode_body(part: dict) -> str:
    data = (part.get("body") or {}).get("data")
    if not data:
        return ""
    try:
        return base64.urlsafe_b64decode(data + "===").decode("utf-8", errors="replace")
    except Exception:
        return ""


def _extract_body(payload: dict) -> str:
    """Prefer text/plain, fall back to text/html, walk multiparts
    (reference :63-112)."""
    if payload.get("mimeType", "").startswith("text/plain"):
        return _decode_body(payload)
    best_html = ""
    for part in payload.get("parts", []) or []:
        mime = part.get("mimeType", "")
        if mime.startswith("text/plain"):
            text = _decode_body(part)
            if text:
                return text
        elif mime.startswith("text/html"):
            best_html = best_html or _decode_body(part)
        elif mime.startswith("multipart/"):
            nested = _extract_body(part)
            if nested:
                return nested
    return best_html or _decode_body(payload)


def _extract_attachments(payload: dict) -> list[dict[str, Any]]:
    out = []
    for part in payload.get("parts", []) or []:
        filename = part.get("filename")
        body = part.get("body") or {}
        if filename and body.get("attachmentId"):
            out.append({
                "filename": filename,
                "attachment_id": body["attachmentId"],
                "size": body.get("size", 0),
                "mime_type": part.get("mimeType"),
            })
        out.extend(_extract_attachments(part))
    return out


def normalize_message(msg: dict[str, Any]) -> dict[str, Any]:
    payload = msg.get("payload", {})
    return {
        "id": msg["id"],
        "thread_id": msg.get("threadId"),
        "date": _header(payload, "Date"),
        "from": _header(payload, "From"),
        "to": _header(payload, "To"),
        "cc": _header(payload, "Cc"),
        "subject": _header(payload, "Subject"),
        "snippet": msg.get("snippet", ""),
        "body": _extract_body(payload),
        "attachments": _extract_attachments(payload),
        "labels": msg.get("labelIds", []),
    }


class GmailSyncer:
    def __init__(self, account: str, lookback_days: int = 365,
                 download_attachments: bool = True):
        self.account = account
        self.lookback_days = lookback_days
        self.download_attachments = download_attachments

    def _service(self):
        try:
            from googleapiclient.discovery import build
        except ImportError as exc:
            raise AuthUnavailable(f"googleapiclient not installed: {exc}") from exc
        return build("gmail", "v1", credentials=get_credentials(self.account),
                     cache_discovery=False)

    def sync(self) -> dict[str, Any]:
        """→ stats dict (reference :235-241)."""
        service = self._service()
        after = (datetime.now() - timedelta(days=self.lookback_days)).strftime("%Y/%m/%d")
        query = f"after:{after}"
        existing = storage.existing_email_ids(self.account)

        fetched = skipped = attachments = 0
        page_token = None
        while True:
            resp = service.users().messages().list(
                userId="me", q=query, maxResults=PAGE_SIZE, pageToken=page_token
            ).execute()
            for ref in resp.get("messages", []):
                if storage.sanitize_filename(ref["id"]) in existing:
                    skipped += 1
                    continue
                msg = service.users().messages().get(
                    userId="me", id=ref["id"], format="full"
                ).execute()
                email = normalize_message(msg)
                storage.save_email(self.account, email)
                fetched += 1
                if self.download_attachments:
                    for att in email["attachments"]:
                        try:
                            data = service.users().messages().attachments().get(
                                userId="me", messageId=email["id"],
                                id=att["attachment_id"],
                            ).execute()
                            raw = base64.urlsafe_b64decode(data["data"] + "===")
                            storage.save_attachment(
                                self.account, email["id"], att["filename"], raw
                            )
                            attachments += 1
                        except Exception as exc:
                            logger.warning("attachment fetch failed: %s", exc)
            page_token = resp.get("nextPageToken")
            if not page_token:
                break

        stats = {"fetched": fetched, "skipped": skipped, "attachments": attachments}
        storage.save_sync_state(self.account, "gmail", {"stats": stats})
        logger.info("gmail sync %s: %s", self.account, stats)
        return stats


def sync_gmail(account: str, lookback_days: int = 365) -> dict[str, Any]:
    return GmailSyncer(account, lookback_days).sync()

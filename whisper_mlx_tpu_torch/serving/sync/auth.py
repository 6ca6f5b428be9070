"""Google OAuth per-account credential management
(reference ``daemon/sync/auth.py``).

Readonly gmail+calendar scopes (reference :30-33), client secrets from a
``passveil`` subprocess or ``~/.qwen/client_secrets.json`` (reference
:68-130), per-account credentials at ``~/.qwen/accounts/{name}/
credentials.json`` chmod 0600 (reference :243-249), auto-refresh with
diagnostics (reference :165-240), a local-server OAuth flow (reference
:252-297) and a CLI (reference :300-363).

The Google client libraries are optional in this image; everything raises a
clear ``AuthUnavailable`` instead of ImportError so callers can gate.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

SCOPES = [
    "https://www.googleapis.com/auth/gmail.readonly",
    "https://www.googleapis.com/auth/calendar.readonly",
]

QWEN_HOME = Path(os.environ.get("QWEN_HOME", os.path.expanduser("~/.qwen")))
ACCOUNTS_DIR = QWEN_HOME / "accounts"
CLIENT_SECRETS_PATH = QWEN_HOME / "client_secrets.json"


class AuthUnavailable(RuntimeError):
    """Google auth libraries or credentials are not available."""


def _require_google():
    try:
        from google.oauth2.credentials import Credentials  # noqa: F401

        return True
    except ImportError as exc:
        raise AuthUnavailable(f"google-auth not installed: {exc}") from exc


def load_client_secrets() -> dict:
    """passveil subprocess first, file fallback (reference :68-130)."""
    try:
        out = subprocess.run(
            ["passveil", "show", "google/oauth-client"],
            capture_output=True, text=True, timeout=10,
        )
        if out.returncode == 0 and out.stdout.strip():
            return json.loads(out.stdout)
    except (FileNotFoundError, subprocess.TimeoutExpired, json.JSONDecodeError):
        pass
    if CLIENT_SECRETS_PATH.exists():
        return json.loads(CLIENT_SECRETS_PATH.read_text())
    raise AuthUnavailable(
        f"no client secrets: passveil unavailable and {CLIENT_SECRETS_PATH} missing"
    )


def credentials_path(account: str) -> Path:
    return ACCOUNTS_DIR / account / "credentials.json"


def list_accounts() -> list[str]:
    if not ACCOUNTS_DIR.exists():
        return []
    return sorted(
        p.name for p in ACCOUNTS_DIR.iterdir()
        if (p / "credentials.json").exists()
    )


def get_credentials(account: str):
    """Load + auto-refresh an account's credentials (reference :165-240)."""
    _require_google()
    from google.auth.transport.requests import Request
    from google.oauth2.credentials import Credentials

    path = credentials_path(account)
    if not path.exists():
        raise AuthUnavailable(
            f"no credentials for account {account!r}; run "
            f"`python -m whisper_mlx_tpu_torch.serving.sync.auth --account {account}`"
        )
    creds = Credentials.from_authorized_user_file(str(path), SCOPES)
    if creds.expired and creds.refresh_token:
        try:
            creds.refresh(Request())
        except Exception as exc:
            raise AuthUnavailable(
                f"token refresh failed for {account!r}: {type(exc).__name__}: {exc}. "
                "The refresh token may be revoked — re-run the OAuth flow."
            ) from exc
        save_credentials(account, creds)
    if not creds.valid:
        raise AuthUnavailable(f"credentials for {account!r} are invalid")
    return creds


def save_credentials(account: str, creds) -> Path:
    path = credentials_path(account)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(creds.to_json())
    os.chmod(path, 0o600)  # reference :243-249
    return path


def run_oauth_flow(account: str, port: int = 8080):
    """Local-server consent flow (reference :252-297)."""
    _require_google()
    try:
        from google_auth_oauthlib.flow import InstalledAppFlow
    except ImportError as exc:
        raise AuthUnavailable(f"google-auth-oauthlib not installed: {exc}") from exc

    flow = InstalledAppFlow.from_client_config(load_client_secrets(), SCOPES)
    creds = flow.run_local_server(
        port=port, access_type="offline", prompt="consent"
    )
    return save_credentials(account, creds)


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser("google account auth")
    parser.add_argument("--account", required=True, help="short account name")
    parser.add_argument("--port", type=int, default=8080)
    args = parser.parse_args(argv)
    try:
        path = run_oauth_flow(args.account, args.port)
    except AuthUnavailable as exc:
        print(f"error: {exc}", file=sys.stderr)
        return 1
    print(f"credentials saved to {path}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

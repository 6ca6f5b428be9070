"""Profile registry (reference ``daemon/profiles/__init__.py:18-27``)."""

from __future__ import annotations

from whisper_mlx_tpu_torch.serving.profiles.base import Profile
from whisper_mlx_tpu_torch.serving.profiles.code_runner import PROFILE as code_runner
from whisper_mlx_tpu_torch.serving.profiles.general import PROFILE as general
from whisper_mlx_tpu_torch.serving.profiles.mirror import PROFILE as mirror

ALL_PROFILES: dict[str, Profile] = {
    p.name: p for p in (general, mirror, code_runner)
}


def get_profile(name: str) -> Profile:
    try:
        return ALL_PROFILES[name]
    except KeyError:
        raise ValueError(
            f"unknown profile: {name!r} (available: {sorted(ALL_PROFILES)})"
        ) from None


__all__ = ["Profile", "ALL_PROFILES", "get_profile"]

"""HTTP auth: constant-time credential checks + failed-attempt lockout.

Counterpart of ``arkflow_tpu/utils/auth.py``: Basic/Bearer credential
validation with ``hmac.compare_digest`` and per-client lockout after
``LOCKOUT_THRESHOLD`` failures. Credentials may reference environment
variables via ``${VAR}`` (``resolve_secret``, also used by the connectors'
passwords).
"""

from __future__ import annotations

import base64
import hmac
import os
import time
from dataclasses import dataclass, field
from typing import Optional

from arkflow_tpu_torch.errors import ConfigError

LOCKOUT_THRESHOLD = 5
LOCKOUT_SECONDS = 300.0


def resolve_secret(value: str) -> str:
    """``${ENV_NAME}`` indirection for secrets in config files."""
    if value.startswith("${") and value.endswith("}"):
        name = value[2:-1]
        resolved = os.environ.get(name)
        if resolved is None:
            raise ConfigError(f"auth: environment variable {name!r} is not set")
        return resolved
    return value


@dataclass
class AuthConfig:
    kind: str  # "basic" | "bearer" | "none"
    username: Optional[str] = None
    password: Optional[str] = None
    token: Optional[str] = None

    @classmethod
    def from_config(cls, m: Optional[dict]) -> "AuthConfig":
        if not m:
            return cls("none")
        kind = str(m.get("type", "none")).lower()
        if kind == "basic":
            user, pw = m.get("username"), m.get("password")
            if not user or not pw:
                raise ConfigError("basic auth requires username and password")
            return cls("basic", resolve_secret(str(user)), resolve_secret(str(pw)))
        if kind == "bearer":
            token = m.get("token")
            if not token:
                raise ConfigError("bearer auth requires token")
            return cls("bearer", token=resolve_secret(str(token)))
        if kind in ("none", ""):
            return cls("none")
        raise ConfigError(f"unknown auth type {kind!r}")


@dataclass
class Authenticator:
    config: AuthConfig
    _failures: dict[str, list] = field(default_factory=dict)

    def _locked_out(self, client: str) -> bool:
        entry = self._failures.get(client)
        if not entry:
            return False
        _count, _last, locked_until = entry
        if locked_until and time.monotonic() < locked_until:
            return True
        if locked_until:  # lockout served; start fresh
            del self._failures[client]
        return False

    def _record_failure(self, client: str) -> None:
        # entry = [count, last_failure, locked_until]. The count window is
        # anchored at the LAST failure (ref auth_middleware tracks
        # last_attempt/locked_until), so attempts paced slower than the
        # window reset the count, and pacing faster accumulates toward a
        # hard locked_until deadline — no drip-rate bypass.
        now = time.monotonic()
        entry = self._failures.get(client)
        if entry is None or now - entry[1] > LOCKOUT_SECONDS:
            entry = [0, now, 0.0]
            self._failures[client] = entry
        entry[0] += 1
        entry[1] = now
        if entry[0] >= LOCKOUT_THRESHOLD and not entry[2]:
            entry[2] = now + LOCKOUT_SECONDS

    def subject(self) -> Optional[str]:
        """The authenticated principal's identity, used as the tenant-id
        fallback when no tenant header is sent (runtime/overload.py multi-
        tenancy). Basic auth has a real subject (the username); bearer auth
        is a shared capability token with no identity — None."""
        if self.config.kind == "basic":
            return self.config.username
        return None

    def check(self, authorization: Optional[str], client: str = "?") -> bool:
        """Validate an Authorization header; tracks lockout per client."""
        if self.config.kind == "none":
            return True
        if self._locked_out(client):
            return False
        ok = False
        if authorization:
            if self.config.kind == "basic" and authorization.startswith("Basic "):
                try:
                    decoded = base64.b64decode(authorization[6:]).decode()
                    user, _, pw = decoded.partition(":")
                    ok = hmac.compare_digest(user, self.config.username or "") and hmac.compare_digest(
                        pw, self.config.password or ""
                    )
                except Exception:
                    ok = False
            elif self.config.kind == "bearer" and authorization.startswith("Bearer "):
                ok = hmac.compare_digest(authorization[7:], self.config.token or "")
        if ok:
            self._failures.pop(client, None)
        else:
            self._record_failure(client)
        return ok

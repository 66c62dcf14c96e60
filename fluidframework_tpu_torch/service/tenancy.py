"""Tenancy + auth — the riddler analogue.

Reference: server/routerlicious/packages/routerlicious-base/src/riddler
(tenant CRUD, per-tenant shared secrets) and the token path: clients
present a signed claims token on ``connect_document``
(services-utils jwt validation in alfred; protocol-definitions
ITokenClaims: documentId/tenantId/user/scopes/exp).

Stdlib construction: tokens are HMAC-SHA256-signed JSON claims
(base64url header-free JWS-style ``payload.signature``) — no external
jwt dependency. Scopes follow the reference vocabulary: ``doc:read``,
``doc:write``, ``summary:write``.
"""
from __future__ import annotations

import base64
import hashlib
import hmac
import json
import secrets
import time
from dataclasses import dataclass, field
from typing import Optional

SCOPE_READ = "doc:read"
SCOPE_WRITE = "doc:write"
SCOPE_SUMMARY = "summary:write"
DEFAULT_SCOPES = (SCOPE_READ, SCOPE_WRITE, SCOPE_SUMMARY)


class AuthError(Exception):
    pass


@dataclass
class Tenant:
    tenant_id: str
    key: str
    name: str = ""
    enabled: bool = True
    created_at: float = field(default_factory=time.time)


def _b64(data: bytes) -> str:
    return base64.urlsafe_b64encode(data).rstrip(b"=").decode()


def _unb64(s: str) -> bytes:
    return base64.urlsafe_b64decode(s + "=" * (-len(s) % 4))


def sign_token(key: str, tenant_id: str, document_id: str,
               user: str, scopes=DEFAULT_SCOPES,
               lifetime_s: float = 3600.0) -> str:
    """Create a claims token (the services-client generateToken
    analogue)."""
    claims = {
        "tenantId": tenant_id,
        "documentId": document_id,
        "user": {"id": user},
        "scopes": list(scopes),
        "exp": time.time() + lifetime_s,
        "iat": time.time(),
    }
    payload = _b64(json.dumps(claims, sort_keys=True).encode())
    sig = hmac.new(key.encode(), payload.encode(),
                   hashlib.sha256).digest()
    return f"{payload}.{_b64(sig)}"


class TenantManager:
    """riddler: tenant registry + token validation."""

    def __init__(self):
        self._tenants: dict[str, Tenant] = {}

    def create_tenant(self, tenant_id: str, name: str = "",
                      key: Optional[str] = None) -> Tenant:
        if tenant_id in self._tenants:
            raise ValueError(f"tenant {tenant_id!r} exists")
        t = Tenant(tenant_id, key or secrets.token_hex(32), name)
        self._tenants[tenant_id] = t
        return t

    def get_tenant(self, tenant_id: str) -> Optional[Tenant]:
        return self._tenants.get(tenant_id)

    def disable_tenant(self, tenant_id: str) -> None:
        t = self._tenants.get(tenant_id)
        if t is not None:
            t.enabled = False

    def refresh_key(self, tenant_id: str) -> str:
        t = self._tenants[tenant_id]
        t.key = secrets.token_hex(32)
        return t.key

    # ---- validation (alfred's verifyToken path)

    def validate_token(self, token: str, tenant_id: str,
                       document_id: str,
                       required_scope: str = SCOPE_READ) -> dict:
        """Verify signature/tenant/document/expiry/scope; returns the
        claims. Raises AuthError with a stable reason otherwise."""
        tenant = self._tenants.get(tenant_id)
        if tenant is None or not tenant.enabled:
            raise AuthError(f"unknown or disabled tenant {tenant_id!r}")
        try:
            payload, sig = token.split(".")
            expect = hmac.new(tenant.key.encode(), payload.encode(),
                              hashlib.sha256).digest()
            if not hmac.compare_digest(expect, _unb64(sig)):
                raise AuthError("bad signature")
            claims = json.loads(_unb64(payload))
            if not isinstance(claims, dict):
                # a signed non-object payload is malformed, not a
                # server error: claims.get below must never AttributeError
                raise AuthError("malformed token: claims not an object")
        except AuthError:
            raise
        except Exception as e:  # malformed token shape
            raise AuthError(
                f"malformed token: {type(e).__name__}") from e
        if claims.get("tenantId") != tenant_id:
            raise AuthError("token tenant mismatch")
        if claims.get("documentId") != document_id:
            raise AuthError("token document mismatch")
        if claims.get("exp", 0) < time.time():
            raise AuthError("token expired")
        if required_scope not in claims.get("scopes", []):
            raise AuthError(f"missing scope {required_scope!r}")
        return claims

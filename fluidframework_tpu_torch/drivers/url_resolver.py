"""URL resolvers — the request-routing seam between a host app and
the drivers.

Reference: packages/drivers/routerlicious-urlResolver/src/urlResolver.ts
:25 (RouterliciousUrlResolver.resolve: request URL -> IFluidResolvedUrl
with fluid:// identity + service endpoints + token),
packages/drivers/local-driver/src/localResolver.ts:32 (LocalResolver
for the in-proc dev service), and the loader flow that consumes them
(container.ts Loader.resolve). The reference's host apps never build a
driver by hand — they hand a URL to a resolver and get back the
document identity + endpoints the driver factory needs; this module is
that seam for the TPU repo's drivers (closing the §2.6
aux-drivers row: the dev service + socket driver already play the
tinylicious role; this adds the url-resolver layer, and
``debug_driver`` the debugger layer).

URL shape (the fftpu scheme mirrors fluid://):

    fftpu://<host>:<port>/<tenant>/<document>
    fftpu-local:///<document>            (in-proc LocalServer)
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Optional, Protocol
from urllib.parse import quote, unquote, urlparse


@dataclass
class ResolvedUrl:
    """IFluidResolvedUrl equivalent (driver-definitions
    urlResolver.ts): canonical identity + endpoints + tokens."""

    url: str                     # canonical fftpu:// identity
    document_id: str
    tenant_id: Optional[str] = None
    endpoints: dict = field(default_factory=dict)  # {"ordering": ...}
    tokens: dict = field(default_factory=dict)     # {"jwt": ...}


class UrlResolver(Protocol):
    def resolve(self, request_url: str) -> Optional[ResolvedUrl]:
        """Request URL -> resolved identity/endpoints, or None if the
        request is not for this resolver (resolvers chain)."""
        ...

    def get_absolute_url(self, resolved: ResolvedUrl,
                         relative: str) -> str:
        """Canonical shareable URL for a path within the document."""
        ...


class SocketUrlResolver:
    """Resolves fftpu:// (and localhost http://) URLs to the framed-
    TCP service — routerlicious-urlResolver equivalence. A token
    provider (riddler-analogue JWT mint) is attached per resolve, the
    way the reference resolver awaits getToken()."""

    def __init__(self,
                 token_provider: Optional[
                     Callable[[str, str], str]] = None):
        self._token_provider = token_provider

    def resolve(self, request_url: str) -> Optional[ResolvedUrl]:
        u = urlparse(request_url)
        if u.scheme not in ("fftpu", "http"):
            return None
        if u.scheme == "http" and u.hostname not in (
                "localhost", "127.0.0.1"):
            return None  # not ours; let another resolver try
        parts = [p for p in (u.path or "").split("/") if p]
        if len(parts) >= 2:
            tenant_id, document_id = parts[0], parts[1]
        elif len(parts) == 1:
            tenant_id, document_id = None, parts[0]
        else:
            return None
        tenant_id = unquote(tenant_id) if tenant_id else None
        document_id = unquote(document_id)
        host = u.hostname or "127.0.0.1"
        port = u.port or 7070
        tokens = {}
        if self._token_provider is not None and tenant_id:
            tokens["jwt"] = self._token_provider(
                tenant_id, document_id)
        return ResolvedUrl(
            url=_canonical(host, port, tenant_id, document_id),
            document_id=document_id,
            tenant_id=tenant_id,
            endpoints={"ordering": {"host": host, "port": port}},
            tokens=tokens,
        )

    def get_absolute_url(self, resolved: ResolvedUrl,
                         relative: str) -> str:
        rel = relative.lstrip("/")
        return f"{resolved.url}/{rel}" if rel else resolved.url


class LocalUrlResolver:
    """LocalResolver equivalent: routes fftpu-local:// requests to an
    in-proc LocalServer (the dev loop's resolver)."""

    def __init__(self, server):
        self.server = server

    def resolve(self, request_url: str) -> Optional[ResolvedUrl]:
        u = urlparse(request_url)
        if u.scheme != "fftpu-local":
            return None
        parts = [p for p in (u.path or "").split("/") if p]
        if not parts:
            return None
        document_id = unquote(parts[-1])
        return ResolvedUrl(
            url=f"fftpu-local:///{quote(document_id, safe='')}",
            document_id=document_id,
            endpoints={"local_server": self.server},
        )

    def get_absolute_url(self, resolved: ResolvedUrl,
                         relative: str) -> str:
        rel = relative.lstrip("/")
        return f"{resolved.url}/{rel}" if rel else resolved.url


def _canonical(host, port, tenant_id, document_id) -> str:
    tid = quote(tenant_id, safe="") if tenant_id else None
    did = quote(document_id, safe="")
    path = f"{tid}/{did}" if tid else did
    return f"fftpu://{host}:{port}/{path}"


def resolve_request(resolvers, request_url: str) -> ResolvedUrl:
    """First-match resolver chain (the loader walks its resolvers the
    same way; container.ts resolveWithLocationRedirectionHandling)."""
    for r in resolvers:
        resolved = r.resolve(request_url)
        if resolved is not None:
            return resolved
    raise ValueError(f"no resolver for {request_url!r}")


def create_document_service(resolved: ResolvedUrl, **kwargs):
    """Resolved URL -> the right driver (the driver-factory half of
    the reference's IDocumentServiceFactory.createDocumentService)."""
    if "local_server" in resolved.endpoints:
        if kwargs:
            # the in-proc driver takes no connection options; silently
            # dropping what the socket branch honors would make the
            # same call behave differently per URL scheme
            raise TypeError(
                f"local driver takes no options: {sorted(kwargs)}"
            )
        from .local_driver import LocalDocumentServiceFactory

        return LocalDocumentServiceFactory(
            resolved.endpoints["local_server"]
        ).create_document_service(resolved.document_id)
    ordering = resolved.endpoints["ordering"]
    from .socket_driver import SocketDocumentService

    return SocketDocumentService(
        ordering["host"], ordering["port"], resolved.document_id,
        tenant_id=resolved.tenant_id,
        token=resolved.tokens.get("jwt"),
        **kwargs,
    )


def load_container_from_url(resolvers, request_url: str,
                            client_id: str, **kwargs):
    """The host-app one-liner: URL -> resolver chain -> driver ->
    attached Container. Returns (container, service)."""
    from ..loader import Container

    resolved = resolve_request(resolvers, request_url)
    svc = create_document_service(resolved)
    lock = getattr(svc, "lock", None)
    if lock is not None:
        with lock:
            container = Container.load(
                svc, client_id=client_id, **kwargs)
    else:
        container = Container.load(svc, client_id=client_id, **kwargs)
    return container, svc

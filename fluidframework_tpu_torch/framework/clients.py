"""Service clients: the app-facing entry points.

Reference: packages/framework/tinylicious-client
(``TinyliciousClient`` TinyliciousClient.ts:42) and
azure/packages/azure-client (``AzureClient`` AzureClient.ts:51) —
``create_container(schema)`` / ``get_container(id, schema)`` returning
a FluidContainer plus service audience.

``LocalServiceClient`` targets the in-proc LocalServer (the
tinylicious analogue); a production client would swap the driver
factory and keep this surface.
"""
from __future__ import annotations

import itertools
import uuid
from dataclasses import dataclass

from ..drivers.local_driver import LocalDocumentServiceFactory
from ..loader.container import Container
from ..service.local_server import LocalServer
from .fluid_static import FluidContainer


@dataclass
class ContainerServices:
    """Service-side facilities handed back with the container (the
    audience: who else is connected)."""

    audience: object


class _Audience:
    def __init__(self, container: Container):
        self._container = container

    def get_members(self) -> dict:
        return self._container.protocol.quorum.members

    @property
    def size(self) -> int:
        return len(self._container.protocol.quorum.members)


class LocalServiceClient:
    """TinyliciousClient.ts:42 shape over LocalServer."""

    def __init__(self, server: LocalServer | None = None,
                 user_id: str = "user"):
        self.server = server or LocalServer()
        self._factory = LocalDocumentServiceFactory(self.server)
        self._user_id = user_id
        self._counter = itertools.count()

    def _client_id(self) -> str:
        # uuid suffix: ids must be unique across client instances
        # sharing one server, or peers' ops read as local acks
        return (
            f"{self._user_id}-{next(self._counter)}-"
            f"{uuid.uuid4().hex[:8]}"
        )

    def create_container(self, schema: dict[str, str]
                         ) -> tuple[FluidContainer, ContainerServices, str]:
        """Create a new document; returns (container, services, id)."""
        document_id = uuid.uuid4().hex[:12]
        service = self._factory.create_document_service(document_id)
        container = Container.load(service, client_id=self._client_id())
        fluid = FluidContainer(container, schema, create=True)
        return fluid, ContainerServices(_Audience(container)), document_id

    def get_container(self, document_id: str, schema: dict[str, str]
                      ) -> tuple[FluidContainer, ContainerServices]:
        service = self._factory.create_document_service(document_id)
        container = Container.load(service, client_id=self._client_id())
        fluid = FluidContainer(container, schema, create=False)
        return fluid, ContainerServices(_Audience(container))

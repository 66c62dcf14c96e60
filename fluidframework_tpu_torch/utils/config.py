"""Config/feature-gate system.

Reference: packages/utils/telemetry-utils/src/config.ts —
``IConfigProviderBase`` (:13) raw provider,
``CachedConfigProvider`` (:153) typed cached reads,
``MonitoringContext`` (mixinMonitoringContext :241) bundling
logger + config, read ad hoc as feature gates
(e.g. containerRuntime.ts:1704 ``getBoolean("enableOfflineLoad")``).
"""
from __future__ import annotations

from typing import Any, Callable, Optional

from .telemetry import TelemetryLogger


class ConfigProvider:
    """IConfigProviderBase (:13): raw key lookup. Wrap a dict or a
    callable (env, file, remote flags...)."""

    def __init__(self, source: dict | Callable[[str], Any]):
        self._source = source

    def get_raw(self, key: str) -> Any:
        if callable(self._source):
            return self._source(key)
        return self._source.get(key)


class CachedConfigProvider:
    """config.ts:153 — caches lookups, coerces types defensively
    (a mistyped flag reads as None, never raises)."""

    def __init__(self, *providers: ConfigProvider):
        self.providers = providers
        self._cache: dict[str, Any] = {}

    def _get(self, key: str) -> Any:
        if key not in self._cache:
            value = None
            for provider in self.providers:  # first provider wins
                value = provider.get_raw(key)
                if value is not None:
                    break
            self._cache[key] = value
        return self._cache[key]

    def get_boolean(self, key: str) -> Optional[bool]:
        value = self._get(key)
        if isinstance(value, bool):
            return value
        if isinstance(value, str):
            if value.lower() in ("true", "1"):
                return True
            if value.lower() in ("false", "0"):
                return False
        return None

    def get_number(self, key: str) -> Optional[float]:
        value = self._get(key)
        if isinstance(value, bool):
            return None
        if isinstance(value, (int, float)):
            return value
        if isinstance(value, str):
            try:
                return float(value)
            except ValueError:
                return None
        return None

    def get_string(self, key: str) -> Optional[str]:
        value = self._get(key)
        return value if isinstance(value, str) else None


class MonitoringContext:
    """mixinMonitoringContext (config.ts:241): logger + config travel
    together through the stack."""

    def __init__(self, logger: TelemetryLogger,
                 config: Optional[CachedConfigProvider] = None):
        self.logger = logger
        self.config = config or CachedConfigProvider(ConfigProvider({}))


def mixin_monitoring_context(
    logger: TelemetryLogger,
    *providers: ConfigProvider,
) -> MonitoringContext:
    return MonitoringContext(logger, CachedConfigProvider(*providers))

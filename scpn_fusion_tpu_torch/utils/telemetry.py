"""Fallback telemetry with env-budget enforcement (fail-closed accounting).

Port of the reference's fallback-budget machinery
(``core/fallback_telemetry.py:82-128``; env knobs
``SCPN_MAX_FALLBACK_EVENTS_*``; guard ``tools/fallback_budget_guard.py``):
every time a degraded path is taken (numerical recovery, surrogate fallback,
blocked lane), the event is recorded; when a per-category budget is
configured via ``SCPN_TPU_MAX_FALLBACK_EVENTS[_<CATEGORY>]``, exceeding it
raises ``FallbackBudgetExceeded`` — silent degradation is never free.
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import Counter
from typing import Any

_ENV_PREFIX = "SCPN_TPU_MAX_FALLBACK_EVENTS"


class FallbackBudgetExceeded(RuntimeError):
    """Raised when a fallback category exceeds its configured budget."""


class FallbackTelemetry:
    """Thread-safe fallback-event ledger with optional budgets."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._counts: Counter = Counter()
        self._events: list[dict[str, Any]] = []

    def record(self, component: str, event: str,
               context: dict[str, Any] | None = None) -> None:
        key = f"{component}.{event}"
        with self._lock:
            self._counts[key] += 1
            self._events.append({
                "t": time.time(), "component": component,
                "event": event, "context": context or {},
            })
            count = self._counts[key]
        budget = self._budget_for(component)
        if budget is not None and count > budget:
            raise FallbackBudgetExceeded(
                f"fallback budget exceeded for {key}: {count} > {budget}")

    @staticmethod
    def _budget_for(component: str) -> int | None:
        specific = os.environ.get(f"{_ENV_PREFIX}_{component.upper()}")
        if specific is not None:
            return int(specific)
        general = os.environ.get(_ENV_PREFIX)
        return int(general) if general is not None else None

    def counts(self) -> dict[str, int]:
        with self._lock:
            return dict(self._counts)

    def dump_jsonl(self, path) -> None:
        with self._lock, open(path, "w", encoding="utf-8") as fh:
            for e in self._events:
                fh.write(json.dumps(e) + "\n")

    def reset(self) -> None:
        with self._lock:
            self._counts.clear()
            self._events.clear()


# Module-level default ledger (the reference's pattern).
TELEMETRY = FallbackTelemetry()


def record_fallback_event(component: str, event: str,
                          context: dict[str, Any] | None = None) -> None:
    TELEMETRY.record(component, event, context)

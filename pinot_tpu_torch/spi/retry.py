"""Retry policies and the service lifecycle.

Counterpart of ``pinot_tpu/spi/retry.py`` (JAX :18-155; the reference's
``utils/retry/`` ``RetryPolicy``, ``RetryPolicies`` and
``AttemptsExceededException``, and ``ServiceStartable``): a policy runs an
operation until it returns, sleeping its delay between attempts; a
``ValueError`` is permanent and raises at once unless ``retriable`` says
otherwise, and the last failure raises ``AttemptsExceededError``.
``ServiceManager`` starts services in order and stops them in reverse,
stopping the started ones when a later start fails.
"""

from __future__ import annotations

import random
import time
from typing import Callable, List, Optional, TypeVar

T = TypeVar("T")


class AttemptsExceededError(Exception):
    """Ref: AttemptsExceededException — the operation never succeeded."""

    def __init__(self, attempts: int, last: Optional[BaseException]):
        super().__init__(f"operation failed after {attempts} attempts: "
                         f"{last}")
        self.attempts = attempts
        self.last = last


class RetryPolicy:
    """Ref: RetryPolicy.attempt — run ``op`` until it returns without
    raising a retriable error, sleeping policy-defined delays between
    attempts. ``retriable`` gates which exceptions retry (defaults to
    everything except ``ValueError`` — permanent input errors)."""

    def __init__(self, max_attempts: int):
        if max_attempts < 1:
            raise ValueError("max_attempts must be >= 1")
        self.max_attempts = max_attempts

    def delay_s(self, attempt: int) -> float:
        raise NotImplementedError

    def attempt(self, op: Callable[[], T],
                retriable: Optional[Callable[[BaseException], bool]] = None
                ) -> T:
        last: Optional[BaseException] = None
        for i in range(self.max_attempts):
            try:
                return op()
            except BaseException as e:  # noqa: BLE001 — gated below
                if isinstance(e, (KeyboardInterrupt, SystemExit)):
                    raise
                if retriable is not None:
                    if not retriable(e):
                        raise
                elif isinstance(e, ValueError):
                    raise
                last = e
                if i + 1 < self.max_attempts:
                    time.sleep(self.delay_s(i))
        raise AttemptsExceededError(self.max_attempts, last) from last


class FixedDelayRetryPolicy(RetryPolicy):
    """Ref: FixedDelayRetryPolicy."""

    def __init__(self, max_attempts: int, delay_ms: float):
        super().__init__(max_attempts)
        self._delay = delay_ms / 1e3

    def delay_s(self, attempt: int) -> float:
        return self._delay


class ExponentialBackoffRetryPolicy(RetryPolicy):
    """Ref: ExponentialBackoffRetryPolicy — the delay before attempt N is
    a uniform draw from [0, initial * scale^N) (the reference randomizes
    to avoid thundering herds)."""

    def __init__(self, max_attempts: int, initial_delay_ms: float,
                 delay_scale: float = 2.0, randomize: bool = True):
        super().__init__(max_attempts)
        self._initial = initial_delay_ms / 1e3
        self._scale = delay_scale
        self._randomize = randomize

    def delay_s(self, attempt: int) -> float:
        cap = self._initial * (self._scale ** attempt)
        return random.uniform(0, cap) if self._randomize else cap


def exponential_backoff(max_attempts: int = 3, initial_delay_ms: float = 100,
                        delay_scale: float = 2.0
                        ) -> ExponentialBackoffRetryPolicy:
    """Ref: RetryPolicies.exponentialBackoffRetryPolicy."""
    return ExponentialBackoffRetryPolicy(max_attempts, initial_delay_ms,
                                         delay_scale)


def fixed_delay(max_attempts: int = 3, delay_ms: float = 100
                ) -> FixedDelayRetryPolicy:
    """Ref: RetryPolicies.fixedDelayRetryPolicy."""
    return FixedDelayRetryPolicy(max_attempts, delay_ms)


# --------------------------------------------------------------------------
# service lifecycle (ref: ServiceStartable.java + StartServiceManagerCommand)
# --------------------------------------------------------------------------

class ServiceStartable:
    """The role-process contract: start/stop + identity."""

    def start(self) -> None:
        raise NotImplementedError

    def stop(self) -> None:
        raise NotImplementedError

    @property
    def service_role(self) -> str:
        raise NotImplementedError


class ServiceManager:
    """Start services in registration order, stop in reverse — and stop
    the already-started prefix if a later start fails (the reference's
    bootstrap ordering: controller before broker before server)."""

    def __init__(self):
        self._services: List[ServiceStartable] = []
        self._started: List[ServiceStartable] = []

    def register(self, svc: ServiceStartable) -> "ServiceManager":
        self._services.append(svc)
        return self

    def start_all(self) -> None:
        for svc in self._services:
            try:
                svc.start()
            except BaseException:
                self.stop_all()
                raise
            self._started.append(svc)

    def stop_all(self) -> None:
        for svc in reversed(self._started):
            try:
                svc.stop()
            except Exception:  # noqa: BLE001 — best-effort teardown
                pass
        self._started.clear()

    @property
    def roles(self) -> List[str]:
        return [s.service_role for s in self._services]

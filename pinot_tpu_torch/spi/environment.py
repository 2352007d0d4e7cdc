"""The environment provider SPI: the failure domain a process runs in.

Counterpart of ``pinot_tpu/spi/environment.py`` (the reference's
``PinotEnvironmentProvider``): a provider names the failure domain of
the process, the server registers it on its instance, and the
controller's assignment spreads a segment's replicas across domains.
``EnvVarEnvironmentProvider`` (``env``, the default) reads
``PINOT_FAILURE_DOMAIN``; ``NoOpEnvironmentProvider`` names none.
"""

from __future__ import annotations

import os
from typing import Callable, Dict, Optional


class PinotEnvironmentProvider:
    """The SPI (ref: PinotEnvironmentProvider.getEnvironment)."""

    def get_environment(self) -> Dict[str, str]:
        """Arbitrary key/value environment facts; ``failureDomain`` is the
        one placement consumes."""
        raise NotImplementedError

    def failure_domain(self) -> Optional[str]:
        return self.get_environment().get("failureDomain")


class NoOpEnvironmentProvider(PinotEnvironmentProvider):
    """Default: no environment facts (single-domain clusters)."""

    def get_environment(self) -> Dict[str, str]:
        return {}


class EnvVarEnvironmentProvider(PinotEnvironmentProvider):
    """Reads PINOT_FAILURE_DOMAIN (the operator/scheduler injects it, the
    way cloud deployments template zone labels into pod env)."""

    def get_environment(self) -> Dict[str, str]:
        fd = os.environ.get("PINOT_FAILURE_DOMAIN")
        return {"failureDomain": fd} if fd else {}


_REGISTRY: Dict[str, Callable[[], PinotEnvironmentProvider]] = {
    "noop": NoOpEnvironmentProvider,
    "env": EnvVarEnvironmentProvider,
}


def register_environment_provider(
        name: str, ctor: Callable[[], PinotEnvironmentProvider]) -> None:
    _REGISTRY[name.lower()] = ctor


def get_environment_provider(
        name: str = "env") -> PinotEnvironmentProvider:
    ctor = _REGISTRY.get(name.lower())
    if ctor is None:
        raise ValueError(f"no environment provider {name!r} "
                         f"(registered: {sorted(_REGISTRY)})")
    return ctor()

"""Per-shape blocklist of the fused scan: which plan specs must not take
the CUDA kernel, and why.

Counterpart of ``pinot_tpu/engine/pallas_blocklist.py`` (``PallasBlocklist``
under JAX's name and reason codes, so the two packages' decision ledgers
compare). Each entry maps a ``SegmentPlan.spec`` to the reason its decline
records: a preflight prediction (``tools/preflight.py``) seeds a shape with
its ``pallas_preflight_<rule>`` code. ``add`` writes the whole list through
to ``pinot.server.query.pallas.blocklist.path`` where one is configured,
and a new executor reads the file back, so a list outlives the process that
learned it; ``snapshot`` is the rows of ``GET /debug/pallas``.

Only a ``pallas_preflight_<rule>`` code declines a shape: a limit the
kernel's compiler enforces. A launch that fails on the card raises (no
fallback, ROADMAP's rules), so ``add`` refuses any other reason, and a
file's entry under ``RUNTIME_BLOCK_REASON`` (JAX blocks a shape whose
kernel failed at run time; this kernel never failed for it) is skipped
with a warning rather than sending the shape off the kernel.

Specs are nested tuples of str / int / bool / None, so they round-trip
through ``repr`` and ``ast.literal_eval``.
"""

from __future__ import annotations

import ast
import json
import logging
import os
import threading

from typing import Any, Dict, List, Optional, Tuple

log = logging.getLogger(__name__)

# the reason JAX records for a shape whose kernel failed at run time
RUNTIME_BLOCK_REASON = "pallas_shape_blocked"
# the reasons an entry may carry: the preflight's rule codes
PREFLIGHT_PREFIX = "pallas_preflight_"


class PallasBlocklist:
    """Thread-safe ``{plan spec -> decline reason}`` with optional
    write-through persistence."""

    def __init__(self, path: Optional[str] = None):
        self._lock = threading.Lock()
        self._specs: Dict[Tuple, str] = {}  # guarded-by: _lock
        self.path = path or None
        if self.path:
            self._load()

    def add(self, spec: Tuple, reason: str) -> None:
        if not reason.startswith(PREFLIGHT_PREFIX):
            raise ValueError(f"not a preflight code: {reason!r}")
        with self._lock:
            self._specs[spec] = reason
            entries = self._entries_locked()
        self._persist(entries)

    def __contains__(self, spec: Tuple) -> bool:
        with self._lock:
            return spec in self._specs

    def __len__(self) -> int:
        with self._lock:
            return len(self._specs)

    def reason_for(self, spec: Tuple) -> Optional[str]:
        """The code a blocked shape's decline records."""
        with self._lock:
            return self._specs.get(spec)

    def snapshot(self) -> List[Dict[str, Any]]:
        """``GET /debug/pallas`` rows (the spec's repr is the key the file
        reloads)."""
        with self._lock:
            return self._entries_locked()

    def _entries_locked(self) -> List[Dict[str, str]]:
        return [{"spec": repr(s), "reason": r}
                for s, r in self._specs.items()]

    def _persist(self, entries: List[Dict[str, str]]) -> None:
        if not self.path:
            return
        tmp = f"{self.path}.tmp"
        try:
            d = os.path.dirname(self.path)
            if d:
                os.makedirs(d, exist_ok=True)
            with open(tmp, "w", encoding="utf-8") as f:
                json.dump({"entries": entries}, f, indent=1)
            os.replace(tmp, self.path)
        except OSError:
            # an unwritable path must not fail the query that added it
            log.exception("blocklist persist failed: %s", self.path)

    def _load(self) -> None:
        try:
            with open(self.path, encoding="utf-8") as f:
                data = json.load(f)
        except FileNotFoundError:
            return
        except (OSError, ValueError):
            log.exception("blocklist unreadable: %s", self.path)
            return
        for e in data.get("entries", []):
            reason = e.get("reason", RUNTIME_BLOCK_REASON)
            try:
                spec = ast.literal_eval(e["spec"])
            except (KeyError, ValueError, SyntaxError):
                log.warning("blocklist entry skipped: %r", e)
                continue
            if not reason.startswith(PREFLIGHT_PREFIX):
                log.warning("blocklist entry refused (%s is not a preflight "
                            "code): %r", reason, e)
                continue
            with self._lock:
                self._specs[spec] = reason

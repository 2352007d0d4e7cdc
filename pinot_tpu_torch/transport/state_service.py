"""Remote cluster state store: HTTP service + replicating client.

Counterpart of ``pinot_tpu/transport/state_service.py``: ``StateStoreApi``
(:35, ``/state/get|set|cas|delete|poll``) serves the authoritative
``ClusterStateStore`` beside the controller, and a remote role runs a
``RemoteClusterStateStore`` (:69): a full local replica kept by a polling
thread, so reads are local and watchers fire as the in-process store's
do; writes go to the authority (a set directly, a read-modify-write as a
compare-and-set loop). A replica catches up from the store's mutation log
(``mutations_since``) and resyncs from ``snapshot_data`` where the log no
longer reaches back, or after ``reconnect`` to another authority.
``urllib`` only. Schemas and table configs cross the wire as JAX's JSON
dicts and are objects again on each side (``state.to_wire`` /
``from_wire``, by path), so a replica of either package reads the other's
authority.

The multi-host control plane (SURVEY §5 "distributed comm backend"): the
reference coordinates roles through ZooKeeper; here the controller hosts
the authoritative store and exposes its primitives over HTTP.
"""

from __future__ import annotations

import json
import logging
import threading
import urllib.request

from typing import Any, Callable, List, Optional

from pinot_tpu_torch.controller.state import (
    ClusterStateStore,
    from_wire,
    to_wire,
)
from pinot_tpu_torch.transport.rest import _Api

log = logging.getLogger(__name__)


class StateStoreApi(_Api):
    """HTTP face of the authoritative store (runs next to the controller)."""

    def __init__(self, store: ClusterStateStore, port: int = 0,
                 access_control=None):
        super().__init__(port, access_control=access_control)
        s = store

        self.route("GET", r"/health", lambda m, b: (200, {"status": "OK"}))
        self.route("POST", r"/state/get",
                   lambda m, b: (200, {"value": to_wire(s.get(b["path"]))}))
        self.route("POST", r"/state/set",
                   lambda m, b: (200, {"version": s.set(
                       b["path"], from_wire(b["path"], b["value"]))}))
        self.route("POST", r"/state/cas",
                   lambda m, b: (200, {"ok": s.compare_and_set(
                       b["path"], from_wire(b["path"], b.get("expected")),
                       from_wire(b["path"], b["value"]))}))
        self.route("POST", r"/state/delete",
                   lambda m, b: (200, {"ok": s.delete(b["path"]) or True}))
        self.route("POST", r"/state/poll",
                   lambda m, b: (200, self._poll(s, b)))

    @staticmethod
    def _poll(s: ClusterStateStore, body):
        since = int((body or {}).get("sinceVersion", -1))
        version, muts = s.mutations_since(since)
        if muts is None:  # log doesn't reach back: ship the full snapshot
            version, data = s.snapshot_data()
            return {"version": version, "snapshot": data}
        return {"version": version,
                "mutations": [{"v": v, "path": p, "value": val}
                              for v, p, val in muts]}


class RemoteClusterStateStore(ClusterStateStore):
    """Replica store for remote roles. Same interface as the in-process
    store; reads are local, writes remote, watches fire from the poller."""

    def __init__(self, base_url: str, poll_interval_s: float = 0.05,
                 timeout_s: float = 30.0):
        super().__init__()
        # poller and reconnect race on these; pre-lock snapshot reads are
        # part of the epoch protocol, so only writes must hold the lock
        self._base = base_url.rstrip("/")  # guarded-by-writes: _lock
        self._timeout = timeout_s
        self._poll_interval = poll_interval_s
        self._remote_version = -1  # guarded-by-writes: _lock
        self._epoch = 0  # guarded-by-writes: _lock
        self._stop = threading.Event()
        self._sync_once()  # fail fast if the authority is unreachable
        self._poller = threading.Thread(target=self._poll_loop, daemon=True,
                                        name="state-replica-poller")
        self._poller.start()

    # -- transport ----------------------------------------------------------
    def _call(self, endpoint: str, body: dict) -> dict:
        req = urllib.request.Request(
            f"{self._base}{endpoint}",
            data=json.dumps(body).encode("utf-8"),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=self._timeout) as r:
            return json.loads(r.read().decode("utf-8"))

    # -- replica sync --------------------------------------------------------
    def _sync_once(self) -> None:
        epoch = self._epoch
        out = self._call("/state/poll",
                         {"sinceVersion": self._remote_version})
        if "snapshot" in out:
            with self._lock:
                if epoch != self._epoch:
                    return  # reconnect raced: discard the stale reply
                removed = [k for k in self._data if k not in out["snapshot"]]
                self._data = {p: from_wire(p, v)
                              for p, v in out["snapshot"].items()}
                self._version = max(self._version, int(out["version"]))
                paths = list(self._data.items())
                # full resync can't replay per-path events: fire for every
                # present path AND a deletion event per vanished path, so
                # prefix watchers (lineage caches etc.) never miss a delete
                for p in removed:
                    self._pending.append((p, None))
                for p, v in paths:
                    self._pending.append((p, self._copy(v)))
            self._drain_notifications()
        else:
            muts = out.get("mutations", [])
            if muts:
                with self._lock:
                    if epoch != self._epoch:
                        return
                    for m in muts:
                        value = from_wire(m["path"], m["value"])
                        if value is None:
                            self._data.pop(m["path"], None)
                        else:
                            self._data[m["path"]] = value
                        self._pending.append((m["path"], value))
                    self._version = max(self._version, int(out["version"]))
                self._drain_notifications()
            else:
                with self._lock:
                    if epoch != self._epoch:
                        return
                    self._version = max(self._version, int(out["version"]))
        with self._lock:
            if epoch != self._epoch:
                return  # reconnect raced: keep the forced -1 resync marker
            self._remote_version = out["version"]

    def _poll_loop(self) -> None:
        while not self._stop.wait(self._poll_interval):
            try:
                self._sync_once()
            except Exception:
                log.warning("state replica poll failed; retrying",
                            exc_info=True)

    def reconnect(self, base_url: str) -> None:
        """Point the replica at a restarted/relocated authority (the ZK
        reconnect analogue) and force a FULL resync: the new authority's
        version counter may be behind ours (restart from an older
        snapshot), and mutations_since would otherwise report 'up to
        date' forever. The epoch guard stops an in-flight poll against
        the old authority from clobbering the reset."""
        with self._lock:
            self._epoch += 1
            self._base = base_url.rstrip("/")
            self._remote_version = -1

    def close(self) -> None:
        self._stop.set()

    # -- write path: remote authority ---------------------------------------
    def set(self, path: str, value: Any) -> int:
        out = self._call("/state/set", {"path": path,
                                        "value": to_wire(value)})
        # apply locally right away: the caller's next read must see its own
        # write (the poller would get there, but not synchronously)
        with self._lock:
            self._data[path] = self._copy(value)
            self._version = max(self._version, int(out["version"]))
        return int(out["version"])

    def update(self, path: str, fn: Callable[[Any], Any],
               default: Any = None) -> Any:
        for _ in range(64):
            cur = self._call("/state/get", {"path": path})["value"]
            base = (from_wire(path, cur) if cur is not None else default)
            new = fn(self._copy(base))
            if self._call("/state/cas", {"path": path, "expected": cur,
                                         "value": to_wire(new)})["ok"]:
                with self._lock:
                    self._data[path] = self._copy(new)
                return new
        raise RuntimeError(f"CAS contention on {path!r} (64 attempts)")

    def compare_and_set(self, path: str, expected: Any, value: Any) -> bool:
        ok = bool(self._call("/state/cas", {
            "path": path, "expected": to_wire(expected),
            "value": to_wire(value)})["ok"])
        if ok:
            with self._lock:
                self._data[path] = self._copy(value)
        return ok

    def delete(self, path: str) -> None:
        self._call("/state/delete", {"path": path})
        with self._lock:
            self._data.pop(path, None)

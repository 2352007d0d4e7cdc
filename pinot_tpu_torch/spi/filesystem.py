"""The deep store: where a pushed segment is kept until a server fetches it.

Counterpart of ``pinot_tpu/spi/filesystem.py`` (``fetch_segment`` and its
scheme registry). The port builds its segments in memory and has no
on-disk format yet, so it has one scheme, ``memory://<table>/<segment>``:
a ``MemoryDeepStore`` of immutable segment objects. Each cluster owns one
(the controller holds it and hands it to its servers), so two clusters in
one process never see each other's segments, and a cluster's segments go
with it. ``put_segment`` keeps a segment and returns its location,
``fetch_segment`` resolves a location to the object itself (every replica
that fetches it shares the one object; each server stages its own copy on
the card), and any other scheme raises. A realtime seal
(``ingestion/realtime.py``) names its location with ``segment_url`` and
keeps nothing here.
"""

from __future__ import annotations

import threading

from typing import Any, Dict, Tuple

SCHEME = "memory"


def segment_url(table: str, segment_name: str) -> str:
    return f"{SCHEME}://{table}/{segment_name}"


def _parse(url: str) -> Tuple[str, str]:
    scheme, sep, rest = url.partition("://")
    if not sep or scheme.lower() != SCHEME:
        raise ValueError(f"no deep store for scheme {scheme!r} of {url!r} "
                         f"(the port keeps segments under {SCHEME}://)")
    table, sep, name = rest.partition("/")
    if not sep or not table or not name:
        raise ValueError(f"{url!r} is not {SCHEME}://<table>/<segment>")
    return table, name


class MemoryDeepStore:
    """One cluster's segments, keyed by table and segment name."""

    def __init__(self):
        self._lock = threading.Lock()
        self._segments: Dict[Tuple[str, str], Any] = {}  # guarded-by: _lock

    def put_segment(self, table: str, segment) -> str:
        """Keep ``segment`` under ``table``; -> its location. A segment of
        the same name replaces the one kept before (a refresh push)."""
        with self._lock:
            self._segments[(table, segment.segment_name)] = segment
        return segment_url(table, segment.segment_name)

    def fetch_segment(self, download_url: str):
        """The segment kept at ``download_url``; raises ``ValueError`` for
        another scheme and ``KeyError`` for a location holding nothing."""
        key = _parse(download_url)
        with self._lock:
            seg = self._segments.get(key)
        if seg is None:
            raise KeyError(f"deep store holds no segment at {download_url!r}")
        return seg

    def delete_segment(self, table: str, segment_name: str) -> None:
        with self._lock:
            self._segments.pop((table, segment_name), None)

    def delete_table(self, table: str) -> None:
        """Drop every segment kept under ``table``."""
        with self._lock:
            for key in [k for k in self._segments if k[0] == table]:
                del self._segments[key]

    def clear(self) -> None:
        with self._lock:
            self._segments.clear()

    def __len__(self) -> int:
        with self._lock:
            return len(self._segments)


__all__ = ["SCHEME", "segment_url", "MemoryDeepStore"]

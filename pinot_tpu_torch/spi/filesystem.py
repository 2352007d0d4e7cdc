"""The deep store: where a pushed segment is kept until a server fetches it.

Counterpart of ``pinot_tpu/spi/filesystem.py``: ``PinotFS``, its local
``file://`` form ``LocalPinotFS`` (JAX :26-82, cut to the fetch), the
scheme registry ``get_fs`` (:141-154) and ``fetch_segment`` (:156),
which resolves a segment's download URL to a local segment directory with
retries. A segment in a ``file://`` store is a directory in the JAX
package's layout (``segment/creator.py``), and a local one is served in
place: every replica in the process maps the same directory. Schemes that
copy to a local directory, and segment crypters (the JAX ``local_dir`` and
``crypter`` arguments), are not ported.

Beside it, ``memory://<table>/<segment>``: a ``MemoryDeepStore`` of
immutable segment objects, for a cluster that keeps its segments in
memory. Each such cluster owns one (the controller holds it and hands it
to its servers), so two clusters in one process never see each other's
segments, and a cluster's segments go with it. ``put_segment`` keeps a
segment and returns its location, ``fetch_segment`` resolves a location
to the object itself (every replica that fetches it shares the one
object; each server stages its own copy on the card).
"""

from __future__ import annotations

import os
import threading
import time
import urllib.parse

from typing import Any, Callable, Dict, Tuple

SCHEME = "memory"


#: a fetch's tries, and the wait before the second (it doubles after)
FETCH_ATTEMPTS = 3
FETCH_BACKOFF_S = 0.2


class PinotFS:
    """A deep store's scheme (the reference's PinotFS, cut to what a
    server's fetch uses)."""

    scheme = ""

    def local_segment_dir(self, uri: str) -> str:
        """The local directory of the segment at ``uri``."""
        raise NotImplementedError


class LocalPinotFS(PinotFS):
    """``file://`` URIs and bare paths. A local segment is served in
    place: nothing is copied."""

    scheme = "file"

    def local_segment_dir(self, uri: str) -> str:
        p = uri[len("file://"):] if uri.startswith("file://") else uri
        if not os.path.isdir(p):
            raise FileNotFoundError(f"no segment directory at {uri!r}")
        return p


_REGISTRY: Dict[str, Callable[[], PinotFS]] = {
    "file": LocalPinotFS,
    "": LocalPinotFS,
}


def get_fs(uri: str) -> PinotFS:
    """The filesystem of ``uri``'s scheme; raises ``ValueError`` for a
    scheme nothing registered (``memory://`` is a cluster's
    ``MemoryDeepStore``, not a filesystem)."""
    scheme = urllib.parse.urlparse(uri).scheme.lower()
    ctor = _REGISTRY.get(scheme)
    if ctor is None:
        raise ValueError(f"no PinotFS registered for scheme {scheme!r} "
                         f"(registered: {sorted(_REGISTRY)})")
    return ctor()


def file_url(segment_dir: str) -> str:
    """The ``file://`` location of a local segment directory."""
    return f"file://{os.path.abspath(segment_dir)}"


def fetch_segment(download_url: str) -> str:
    """Resolve a segment's download URL to a local segment directory (the
    server's download from the deep store), trying ``FETCH_ATTEMPTS``
    times with a doubling wait; a ``ValueError`` (an unknown scheme) is
    not retried, and the last failure raises."""
    fs = get_fs(download_url)
    delay = FETCH_BACKOFF_S
    for attempt in range(FETCH_ATTEMPTS):
        try:
            return fs.local_segment_dir(download_url)
        except Exception:
            if attempt + 1 >= FETCH_ATTEMPTS:
                raise
            time.sleep(delay)
            delay *= 2
    raise AssertionError("unreachable")


def segment_url(table: str, segment_name: str) -> str:
    return f"{SCHEME}://{table}/{segment_name}"


def _parse(url: str) -> Tuple[str, str]:
    scheme, sep, rest = url.partition("://")
    if not sep or scheme.lower() != SCHEME:
        raise ValueError(f"{url!r} is not a {SCHEME}:// location "
                         "(fetch_segment resolves the other schemes)")
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


__all__ = ["SCHEME", "segment_url", "MemoryDeepStore", "PinotFS",
           "LocalPinotFS", "get_fs", "file_url", "fetch_segment"]

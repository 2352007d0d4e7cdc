"""The deep store: where a pushed segment is kept until a server fetches it.

Counterpart of ``pinot_tpu/spi/filesystem.py`` (JAX :26-189): ``PinotFS``
(exists, list, delete, copy a segment directory to and from a local
directory), its ``file://`` form ``LocalPinotFS``, the ``http(s)://``
fetcher ``HttpSegmentFetcher`` (GET ``<url>/__files__`` for the file
list, then each file), ``s3://`` (``spi/s3fs.py``, registered at first
use), the scheme registry ``register_fs`` / ``get_fs`` and
``fetch_segment``, which resolves a segment's download URL to a local
segment directory. A segment in a store is a directory in the JAX
package's layout (``segment/creator.py``).

``fetch_segment(download_url, local_dir, retries, backoff_s, crypter)``
tries under ``spi/retry.py``'s exponential policy: an unknown scheme
fails at once, a ``ValueError`` (a name that escapes ``local_dir``) is
never retried, and the last failure raises ``AttemptsExceededError``. A
local segment is served in place (every replica in the process maps the
same directory). A remote one is copied under ``local_dir`` into a
temporary directory renamed into place, so a loader never finds half a
segment. With a ``crypter`` (``spi/crypt.py``) the local copy is
decrypted, never the store's original: a ``file://`` segment is then
copied first.

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

import json
import os
import shutil
import tempfile
import threading
import urllib.parse
import urllib.request

from typing import Any, Callable, Dict, List, Optional, Tuple

SCHEME = "memory"


#: a fetch's tries, and the wait before the second (it doubles after)
FETCH_ATTEMPTS = 3
FETCH_BACKOFF_S = 0.2


class PinotFS:
    """A deep store's scheme (ref: PinotFS.java, the operative subset)."""

    scheme = ""

    def exists(self, uri: str) -> bool:
        raise NotImplementedError

    def list_files(self, uri: str) -> List[str]:
        raise NotImplementedError

    def delete(self, uri: str) -> None:
        raise NotImplementedError

    def copy_to_local_dir(self, uri: str, local_dir: str) -> str:
        """Put the segment at ``uri`` under ``local_dir``; -> the local
        segment directory."""
        raise NotImplementedError

    def copy_from_local_dir(self, local_dir: str, uri: str) -> None:
        raise NotImplementedError


class LocalPinotFS(PinotFS):
    """``file://`` URIs and bare paths. A local segment is served in
    place: nothing is copied, and a missing directory raises
    ``FileNotFoundError`` (JAX returns the path and fails at the load)."""

    scheme = "file"

    @staticmethod
    def _path(uri: str) -> str:
        return uri[len("file://"):] if uri.startswith("file://") else uri

    def exists(self, uri: str) -> bool:
        return os.path.exists(self._path(uri))

    def list_files(self, uri: str) -> List[str]:
        p = self._path(uri)
        return sorted(os.path.join(p, f) for f in os.listdir(p))

    def delete(self, uri: str) -> None:
        p = self._path(uri)
        if os.path.isdir(p):
            shutil.rmtree(p, ignore_errors=True)
        elif os.path.exists(p):
            os.remove(p)

    def copy_to_local_dir(self, uri: str, local_dir: Optional[str]) -> str:
        p = self._path(uri)
        if not os.path.isdir(p):
            raise FileNotFoundError(f"no segment directory at {uri!r}")
        return p

    def copy_from_local_dir(self, local_dir: str, uri: str) -> None:
        dst = self._path(uri)
        if os.path.abspath(local_dir) != os.path.abspath(dst):
            shutil.copytree(local_dir, dst, dirs_exist_ok=True)


def _inside(seg_dir: str, rel: str) -> str:
    """``seg_dir/rel``; a ``ValueError`` where ``rel`` escapes ``seg_dir``
    (a store's names are not trusted)."""
    dst = os.path.abspath(os.path.join(seg_dir, rel))
    if os.path.isabs(rel) or not dst.startswith(seg_dir + os.sep):
        raise ValueError(f"deep store returned an escaping file name {rel!r}")
    return dst


class HttpSegmentFetcher(PinotFS):
    """``http(s)://``, read only (ref: HttpSegmentFetcher): GET
    ``<url>/__files__`` for the segment's file names, then
    ``<url>/<name>`` for each."""

    scheme = "http"

    def exists(self, uri: str) -> bool:
        try:
            urllib.request.urlopen(f"{uri}/__files__", timeout=10).read()
            return True
        except OSError:     # urllib's URLError and HTTPError among them
            return False

    def list_files(self, uri: str) -> List[str]:
        with urllib.request.urlopen(f"{uri}/__files__", timeout=30) as r:
            return json.loads(r.read().decode())

    def delete(self, uri: str) -> None:
        raise NotImplementedError("http deep store is read-only")

    def copy_from_local_dir(self, local_dir: str, uri: str) -> None:
        raise NotImplementedError("http deep store is read-only")

    def copy_to_local_dir(self, uri: str, local_dir: str) -> str:
        name = uri.rstrip("/").rsplit("/", 1)[-1]
        seg_dir = os.path.abspath(os.path.join(local_dir, name))
        os.makedirs(seg_dir, exist_ok=True)
        for rel in self.list_files(uri):
            dst = _inside(seg_dir, rel)
            os.makedirs(os.path.dirname(dst), exist_ok=True)
            with urllib.request.urlopen(f"{uri}/{rel}", timeout=60) as r, \
                    open(dst, "wb") as f:
                shutil.copyfileobj(r, f)
        return seg_dir


_REGISTRY: Dict[str, Callable[[], PinotFS]] = {
    "file": LocalPinotFS,
    "": LocalPinotFS,
    "http": HttpSegmentFetcher,
    "https": HttpSegmentFetcher,
}


def register_fs(scheme: str, ctor: Callable[[], PinotFS]) -> None:
    _REGISTRY[scheme.lower()] = ctor


def get_fs(uri: str) -> PinotFS:
    """The filesystem of ``uri``'s scheme; raises ``ValueError`` for a
    scheme nothing registered (``memory://`` is a cluster's
    ``MemoryDeepStore``, not a filesystem)."""
    scheme = urllib.parse.urlparse(uri).scheme.lower()
    if scheme == "s3" and "s3" not in _REGISTRY:
        from pinot_tpu_torch.spi import s3fs  # noqa: F401 (registers s3)
    ctor = _REGISTRY.get(scheme)
    if ctor is None:
        raise ValueError(f"no PinotFS registered for scheme {scheme!r} "
                         f"(registered: {sorted(_REGISTRY)})")
    return ctor()


def file_url(segment_dir: str) -> str:
    """The ``file://`` location of a local segment directory."""
    return f"file://{os.path.abspath(segment_dir)}"


def _copy_in(fs: PinotFS, uri: str, local_dir: str,
             decrypt: Optional[Callable[[str], None]] = None) -> str:
    """``fs``'s segment at ``uri`` copied to ``local_dir/<name>`` through a
    temporary directory, each file of which ``decrypt`` rewrites, renamed
    into place (the old copy goes aside first: a replica that mapped its
    files keeps reading them)."""
    os.makedirs(local_dir, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix=".fetch.", dir=local_dir)
    try:
        got = fs.copy_to_local_dir(uri, tmp)
        if os.path.abspath(os.path.dirname(got)) != os.path.abspath(tmp):
            shutil.copytree(got, os.path.join(tmp, os.path.basename(
                got.rstrip("/"))))      # a local store served in place
            got = os.path.join(tmp, os.path.basename(got.rstrip("/")))
        if decrypt is not None:
            for root, _dirs, files in os.walk(got):
                for f in files:
                    decrypt(os.path.join(root, f))
        dst = os.path.join(local_dir, os.path.basename(got))
        if os.path.exists(dst):
            old = tempfile.mkdtemp(prefix=".old.", dir=local_dir)
            os.replace(dst, os.path.join(old, os.path.basename(dst)))
            shutil.rmtree(old, ignore_errors=True)
        os.replace(got, dst)
        return dst
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def fetch_segment(download_url: str, local_dir: Optional[str] = None,
                  retries: int = FETCH_ATTEMPTS,
                  backoff_s: float = FETCH_BACKOFF_S,
                  crypter: Optional[str] = None) -> str:
    """Resolve a segment's download URL to a local segment directory (the
    server's download from the deep store, JAX :156), trying ``retries``
    times with a wait of ``backoff_s`` that doubles; with ``crypter`` the
    registered crypter of that name decrypts every file of the local
    copy. A remote scheme, or a crypter, needs ``local_dir``."""
    from pinot_tpu_torch.spi.retry import ExponentialBackoffRetryPolicy

    fs = get_fs(download_url)       # an unknown scheme fails at once
    local = isinstance(fs, LocalPinotFS)
    if local_dir is None and (crypter or not local):
        raise ValueError(f"fetching {download_url!r} "
                         f"{'with a crypter' if crypter else ''} "
                         "needs a local directory")
    if crypter:
        from pinot_tpu_torch.spi.crypt import get_crypter

        c = get_crypter(crypter)    # an unknown crypter fails at once

        def fetch() -> str:
            return _copy_in(fs, download_url, local_dir, c.decrypt)
    elif local:
        def fetch() -> str:
            return fs.copy_to_local_dir(download_url, local_dir)
    else:
        def fetch() -> str:
            return _copy_in(fs, download_url, local_dir)
    # a ValueError (an escaping name, a bad config) is permanent and never
    # retried: the policy's default gate
    return ExponentialBackoffRetryPolicy(
        max_attempts=max(retries, 1), initial_delay_ms=backoff_s * 1e3,
        randomize=False).attempt(fetch)


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
           "LocalPinotFS", "HttpSegmentFetcher", "register_fs", "get_fs",
           "file_url", "fetch_segment"]

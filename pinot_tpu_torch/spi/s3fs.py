"""The S3 deep store: the S3 REST API signed with AWS Signature Version 4.

Counterpart of ``pinot_tpu/spi/s3fs.py`` (JAX :38-340; the reference's
``S3PinotFS``), without an AWS SDK: ListObjectsV2 (following its
pagination), GetObject, HeadObject, PutObject and DeleteObject on
path-style URLs (``endpoint/bucket/key``), each request signed by
``sign_request`` (the HMAC-SHA256 chain over the canonical request; its
headers are JAX's for the same request and time). ``S3PinotFS`` is
registered under ``s3`` and configured from ``PINOT_S3_ENDPOINT``,
``AWS_ACCESS_KEY_ID``, ``AWS_SECRET_ACCESS_KEY`` and ``AWS_REGION``. It
names no default endpoint: without one it raises ``ValueError`` (JAX
falls back to ``https://s3.amazonaws.com``), so nothing is sent to a host
nobody configured.

``MockS3Server`` is an in-process S3 endpoint over a dict that checks
every request's signature against the shared secret and answers 403 on a
mismatch, so a clock or header fault shows as 403, not as missing rows.
"""

from __future__ import annotations

import datetime
import hashlib
import hmac
import os
import urllib.error
import urllib.parse
import urllib.request
import xml.etree.ElementTree as ET
from typing import Dict, List, Optional, Tuple

from pinot_tpu_torch.common.netserver import listen
from pinot_tpu_torch.spi.filesystem import PinotFS, register_fs

_ALGO = "AWS4-HMAC-SHA256"


def _hmac(key: bytes, msg: str) -> bytes:
    return hmac.new(key, msg.encode("utf-8"), hashlib.sha256).digest()


def _sha256(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()


def signing_key(secret: str, date: str, region: str, service: str) -> bytes:
    """The SigV4 key derivation chain."""
    k = _hmac(("AWS4" + secret).encode("utf-8"), date)
    k = _hmac(k, region)
    k = _hmac(k, service)
    return _hmac(k, "aws4_request")


def sign_request(method: str, url: str, headers: Dict[str, str],
                 payload: bytes, access_key: str, secret_key: str,
                 region: str, now: Optional[datetime.datetime] = None
                 ) -> Dict[str, str]:
    """Add x-amz-date / x-amz-content-sha256 / Authorization (SigV4).
    Returns the full header map to send. Pure function of its inputs so
    the mock server can recompute and VERIFY the same signature."""
    u = urllib.parse.urlparse(url)
    now = now or datetime.datetime.now(datetime.timezone.utc)
    amz_date = now.strftime("%Y%m%dT%H%M%SZ")
    date = now.strftime("%Y%m%d")
    payload_hash = _sha256(payload)

    out = dict(headers)
    out["host"] = u.netloc
    out["x-amz-date"] = amz_date
    out["x-amz-content-sha256"] = payload_hash

    signed_names = sorted(k.lower() for k in out)
    canonical_headers = "".join(
        f"{k}:{out[_find(out, k)].strip()}\n" for k in signed_names)
    signed_headers = ";".join(signed_names)
    # query string: sorted by key, values URI-encoded
    q = urllib.parse.parse_qsl(u.query, keep_blank_values=True)
    canonical_query = "&".join(
        f"{urllib.parse.quote(k, safe='')}={urllib.parse.quote(v, safe='')}"
        for k, v in sorted(q))
    # canonical URI: the path AS SENT (already single-encoded by the
    # caller) — S3 explicitly does NOT double-encode, so quoting again
    # here would 403 any key containing a space/':'/unicode
    canonical = "\n".join([
        method, u.path or "/",
        canonical_query, canonical_headers, signed_headers, payload_hash])
    scope = f"{date}/{region}/s3/aws4_request"
    to_sign = "\n".join([_ALGO, amz_date, scope, _sha256(canonical.encode())])
    sig = hmac.new(signing_key(secret_key, date, region, "s3"),
                   to_sign.encode("utf-8"), hashlib.sha256).hexdigest()
    out["Authorization"] = (
        f"{_ALGO} Credential={access_key}/{scope}, "
        f"SignedHeaders={signed_headers}, Signature={sig}")
    return out


def _find(d: Dict[str, str], lower: str) -> str:
    for k in d:
        if k.lower() == lower:
            return k
    raise KeyError(lower)


class S3PinotFS(PinotFS):
    """Ref: S3PinotFS.java — the deep-store SPI over the S3 REST API."""

    scheme = "s3"

    def __init__(self, endpoint: Optional[str] = None,
                 access_key: Optional[str] = None,
                 secret_key: Optional[str] = None,
                 region: Optional[str] = None):
        endpoint = endpoint or os.environ.get("PINOT_S3_ENDPOINT")
        if not endpoint:
            raise ValueError("S3PinotFS needs an endpoint (the endpoint "
                             "argument or PINOT_S3_ENDPOINT)")
        self.endpoint = endpoint.rstrip("/")
        self.access_key = access_key or os.environ.get(
            "AWS_ACCESS_KEY_ID", "")
        self.secret_key = secret_key or os.environ.get(
            "AWS_SECRET_ACCESS_KEY", "")
        self.region = region or os.environ.get("AWS_REGION", "us-east-1")

    # -- request plumbing ---------------------------------------------------
    def _call(self, method: str, bucket: str, key: str = "",
              query: str = "", payload: bytes = b"") -> bytes:
        path = f"/{bucket}" + (f"/{urllib.parse.quote(key)}" if key else "")
        url = self.endpoint + path + (f"?{query}" if query else "")
        headers = sign_request(method, url, {}, payload,
                               self.access_key, self.secret_key, self.region)
        req = urllib.request.Request(url, data=payload or None,
                                     headers=headers, method=method)
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.read()

    def _list_page(self, bucket: str, prefix: str,
                   token: Optional[str]) -> Tuple[List[str], Optional[str]]:
        q = "list-type=2&prefix=" + urllib.parse.quote(prefix, safe="")
        if token:
            q += "&continuation-token=" + urllib.parse.quote(token, safe="")
        root = ET.fromstring(self._call("GET", bucket, query=q))
        ns = root.tag.split("}")[0] + "}" if root.tag.startswith("{") else ""
        keys = [c.findtext(f"{ns}Key") for c in root.iter(f"{ns}Contents")]
        truncated = (root.findtext(f"{ns}IsTruncated") or "").lower() \
            == "true"
        return keys, (root.findtext(f"{ns}NextContinuationToken")
                      if truncated else None)

    @staticmethod
    def _parse(uri: str) -> Tuple[str, str]:
        u = urllib.parse.urlparse(uri)
        return u.netloc, u.path.lstrip("/")

    # -- PinotFS surface ----------------------------------------------------
    def list_files(self, uri: str) -> List[str]:
        bucket, prefix = self._parse(uri)
        if prefix and not prefix.endswith("/"):
            prefix += "/"
        out: List[str] = []
        token: Optional[str] = None
        while True:  # follow ListObjectsV2 pagination to completion
            keys, token = self._list_page(bucket, prefix, token)
            out.extend(keys)
            if token is None:
                return out

    def exists(self, uri: str) -> bool:
        try:
            return bool(self.list_files(uri)) or self._head(uri)
        except urllib.error.HTTPError:
            return False

    def _head(self, uri: str) -> bool:
        bucket, key = self._parse(uri)
        try:
            self._call("HEAD", bucket, key)  # no body transfer
            return True
        except urllib.error.HTTPError:
            return False

    def delete(self, uri: str) -> None:
        bucket, key = self._parse(uri)
        for obj_key in (self.list_files(uri) or [key]):
            self._call("DELETE", bucket, obj_key)

    def copy_from_local_dir(self, local_dir: str, uri: str) -> None:
        bucket, prefix = self._parse(uri)
        for root, _dirs, files in os.walk(local_dir):
            for f in files:
                full = os.path.join(root, f)
                rel = os.path.relpath(full, local_dir)
                with open(full, "rb") as fh:
                    self._call("PUT", bucket,
                               f"{prefix}/{rel}".replace(os.sep, "/"),
                               payload=fh.read())

    def copy_to_local_dir(self, uri: str, local_dir: str) -> str:
        bucket, prefix = self._parse(uri)
        name = prefix.rstrip("/").rsplit("/", 1)[-1]
        seg_dir = os.path.abspath(os.path.join(local_dir, name))
        base = prefix.rstrip("/") + "/"
        keys = self.list_files(uri)
        if not keys:
            # a typo'd/missing segment must FAIL, not return a path to a
            # directory that was never created
            raise FileNotFoundError(f"no objects under {uri!r}")
        for key in keys:
            rel = key[len(base):]
            if not rel or key.endswith("/"):
                continue  # directory-marker objects (console-created)
            dst = os.path.abspath(os.path.join(seg_dir, rel))
            if not dst.startswith(seg_dir + os.sep):
                raise ValueError(f"s3 listing returned an escaping key "
                                 f"{key!r}")
            os.makedirs(os.path.dirname(dst), exist_ok=True)
            with open(dst, "wb") as f:
                f.write(self._call("GET", bucket, key))
        return seg_dir


register_fs("s3", S3PinotFS)


# --------------------------------------------------------------------------
# in-test server (the minio analogue) — VERIFIES SigV4 before serving
# --------------------------------------------------------------------------

class MockS3Server:
    """Path-style S3 endpoint backed by a dict; every request's SigV4
    signature is recomputed from the shared secret and mismatches get 403,
    so the client-side signing is genuinely exercised."""

    def __init__(self, access_key: str = "test-access",
                 secret_key: str = "test-secret",
                 region: str = "us-east-1", port: int = 0):
        import threading
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        self.objects: Dict[str, bytes] = {}   # "bucket/key" -> bytes
        self.access_key, self.secret_key = access_key, secret_key
        self.region = region
        self.page_size = 1000  # tests shrink this to exercise pagination
        srv = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):
                pass

            def _verify(self, payload: bytes) -> bool:
                auth = self.headers.get("Authorization", "")
                amz_date = self.headers.get("x-amz-date", "")
                if not auth.startswith(_ALGO) or not amz_date:
                    return False
                now = datetime.datetime.strptime(
                    amz_date, "%Y%m%dT%H%M%SZ").replace(
                    tzinfo=datetime.timezone.utc)
                url = f"http://{self.headers['host']}{self.path}"
                want = sign_request(
                    self.command, url, {}, payload, srv.access_key,
                    srv.secret_key, srv.region, now=now)["Authorization"]
                return hmac.compare_digest(auth, want)

            def _respond(self, code: int, body: bytes = b"",
                         ctype: str = "application/xml") -> None:
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if not self._verify(b""):
                    return self._respond(403, b"<Error>SigMismatch</Error>")
                u = urllib.parse.urlparse(self.path)
                q = dict(urllib.parse.parse_qsl(u.query))
                bucket = u.path.lstrip("/").split("/", 1)[0]
                if "list-type" in q:
                    prefix = q.get("prefix", "")
                    keys = sorted(
                        k.split("/", 1)[1] for k in srv.objects
                        if k.startswith(f"{bucket}/")
                        and k.split("/", 1)[1].startswith(prefix))
                    start = q.get("continuation-token", "")
                    if start:
                        keys = [k for k in keys if k > start]
                    page = keys[:srv.page_size]
                    truncated = len(keys) > len(page)
                    items = "".join(
                        f"<Contents><Key>{k}</Key></Contents>" for k in page)
                    extra = (f"<IsTruncated>true</IsTruncated>"
                             f"<NextContinuationToken>{page[-1]}"
                             f"</NextContinuationToken>" if truncated
                             else "<IsTruncated>false</IsTruncated>")
                    return self._respond(
                        200, (f"<ListBucketResult>{items}{extra}"
                              f"</ListBucketResult>").encode())
                key = urllib.parse.unquote(
                    u.path.lstrip("/").split("/", 1)[1])
                obj = srv.objects.get(f"{bucket}/{key}")
                if obj is None:
                    return self._respond(404, b"<Error>NoSuchKey</Error>")
                return self._respond(200, obj, "binary/octet-stream")

            def do_HEAD(self):
                if not self._verify(b""):
                    return self._respond(403)
                u = urllib.parse.urlparse(self.path)
                bucket, key = u.path.lstrip("/").split("/", 1)
                present = f"{bucket}/{urllib.parse.unquote(key)}" \
                    in srv.objects
                return self._respond(200 if present else 404)

            def do_PUT(self):
                n = int(self.headers.get("Content-Length") or 0)
                payload = self.rfile.read(n)
                if not self._verify(payload):
                    return self._respond(403, b"<Error>SigMismatch</Error>")
                u = urllib.parse.urlparse(self.path)
                bucket, key = u.path.lstrip("/").split("/", 1)
                srv.objects[f"{bucket}/{urllib.parse.unquote(key)}"] = payload
                return self._respond(200)

            def do_DELETE(self):
                if not self._verify(b""):
                    return self._respond(403, b"<Error>SigMismatch</Error>")
                u = urllib.parse.urlparse(self.path)
                bucket, key = u.path.lstrip("/").split("/", 1)
                srv.objects.pop(f"{bucket}/{urllib.parse.unquote(key)}", None)
                return self._respond(204)

        self._httpd = listen(ThreadingHTTPServer, ("127.0.0.1", port),
                             Handler)
        self.port = self._httpd.server_port
        self.endpoint = f"http://127.0.0.1:{self.port}"
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True, name="mock-s3")

    def start(self) -> "MockS3Server":
        self._thread.start()
        return self

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()

"""Python client: broker connection + result-set model.

Counterpart of ``pinot_tpu/client.py`` (a copy): ``Connection``,
``ResultSetGroup``, ``DynamicBrokerSelector``, ``connect`` and
``connect_with_controller`` over any broker's ``POST /query/sql``.

Re-design of the reference's java client
(``pinot-clients/pinot-java-client/.../Connection.java`` +
``JsonAsyncHttpPinotClientTransport.java`` + ``ResultSetGroup``): a
connection holds one or more broker URLs (round-robin, the static
broker-selector mode; ZK-dynamic selection maps to watching the cluster
state store), posts SQL to ``POST /query/sql``, and wraps the JSON
response in the same ResultSetGroup/ResultSet accessors the java client
exposes — so reference client code translates line for line::

    conn = connect(["localhost:8099"])
    results = conn.execute("SELECT count(*) FROM baseballStats")
    results.result_set.get_long(0, 0)
"""

from __future__ import annotations

import itertools
import json
import time
import urllib.error
import urllib.request

from typing import Any, Dict, List, Optional, Sequence


class PinotClientError(Exception):
    """Transport failures and server-side query exceptions
    (ref: PinotClientException)."""


class ResultSet:
    """One result table (ref: ResultTableResultSet)."""

    def __init__(self, result_table: Dict[str, Any]):
        schema = result_table.get("dataSchema", {})
        self.column_names: List[str] = schema.get("columnNames", [])
        self.column_types: List[str] = schema.get("columnDataTypes", [])
        self.rows: List[List[Any]] = result_table.get("rows", [])

    @property
    def row_count(self) -> int:
        return len(self.rows)

    @property
    def column_count(self) -> int:
        return len(self.column_names)

    def get_value(self, row: int, col: int) -> Any:
        return self.rows[row][col]

    def get_int(self, row: int, col: int) -> int:
        return int(self.rows[row][col])

    get_long = get_int

    def get_double(self, row: int, col: int) -> float:
        return float(self.rows[row][col])

    def get_string(self, row: int, col: int) -> str:
        return str(self.rows[row][col])

    def __iter__(self):
        return iter(self.rows)


class ResultSetGroup:
    """The parsed broker response (ref: ResultSetGroup.java)."""

    def __init__(self, response: Dict[str, Any]):
        self.raw = response
        rt = response.get("resultTable")
        self.result_set: Optional[ResultSet] = (
            ResultSet(rt) if rt is not None else None)
        self.exceptions: List[Dict[str, Any]] = \
            response.get("exceptions", [])

    @property
    def result_set_count(self) -> int:
        return 1 if self.result_set is not None else 0

    def get_result_set(self, index: int = 0) -> ResultSet:
        if index != 0 or self.result_set is None:
            raise IndexError(f"no result set {index}")
        return self.result_set

    # query execution stats (ref: ExecutionStats)
    @property
    def stats(self) -> Dict[str, Any]:
        return {k: v for k, v in self.raw.items()
                if k not in ("resultTable", "exceptions")}


def _normalize_url(url: str) -> str:
    if not url.startswith(("http://", "https://")):
        url = "http://" + url
    return url.rstrip("/")


class DynamicBrokerSelector:
    """Live broker discovery from the controller's cluster state
    (ref: DynamicBrokerSelector — the java client watches ZK's broker
    external view; here the controller's /instances resource serves the
    same list). Results cache for ``refresh_s``; a controller outage or a
    bad response falls back to the last good list rather than erroring."""

    def __init__(self, controller_url: str, refresh_s: float = 10.0,
                 timeout_s: float = 10.0):
        self.controller_url = _normalize_url(controller_url)
        self.refresh_s = refresh_s
        self.timeout_s = timeout_s
        self._cached: List[str] = []
        self._fetched_at = 0.0

    def brokers(self, force: bool = False) -> List[str]:
        if (not force and self._cached
                and time.time() - self._fetched_at < self.refresh_s):
            return self._cached
        try:
            with urllib.request.urlopen(f"{self.controller_url}/instances",
                                        timeout=self.timeout_s) as r:
                payload = json.loads(r.read().decode("utf-8"))
        except (OSError, ValueError):
            return self._cached  # controller down: last good list serves
        urls = [f"http://{i.get('host', 'localhost')}:{i['port']}"
                for i in payload.get("instances", [])
                if i.get("type", "").upper().startswith("BROKER")
                and i.get("alive", True) and i.get("port")]
        if urls:
            self._cached = urls
            self._fetched_at = time.time()
        return self._cached


class Connection:
    """Ref: Connection.java — execute() round-robins the broker list,
    failing over to the next broker on transport errors (``retries``
    attempts total; broker-side query errors are NOT retried)."""

    def __init__(self, broker_urls: Sequence[str] = (),
                 timeout_s: float = 60.0,
                 fail_on_exceptions: bool = True,
                 selector: Optional[DynamicBrokerSelector] = None,
                 retries: int = 3, backoff_s: float = 0.1):
        if not broker_urls and selector is None:
            raise ValueError("broker urls or a broker selector is required")
        self._static = [self._normalize(u) for u in broker_urls]
        self._selector = selector
        self._rr = itertools.count()
        self.timeout_s = timeout_s
        self.fail_on_exceptions = fail_on_exceptions
        self.retries = max(retries, 1)
        self.backoff_s = backoff_s

    _normalize = staticmethod(_normalize_url)

    def _broker_list(self, force_refresh: bool = False) -> List[str]:
        if self._selector is not None:
            dynamic = self._selector.brokers(force=force_refresh)
            if dynamic:
                return dynamic
        return self._static

    def execute(self, sql: str) -> ResultSetGroup:
        last: Optional[Exception] = None
        for attempt in range(self.retries):
            brokers = self._broker_list(force_refresh=attempt > 0)
            if not brokers:
                raise PinotClientError("no live brokers discovered")
            broker = brokers[next(self._rr) % len(brokers)]
            try:
                return self._post(broker, sql)
            except PinotClientError:
                raise  # broker reached; its answer is final
            except OSError as e:
                last = e  # unreachable: fail over to the next broker
                if attempt + 1 < self.retries:
                    time.sleep(self.backoff_s * (2 ** attempt))
        raise PinotClientError(
            f"all brokers unreachable after {self.retries} attempts: "
            f"{last}") from last

    def _post(self, broker: str, sql: str) -> ResultSetGroup:
        body = json.dumps({"sql": sql}).encode("utf-8")
        req = urllib.request.Request(
            f"{broker}/query/sql", data=body,
            headers={"Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(req, timeout=self.timeout_s) as r:
                payload = json.loads(r.read().decode("utf-8"))
        except urllib.error.HTTPError as e:
            # reached the broker, got an error status: surface the body
            detail = ""
            try:
                detail = e.read().decode("utf-8", "replace")[:500]
            except OSError:
                pass
            raise PinotClientError(
                f"broker {broker} returned {e.code}: {detail}") from e
        except ValueError as e:  # JSONDecodeError: 200 with a non-JSON body
            raise PinotClientError(
                f"broker {broker} returned a non-JSON response: {e}") from e
        group = ResultSetGroup(payload)
        if self.fail_on_exceptions and group.exceptions:
            raise PinotClientError(
                f"query failed: {group.exceptions[:3]}")
        return group


def connect(broker_urls: Sequence[str], **kw) -> Connection:
    """Ref: ConnectionFactory.fromHostList."""
    return Connection(broker_urls, **kw)


def connect_with_controller(controller_url: str, **kw) -> Connection:
    """Ref: ConnectionFactory.fromZookeeper — dynamic broker discovery
    from the cluster's authority instead of a static host list."""
    return Connection(selector=DynamicBrokerSelector(controller_url), **kw)

"""Access control SPI + basic-auth implementation.

Counterpart of ``pinot_tpu/spi/auth.py`` (a copy), which the REST
routers (``transport/rest.py``) and the broker's per-table check read.

Re-design of the reference's auth stack
(``pinot-broker/.../broker/AccessControlFactory.java`` and the basic-auth
principals of ``pinot-common/.../auth/BasicAuthPrincipal.java``): an
``AccessControl`` interface authenticates a request's headers to a
principal and authorizes (table, access-type) pairs against it. The
default is allow-all; ``BasicAuthAccessControl`` guards REST surfaces with
HTTP Basic credentials and optional per-principal table/permission scoping.
"""

from __future__ import annotations

import base64
import hmac

from dataclasses import dataclass, field
from typing import Dict, List, Mapping, Optional

from pinot_tpu_torch.spi.table import raw_table_name

READ = "READ"
WRITE = "WRITE"


@dataclass
class Principal:
    """Ref: BasicAuthPrincipal — name + scoped tables/permissions."""

    name: str
    password: str = ""
    tables: List[str] = field(default_factory=list)       # [] = all tables
    permissions: List[str] = field(default_factory=list)  # [] = all perms

    def allows(self, table: Optional[str], access_type: str) -> bool:
        """``table=None`` checks only permissions — callers that could not
        resolve a table must fail closed themselves for scoped principals.
        (The query route never passes None: the broker authorizes the
        PARSED table, Broker.handle_sql; admin routes extract the table
        from the route path/body, rest._Api._dispatch.)"""
        if self.permissions and access_type.upper() not in (
                p.upper() for p in self.permissions):
            return False
        if table and self.tables:
            return table in self.tables or raw_table_name(table) in self.tables
        return True


class AccessControl:
    """The SPI: override both methods."""

    def authenticate(self, headers: Mapping[str, str]) -> Optional[Principal]:
        raise NotImplementedError

    def has_access(self, principal: Optional[Principal],
                   table: Optional[str], access_type: str = READ) -> bool:
        raise NotImplementedError


class AllowAllAccessControl(AccessControl):
    """Default: open cluster (ref: AllowAllAccessControlFactory)."""

    def authenticate(self, headers):
        return Principal("anonymous")

    def has_access(self, principal, table, access_type=READ):
        return True


class BasicAuthAccessControl(AccessControl):
    """HTTP Basic over a static principal list
    (ref: BasicAuthAccessControlFactory)."""

    def __init__(self, principals: List[Principal]):
        self._by_token: Dict[str, Principal] = {}
        for p in principals:
            token = base64.b64encode(
                f"{p.name}:{p.password}".encode("utf-8")).decode("ascii")
            self._by_token[token] = p

    def authenticate(self, headers):
        auth = None
        for k, v in headers.items():
            if k.lower() == "authorization":
                auth = v
                break
        if not auth or not auth.startswith("Basic "):
            return None
        token = auth[len("Basic "):].strip()
        for known, principal in self._by_token.items():
            # constant-time compare: no early-exit credential probing
            if hmac.compare_digest(known, token):
                return principal
        return None

    def has_access(self, principal, table, access_type=READ):
        return principal is not None and principal.allows(table, access_type)


def access_control_from_config(cfg: Optional[Dict]) -> AccessControl:
    """Factory (ref: AccessControlFactory.fromConfiguration). Config shape:
    ``{"type": "basic", "principals": [{"username", "password",
    "tables": [...], "permissions": [...]}]}``; absent/"allowAll" -> open."""
    if not cfg or str(cfg.get("type", "allowAll")).lower() in (
            "allowall", "none"):
        return AllowAllAccessControl()
    if str(cfg["type"]).lower() == "basic":
        principals = [Principal(d["username"], d.get("password", ""),
                                list(d.get("tables") or []),
                                list(d.get("permissions") or []))
                      for d in cfg.get("principals", [])]
        return BasicAuthAccessControl(principals)
    raise ValueError(f"unknown access control type {cfg.get('type')!r}")

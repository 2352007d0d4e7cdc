"""Tiered storage: segments move by age to servers of a tier's tag.

Counterpart of ``pinot_tpu/controller/tiers.py`` (the reference's
``TierConfig``, ``TimeBasedTierSegmentSelector`` and the controller's
``SegmentRelocator``): a table declares tiers, each taking the segments
older than its threshold to the servers that carry its tag; the
relocator rewrites the IdealState entries of the segments whose
instances are not on their tier, and the servers fetch and drop as the
new map says (a server that loses a segment evicts it from the card, one
that gains it stages it).

Age is counted from the segment's push time (else its creation time),
as in the JAX package.
"""

from __future__ import annotations

import re
import time
import zlib

from dataclasses import dataclass
from typing import Dict, List, Optional

from pinot_tpu_torch.controller.state import ONLINE

_AGE_RE = re.compile(r"^(\d+)\s*(ms|s|m|h|d)$", re.I)
_UNIT_MS = {"ms": 1, "s": 1000, "m": 60_000, "h": 3_600_000,
            "d": 86_400_000}


def parse_age_ms(text: str) -> int:
    m = _AGE_RE.match(str(text).strip())
    if not m:
        raise ValueError(f"bad segmentAge {text!r} (want e.g. '7d', '24h')")
    return int(m.group(1)) * _UNIT_MS[m.group(2).lower()]


@dataclass
class TierConfig:
    """One tier (the reference's TierConfig JSON layout)."""

    name: str
    segment_age: str = "0d"            # segments OLDER than this belong
    server_tag: str = "DefaultTenant"
    segment_selector_type: str = "time"
    storage_type: str = "pinot_server"

    def to_dict(self) -> Dict:
        return {"name": self.name, "segmentSelectorType":
                self.segment_selector_type, "segmentAge": self.segment_age,
                "storageType": self.storage_type,
                "serverTag": self.server_tag}

    @classmethod
    def from_dict(cls, d: Dict) -> "TierConfig":
        return cls(name=d["name"],
                   segment_age=d.get("segmentAge", "0d"),
                   server_tag=d.get("serverTag", "DefaultTenant"),
                   segment_selector_type=d.get("segmentSelectorType", "time"),
                   storage_type=d.get("storageType", "pinot_server"))


def target_tier(tiers: List[TierConfig], age_ms: int) -> Optional[TierConfig]:
    """The time tier with the largest threshold the age reaches (the most
    specific tier wins)."""
    best: Optional[TierConfig] = None
    best_age = -1
    for t in tiers:
        if t.segment_selector_type.lower() != "time":
            continue
        thresh = parse_age_ms(t.segment_age)
        if age_ms >= thresh and thresh > best_age:
            best = t
            best_age = thresh
    return best


class SegmentRelocator:
    """The controller's periodic relocation task."""

    def __init__(self, store):
        self.store = store

    def relocate_table(self, table: str,
                       now_ms: Optional[int] = None) -> List[str]:
        """-> the segments whose IdealState entry moved to their tier's
        servers. A segment whose tier no live server carries stays where
        it is."""
        cfg = self.store.get_table_config(table)
        tiers = [TierConfig.from_dict(d)
                 for d in (cfg.tier_configs or [])] if cfg else []
        if not tiers:
            return []
        now = int(time.time() * 1000) if now_ms is None else now_ms
        servers_by_tag: Dict[str, List[str]] = {}
        for inst in self.store.instances("SERVER"):
            if not inst.alive:
                continue
            for tag in inst.tags:
                servers_by_tag.setdefault(tag, []).append(inst.instance_id)
        replication = cfg.replication
        moved: List[str] = []

        def apply(ideal):
            # under the store's lock: a segment pushed meanwhile stays in
            # the map
            moved.clear()
            ideal = dict(ideal or {})
            for segment, inst_map in list(ideal.items()):
                md = self.store.get_segment_metadata(table, segment)
                if md is None or md.status != ONLINE:
                    continue
                ts = md.push_time_ms or md.creation_time_ms
                if not ts:
                    continue
                tier = target_tier(tiers, now - ts)
                if tier is None:
                    continue
                pool = sorted(servers_by_tag.get(tier.server_tag, []))
                if not pool:
                    continue
                if set(inst_map) <= set(pool):
                    continue    # already on its tier
                n = min(replication, len(pool))
                # a stable spread: a crc32 offset into the pool (hash() is
                # salted per process)
                start = zlib.crc32(segment.encode("utf-8")) % len(pool)
                chosen = [pool[(start + i) % len(pool)] for i in range(n)]
                ideal[segment] = {inst: ONLINE for inst in chosen}
                moved.append(segment)
            return ideal

        self.store.update_ideal_state(table, apply)
        return list(moved)

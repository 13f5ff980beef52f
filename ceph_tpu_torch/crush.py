"""CRUSH hierarchy: bucket tree, straw2 at every level, multi-step
rules — the src/crush analog (crush/crush.h:230 ``crush_bucket``,
mapper.c:826-2016 ``crush_do_rule``, builder.c map building,
CrushWrapper insert/move/reweight).

The flat straw2 map (placement.py) remains the degenerate case; this
module adds what it could not express:

- a **bucket tree** with arbitrary type levels (osd < host < rack <
  root by default), weights summing up the tree, built incrementally
  from device locations (``CrushWrapper::insert_item`` semantics);
- **multi-step rules**: ``take <bucket>``, ``choose firstn <n> type
  <t>``, ``chooseleaf firstn <n> type <t>``, ``emit`` — the working
  vector threads through the steps exactly like ``crush_do_rule``'s;
- **straw2 descent** with collision retries: at each level every
  child draws ``ln(u(key, child, r)) / weight`` and the max wins —
  weight-proportional, and reweighting moves only the items that now
  draw higher (CRUSH's minimal-movement property), now per level;
- **failure domains**: ``chooseleaf firstn 0 type rack`` spreads the
  k+m shards across racks, one leaf under each — a whole-rack loss
  degrades every PG by at most the shards it hosted there;
- **LRC locality**: a two-level rule (``choose`` locality buckets,
  ``chooseleaf`` within each) places each LRC layer group inside one
  locality bucket (ErasureCodeLrc.h crush-locality).

Hash discipline matches placement.py: the splitmix64-based
``stable_hash``, frozen forever by golden tests — determinism within
THIS framework is the contract, not rjenkins bit-compatibility.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

from .placement import Device, _hash01

#: local retries per selection slot before giving up on distinctness
#: (choose_total_tries role, crush/mapper.c)
TOTAL_TRIES = 50

#: conventional type order, least to most aggregated; any type name
#: is allowed in buckets/rules — this only orders `osd tree` output
DEFAULT_TYPES = ("osd", "host", "rack", "row", "room", "root")


@dataclass
class Bucket:
    """One interior node (struct crush_bucket, straw2 only)."""

    name: str
    btype: str
    children: list[str | int] = field(default_factory=list)
    parent: str | None = None


def validate_rule(steps) -> tuple:
    """Normalize + validate rule steps; raises ValueError on anything
    run_rule would crash on (malformed control-plane input must fail
    at install time, not poison placement forever)."""
    norm = tuple(tuple(s) for s in steps)
    if not norm:
        raise ValueError("empty rule")
    if norm[0][:1] != ("take",):
        raise ValueError("rule must start with a take step")
    if norm[-1] != ("emit",):
        raise ValueError("rule must end with emit")
    if not any(
        s and s[0] in ("choose_firstn", "chooseleaf_firstn")
        for s in norm
    ):
        raise ValueError("rule selects nothing (no choose step)")
    for s in norm:
        if not s:
            raise ValueError("empty rule step")
        op = s[0]
        if op == "take":
            if len(s) != 2 or not isinstance(s[1], str):
                raise ValueError(f"take wants a bucket name: {s!r}")
        elif op in ("choose_firstn", "chooseleaf_firstn"):
            if (
                len(s) != 3
                or not isinstance(s[1], int)
                or s[1] < 0
                or not isinstance(s[2], str)
            ):
                raise ValueError(f"{op} wants (count, type): {s!r}")
        elif op == "emit":
            if len(s) != 1:
                raise ValueError(f"emit takes no arguments: {s!r}")
        else:
            raise ValueError(f"unknown rule step {op!r}")
    return norm


class CrushHierarchy:
    """Bucket tree + devices + rule execution (CrushWrapper role).

    ``strict`` controls conflicting-location handling: strict raises
    (the monitor validates operator input this way), non-strict keeps
    the first-seen parent (tolerant map decode — a historical map
    must never fail to load)."""

    def __init__(self, root: str = "default", strict: bool = True) -> None:
        self.root_name = root
        self.strict = strict
        self.buckets: dict[str, Bucket] = {
            root: Bucket(root, "root")
        }
        self.devices: dict[int, Device] = {}
        #: device id -> parent bucket name
        self._dev_parent: dict[int, str] = {}
        #: memoized subtree weights (cleared on any mutation)
        self._wcache: dict[str | int, float] = {}

    # -- building (builder.c / CrushWrapper::insert_item) ---------------
    def add_bucket(
        self, name: str, btype: str, parent: str | None = None
    ) -> Bucket:
        if name in self.buckets:
            b = self.buckets[name]
            if b.btype != btype:
                raise ValueError(
                    f"bucket {name!r} exists with type {b.btype!r}"
                )
            # re-link so a conflicting parent is detected (strict) or
            # ignored first-wins (tolerant) — not silently dropped
            self._link(b, parent or self.root_name)
            return b
        b = Bucket(name, btype)
        self.buckets[name] = b
        self._link(b, parent or self.root_name)
        return b

    def _link(self, bucket: Bucket, parent: str) -> None:
        if parent not in self.buckets:
            raise ValueError(f"no such parent bucket {parent!r}")
        if bucket.parent is not None and bucket.parent != parent:
            if self.strict:
                raise ValueError(
                    f"bucket {bucket.name!r} already under "
                    f"{bucket.parent!r}, conflicting location says "
                    f"{parent!r}"
                )
            return  # tolerant decode: first-seen parent wins
        bucket.parent = parent
        kids = self.buckets[parent].children
        if bucket.name not in kids:
            kids.append(bucket.name)

    def add_device(
        self, dev: Device, location: dict[str, str] | None = None
    ) -> None:
        """Insert a device at ``location`` (type -> bucket name, e.g.
        {"host": "h1", "rack": "r2"}), creating missing buckets chained
        in DEFAULT_TYPES order under the root — insert_item semantics."""
        self.devices[dev.id] = dev
        self._wcache.clear()
        loc = dict(location or {})
        # order the location levels least-aggregated first; unknown
        # types sort ALPHABETICALLY so the order is a function of the
        # location CONTENT — the monitor's strict validation pass and
        # the map rebuild must construct the identical tree no matter
        # what dict order each saw
        order = [t for t in DEFAULT_TYPES if t in loc] + sorted(
            t for t in loc if t not in DEFAULT_TYPES
        )
        if not order:
            self._dev_parent[dev.id] = self.root_name
            kids = self.buckets[self.root_name].children
            if dev.id not in kids:
                kids.append(dev.id)
            return
        # create/chain buckets from most-aggregated down
        parent = self.root_name
        for t in reversed(order):
            self.add_bucket(loc[t], t, parent)
            parent = loc[t]
        leaf_bucket = loc[order[0]]
        self._dev_parent[dev.id] = leaf_bucket
        kids = self.buckets[leaf_bucket].children
        if dev.id not in kids:
            kids.append(dev.id)

    def reweight(self, dev_id: int, weight: float) -> None:
        d = self.devices[dev_id]
        self.devices[dev_id] = Device(d.id, weight, d.zone)
        self._wcache.clear()

    # -- weights (summed up the tree, memoized per mutation epoch) ------
    def item_weight(self, item: str | int) -> float:
        w = self._wcache.get(item)
        if w is not None:
            return w
        if isinstance(item, int):
            d = self.devices.get(item)
            w = max(d.weight, 0.0) if d else 0.0
        else:
            b = self.buckets.get(item)
            w = (
                sum(self.item_weight(c) for c in b.children)
                if b is not None
                else 0.0
            )
        self._wcache[item] = w
        return w

    # -- straw2 ----------------------------------------------------------
    def _draw(self, key: tuple, item: str | int, trial: int) -> float:
        w = self.item_weight(item)
        if w <= 0:
            return -math.inf
        token = item if isinstance(item, int) else f"b:{item}"
        u = _hash01(*key, token, trial)
        return math.log(u) / w

    def _choose_child(
        self, key: tuple, bucket: Bucket, trial: int
    ) -> str | int | None:
        best, best_draw = None, -math.inf
        for c in bucket.children:
            d = self._draw(key, c, trial)
            if d > best_draw:
                best, best_draw = c, d
        return best if best_draw > -math.inf else None

    def _descend(
        self,
        key: tuple,
        start: str | int,
        target_type: str,
        trial: int,
    ) -> str | int | None:
        """Walk from ``start`` toward an item of ``target_type``
        (device when target_type == "osd"), one straw2 draw per
        level (crush_choose_firstn's recursion)."""
        cur: str | int = start
        for _depth in range(16):  # tree depth bound
            if isinstance(cur, int):
                return cur if target_type == "osd" else None
            if cur in self.buckets and self.buckets[cur].btype == target_type:
                return cur
            b = self.buckets.get(cur)
            if b is None:
                return None
            nxt = self._choose_child(key, b, trial)
            if nxt is None:
                return None
            cur = nxt
        return None

    def _choose_n(
        self,
        key: tuple,
        start: str | int,
        n: int,
        target_type: str,
        chooseleaf: bool,
        taken: set,
    ) -> list:
        """firstn selection of n distinct items of target_type below
        start; with chooseleaf, one distinct DEVICE under each chosen
        bucket is returned instead (chooseleaf_firstn)."""
        out: list = []
        chosen: set = set()  # intermediate-bucket distinctness
        for slot in range(n):
            pick = None
            for attempt in range(TOTAL_TRIES):
                trial = slot + n * attempt
                cand = self._descend(key, start, target_type, trial)
                if cand is None or cand in chosen:
                    continue
                if chooseleaf:
                    leaf = None
                    for lattempt in range(TOTAL_TRIES):
                        leaf_cand = self._descend(
                            (*key, "leaf"), cand, "osd",
                            slot + n * lattempt,
                        )
                        if leaf_cand is not None and leaf_cand not in taken:
                            leaf = leaf_cand
                            break
                    if leaf is None:
                        continue  # bucket has no usable leaf: re-draw
                    pick = leaf
                else:
                    if cand in taken:
                        continue
                    pick = cand
                chosen.add(cand)
                taken.add(pick)
                out.append(pick)
                break
            if pick is None:
                break  # undersized: ran out of distinct candidates
        return out

    # -- rules (crush_do_rule) -------------------------------------------
    def run_rule(
        self, rule: tuple, key: tuple | int, n: int
    ) -> list[int]:
        """Execute rule steps for selection key ``key`` wanting ``n``
        items. Steps (tuples):

            ("take", bucket_name)
            ("choose_firstn", count, type)      # count 0 => n
            ("chooseleaf_firstn", count, type)  # count 0 => n
            ("emit",)

        Returns device ids (in draw order — position is EC shard).
        A ``choose_firstn`` that selects buckets threads them as the
        working vector into the next step, splitting the remaining
        want across them (crush_do_rule's wv recursion)."""
        if isinstance(key, int):
            key = (key,)
        working: list[str | int] = []
        result: list[int] = []
        taken: set = set()
        for step in rule:
            op = step[0]
            if op == "take":
                working = [step[1]]
            elif op in ("choose_firstn", "chooseleaf_firstn"):
                count = step[1] or n
                ttype = step[2]
                leaf = op == "chooseleaf_firstn"
                nxt: list[str | int] = []
                for w in working:
                    nxt.extend(
                        self._choose_n(
                            tuple(key) + ((f"w:{w}",) if len(working) > 1 else ()),
                            w, count, ttype,
                            chooseleaf=leaf, taken=taken,
                        )
                    )
                working = nxt
            elif op == "emit":
                result.extend(
                    w for w in working if isinstance(w, int)
                )
                working = []
            else:
                raise ValueError(f"unknown rule step {op!r}")
        return result[:n] if n else result


def ec_rule(
    failure_domain: str = "host", root: str = "default"
) -> tuple:
    """The standard EC pool rule: spread k+m leaves across distinct
    failure-domain buckets (ErasureCode::create_rule,
    erasure-code/ErasureCode.cc:70)."""
    if failure_domain in ("", "osd"):
        return (("take", root), ("choose_firstn", 0, "osd"), ("emit",))
    return (
        ("take", root),
        ("chooseleaf_firstn", 0, failure_domain),
        ("emit",),
    )


def lrc_rule(
    groups: int,
    per_group: int,
    locality: str,
    failure_domain: str = "host",
    root: str = "default",
) -> tuple:
    """LRC crush-locality rule: pick ``groups`` locality buckets, then
    ``per_group`` leaves (across distinct failure domains) inside
    each — every layer group's chunks stay local to one bucket, so a
    local repair never crosses it (ErasureCodeLrc.h crush-locality)."""
    if failure_domain in ("", "osd") or failure_domain == locality:
        inner: tuple = ("choose_firstn", per_group, "osd")
    else:
        inner = ("chooseleaf_firstn", per_group, failure_domain)
    return (
        ("take", root),
        ("choose_firstn", groups, locality),
        inner,
        ("emit",),
    )

"""Write-ahead op log — the ``PGLog`` analog (osd/PGLog.{h,cc}).

The reference's per-PG log is the replayable journal that makes
recovery DELTA-shaped: a shard that missed some sub-writes (dropped
ack, brief outage) catches up by re-fetching only the extents written
since its last completed version, instead of a full backfill
(SURVEY.md §5.4; divergent-entry rollback/rollforward is the
``completed_to``/``pending_roll_forward`` machinery of ECCommon.h:500).

Here: the RMW pipeline appends one entry per client write (tid-ordered
— tids ARE the version numbers, the eversion analog) recording the
per-shard extents the write touched, and records per-shard acks.
``completed_to(shard)`` is the max contiguous acked tid;
``dirty_extents(shard)`` is the union of extents written past it —
exactly what delta recovery must rebuild. ``trim`` drops entries every
shard has completed (log bounded like the reference's
osd_min_pg_log_entries window).
"""

from __future__ import annotations

from dataclasses import dataclass, field

from .extents import ExtentSet


@dataclass
class LogEntry:
    """One client op (the pg_log_entry_t analog). ``delete`` entries
    (pg_log_entry_t::DELETE) touch every shard and supersede earlier
    writes of the oid for recovery purposes. ``xattrs`` records user-
    attr mutations (value None = removed) — they replicate to every
    shard, so replay needs them like data extents."""

    tid: int
    oid: str
    shard_extents: dict[int, ExtentSet] = field(default_factory=dict)
    delete: bool = False
    xattrs: "dict[str, bytes | None] | None" = None
    #: map epoch at append time; (epoch, tid) is the entry's eversion
    epoch: int = 0


class PGLog:
    def __init__(self, n_shards: int) -> None:
        self.n_shards = n_shards
        self.entries: list[LogEntry] = []  # tid-ascending
        self._acked: dict[int, set[int]] = {s: set() for s in range(n_shards)}
        self._completed: dict[int, int] = {s: 0 for s in range(n_shards)}
        self.tail = 0  # tids <= tail are trimmed

    # -- write path hooks ----------------------------------------------
    def append(
        self, tid: int, oid: str, shard_extents: dict[int, ExtentSet],
        epoch: int = 0,
        xattrs: "dict[str, bytes | None] | None" = None,
    ) -> None:
        """``xattrs`` may carry identity attrs (OI/HINFO) alongside
        the extents: a shard that misses a size-changing op (truncate,
        grow) with no replayable extents still needs the new OI — a
        stale size on a later primary takeover would clip the
        object."""
        if self.entries and tid <= self.entries[-1].tid:
            raise ValueError(f"non-monotonic log append: tid {tid}")
        self.entries.append(
            LogEntry(
                tid, oid,
                {s: es.copy() for s, es in shard_extents.items()},
                xattrs=dict(xattrs) if xattrs else None,
                epoch=epoch,
            )
        )

    def last_eversion(self, oid: str) -> "tuple[int, int] | None":
        """(epoch, tid) of the newest in-window entry touching the
        oid — the authoritative eversion as far as the log knows."""
        for e in reversed(self.entries):
            if e.oid == oid:
                return None if e.delete else (e.epoch, e.tid)
        return None

    def append_delete(self, tid: int, oid: str) -> None:
        """Record a whole-object remove: a shard that misses it would
        otherwise RESURRECT the object during delta recovery."""
        if self.entries and tid <= self.entries[-1].tid:
            raise ValueError(f"non-monotonic log append: tid {tid}")
        self.entries.append(LogEntry(tid, oid, {}, delete=True))

    def append_xattrs(
        self, tid: int, oid: str, xattrs: "dict[str, bytes | None]"
    ) -> None:
        """Record replicated-attr mutations by FULL attr key
        (u:/m:-prefixed; None = removal)."""
        if self.entries and tid <= self.entries[-1].tid:
            raise ValueError(f"non-monotonic log append: tid {tid}")
        self.entries.append(LogEntry(tid, oid, {}, xattrs=dict(xattrs)))

    def ack(self, shard: int, tid: int) -> None:
        """A shard durably applied its sub-write for ``tid``."""
        if tid <= self._completed[shard]:
            return  # already covered (e.g. a post-recovery rollforward)
        acked = self._acked[shard]
        acked.add(tid)
        # advance the contiguous frontier
        c = self._completed[shard]
        while (c + 1) in acked or self._is_gap(c + 1):
            if (c + 1) in acked:
                acked.discard(c + 1)
            c += 1
        self._completed[shard] = c

    def _is_gap(self, tid: int) -> bool:
        """Tids the log never saw (aborted writes) don't block the
        frontier."""
        if tid > (self.entries[-1].tid if self.entries else self.tail):
            return False
        if tid <= self.tail:
            return True
        return all(e.tid != tid for e in self.entries)

    # -- recovery surface ----------------------------------------------
    def completed_to(self, shard: int) -> int:
        return self._completed[shard]

    def head(self) -> int:
        return self.entries[-1].tid if self.entries else self.tail

    def dirty_extents(self, shard: int) -> dict[str, ExtentSet]:
        """Per-object extents this shard is missing: everything written
        past its contiguous frontier (the missing-set computation of
        PGLog::merge_log, as extents instead of whole objects). A
        delete entry resets the oid — only writes AFTER the last
        delete count (the object was recreated)."""
        frontier = self._completed[shard]
        out: dict[str, ExtentSet] = {}
        for e in self.entries:
            if e.tid <= frontier:
                continue
            if e.delete:
                out.pop(e.oid, None)
                continue
            es = e.shard_extents.get(shard)
            if not es:
                continue
            acc = out.setdefault(e.oid, ExtentSet())
            for start, end in es:
                acc.insert(start, end - start)
        return out

    def dirty_deletes(self, shard: int) -> set[str]:
        """Oids whose FINAL state past the shard's frontier is
        'removed' — recovery must apply the delete, not rebuild data."""
        frontier = self._completed[shard]
        out: set[str] = set()
        for e in self.entries:
            if e.tid <= frontier:
                continue
            if e.delete:
                out.add(e.oid)
            elif e.shard_extents.get(shard):
                out.discard(e.oid)  # recreated after the delete
        return out

    def dirty_xattrs(
        self, shard: int
    ) -> "dict[str, dict[str, bytes | None]]":
        """Per-object FINAL user-attr state this shard is missing
        (entries past its frontier; a delete resets the object)."""
        frontier = self._completed[shard]
        out: dict[str, dict[str, bytes | None]] = {}
        for e in self.entries:
            if e.tid <= frontier:
                continue
            if e.delete:
                out.pop(e.oid, None)
                continue
            if e.xattrs:
                out.setdefault(e.oid, {}).update(e.xattrs)
        return out

    def mark_recovered(self, shard: int, up_to: int | None = None) -> None:
        """Delta recovery finished: the shard now reflects every write
        through ``up_to`` (default: the log head)."""
        target = self.head() if up_to is None else up_to
        self._completed[shard] = max(self._completed[shard], target)
        self._acked[shard] = {
            t for t in self._acked[shard] if t > target
        }

    def trim(self) -> int:
        """Drop entries all shards have completed; returns new tail
        (PGLog::trim)."""
        floor = min(self._completed.values())
        kept = [e for e in self.entries if e.tid > floor]
        trimmed = len(self.entries) - len(kept)
        self.entries = kept
        self.tail = max(self.tail, floor)
        return trimmed

    def __len__(self) -> int:
        return len(self.entries)

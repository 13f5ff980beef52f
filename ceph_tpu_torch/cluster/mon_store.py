"""Persistent monitor store — the mon MonitorDBStore role
(src/mon/MonitorDBStore.h: a RocksDB holding every Paxos-committed map
version; a restarting monitor replays to the exact committed state).

Backed by the shared ``store.kvstore.KeyValueDB`` (the RocksDBStore
analog), matching the reference's layout discipline:

- prefix ``I``: zero-padded epoch -> serialized ``Incremental`` (the
  paxos version rows);
- prefix ``F``: ``full`` -> latest full-map snapshot (the osdmap
  full_NNN row role; its epoch is decoded from the map itself) and
  ``max_pool_id`` -> the trimmed-history pool-id floor.

``trim`` keeps a bounded incremental window: it snapshots the current
full map and deletes incrementals below the floor — the mon's paxos
trim. Replay = full snapshot + incrementals; epochs are contiguous by
construction so the rebuilt map is bit-identical to the committed one.
The in-window incrementals feed the monitor's subscriber catch-up;
anything older falls back to the full map (Monitor.get_incrementals
returns None past the window).

Upgrades from the original format (one crc-framed append-only log of
incrementals) on first open: records import into KV rows and the
legacy file is removed once durable.
"""

from __future__ import annotations

import os

from ceph_tpu_torch.store import framed_log
from ceph_tpu_torch.store.kvstore import KeyValueDB

from .osdmap import Incremental, OSDMap

PREFIX_INCR = "I"
PREFIX_FULL = "F"

#: incremental window kept after a trim (the paxos/osdmap trim
#: analog; generous so daemon catch-up rarely needs the full-map
#: fallback)
DEFAULT_KEEP = 1024


def _ekey(epoch: int) -> str:
    return f"{epoch:016d}"


class MonStore:
    """Durable map-version store + replay."""

    def __init__(self, path: str, keep: int = DEFAULT_KEEP) -> None:
        # ``path`` names the LEGACY log file (mon/store.log); the KV
        # store lives beside it so existing cluster dirs upgrade in
        # place.
        self.path = path
        self.keep = keep
        root = os.path.dirname(path) or "."
        os.makedirs(root, exist_ok=True)
        self._kvdb = KeyValueDB(root, name="monstore")
        self._import_legacy()
        self._n_incr = sum(1 for _ in self._kvdb.iterate(PREFIX_INCR))

    def _import_legacy(self) -> None:
        if not os.path.exists(self.path):
            return
        payloads = framed_log.replay(self.path)
        if payloads:
            # refuse to clobber a populated KV store with older data
            # (crash window between import and legacy removal)
            last_epoch = Incremental.from_bytes(payloads[-1]).epoch
            newest = [k for k, _ in self._kvdb.iterate(PREFIX_INCR)]
            have = int(newest[-1]) if newest else -1
            if have < last_epoch:
                txn = self._kvdb.transaction()
                for payload in payloads:
                    incr = Incremental.from_bytes(payload)
                    txn.set(PREFIX_INCR, _ekey(incr.epoch), payload)
                self._kvdb.submit_transaction(txn)
                self._kvdb.compact()
        os.remove(self.path)

    # -- write side -----------------------------------------------------
    def append(self, incr: Incremental) -> None:
        txn = self._kvdb.transaction()
        txn.set(PREFIX_INCR, _ekey(incr.epoch), incr.to_bytes())
        self._kvdb.submit_transaction(txn)
        self._n_incr += 1
        # the bounded window must hold in a LONG-LIVED process, not
        # just across restarts: auto-trim once the rows reach twice
        # the keep target (replaying to get the current map is cheap
        # at this frequency)
        if self._n_incr >= 2 * self.keep:
            current, _ = self.replay()
            self.trim(current)

    def trim(self, current: OSDMap) -> int:
        """Snapshot ``current`` and drop incrementals older than the
        keep window below it; returns how many rows were dropped.

        The pool-id high-water mark of the trimmed records persists in
        the F prefix: a pool created AND deleted before the window
        must still never have its id reused (stale shard keys on disk
        encode only the pool id)."""
        floor = current.epoch - self.keep
        doomed = []
        max_pool = self.pool_id_floor()
        for k, payload in self._kvdb.iterate(
            PREFIX_INCR, end=_ekey(floor + 1)
        ):
            doomed.append(k)
            incr = Incremental.from_bytes(payload)
            for pool in incr.new_pools:
                max_pool = max(max_pool, pool.pool_id)
        txn = self._kvdb.transaction()
        txn.set(PREFIX_FULL, "full", current.to_bytes())
        txn.set(PREFIX_FULL, "max_pool_id", str(max_pool).encode())
        for k in doomed:
            txn.rmkey(PREFIX_INCR, k)
        self._kvdb.submit_transaction(txn)
        self._n_incr -= len(doomed)
        return len(doomed)

    def pool_id_floor(self) -> int:
        """Highest pool id recorded by trimmed-away history (0 when
        nothing was ever trimmed)."""
        raw = self._kvdb.get(PREFIX_FULL, "max_pool_id")
        return int(raw) if raw else 0

    # -- read side ------------------------------------------------------
    def replay(self) -> tuple[OSDMap, list[Incremental]]:
        """Rebuild the committed map + the in-window incremental
        history (feeds subscriber catch-up)."""
        m = OSDMap()
        full = self._kvdb.get(PREFIX_FULL, "full")
        if full is not None:
            m = OSDMap.from_bytes(full)
        incrs: list[Incremental] = []
        for _k, payload in self._kvdb.iterate(PREFIX_INCR):
            incr = Incremental.from_bytes(payload)
            incrs.append(incr)
            if incr.epoch > m.epoch:
                m = m.apply(incr)
        return m, incrs

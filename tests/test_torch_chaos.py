"""The port's RMW, read, recovery and deep scrub under seeded chaos
against ceph_tpu's, on the CPU (tolerance 0).

Mirrors ``tests/test_chaos.py``: the reference's harness (jerasure
EC(4,2) over MemStores, 80 seeded events of writes, model-checked reads,
shard kills, wiped-disk revives with backfill, one-shot ECInject read
errors and bit flips found by deep scrub and repaired) runs over each
package from the same seed. Each run holds its own model; then the two
runs' final stores (every shard's bytes and attrs), their model of
every object and ECInject's fire count are equal.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_dcn import time_limit  # noqa: E402
from test_torch_rmw import (  # noqa: E402,F401
    _clean_inject, PORT, REF, store_snapshot,
)

K, M = 4, 2
CHUNK = 4096
N_OBJECTS = 6
EVENTS = 80
MAX_SIZE = 3 * K * CHUNK  # keep each object <= 3 stripes


class ChaosHarness:
    """``tests/test_chaos.py``'s harness over one package (``pkg``, a
    ``test_torch_rmw`` namespace); the events, draws and checks are the
    reference's."""

    def __init__(self, pkg, seed: int) -> None:
        self.pkg = pkg
        self.rng = np.random.default_rng(seed)
        self.sinfo = pkg.StripeInfo(K, M, K * CHUNK)
        self.codec = pkg.registry.factory(
            "jerasure",
            {"technique": "reed_sol_van", "k": str(K), "m": str(M)},
            **pkg.kw,
        )
        self.backend = pkg.rmw.ShardBackend(
            {s: pkg.store.MemStore(f"osd.{s}") for s in range(K + M)}
        )
        self.rmw = pkg.rmw.RMWPipeline(self.sinfo, self.codec, self.backend)
        self.reads = pkg.read.ReadPipeline(
            self.sinfo, self.codec, self.backend, self.rmw.object_size
        )
        self.recovery = pkg.recovery.RecoveryBackend(
            self.sinfo,
            self.codec,
            self.backend,
            self.rmw.object_size,
            self.rmw.hinfo,
        )
        self.model: dict[str, bytearray] = {}

    # -- events --------------------------------------------------------
    def ev_write(self) -> None:
        oid = f"obj.{self.rng.integers(N_OBJECTS)}"
        cur = self.model.setdefault(oid, bytearray())
        offset = int(self.rng.integers(0, max(len(cur), 1) + CHUNK))
        length = int(self.rng.integers(1, 2 * CHUNK))
        if offset + length > MAX_SIZE:
            offset = max(0, MAX_SIZE - length)
        data = self.rng.integers(0, 256, length, np.uint8).tobytes()
        self.rmw.submit(oid, offset, data)
        if len(cur) < offset:
            cur.extend(b"\0" * (offset - len(cur)))
        cur[offset : offset + length] = data

    def ev_read(self) -> None:
        if not self.model:
            return
        oid = self.rng.choice(sorted(self.model))
        cur = self.model[oid]
        if not cur:
            return
        offset = int(self.rng.integers(0, len(cur)))
        length = int(self.rng.integers(1, len(cur) - offset + 1))
        try:
            got = self.reads.read_sync(oid, offset, length)
        except ValueError:
            # Transient: injected EIO + concurrent losses left < k
            # survivors; clients resend on EIO (Objecter behavior).
            got = self.reads.read_sync(oid, offset, length)
        assert got == bytes(cur[offset : offset + length]), (
            f"read mismatch on {oid} [{offset}, {offset + length}) with "
            f"down={sorted(self.backend.down_shards)}"
        )

    def ev_kill_shard(self) -> None:
        if len(self.backend.down_shards) >= M:
            return
        up = sorted(
            set(self.backend.stores) - self.backend.down_shards
        )
        shard = int(self.rng.choice(up))
        self.backend.down_shards.add(shard)

    def ev_revive_shard(self) -> None:
        if not self.backend.down_shards:
            return
        shard = int(self.rng.choice(sorted(self.backend.down_shards)))
        # The returning OSD lost its disk: wipe, backfill, then serve.
        self.backend.stores[shard] = self.pkg.store.MemStore(
            f"osd.{shard}.reborn")
        self.backend.down_shards.discard(shard)
        for oid in sorted(self.model):
            self._recover_retry(oid, shard)

    def _recover_retry(self, oid: str, shard: int) -> None:
        """Transient injected EIOs can momentarily leave < k survivors
        mid-backfill; the reference re-attempts recovery after errors
        clear (peering retry). Each attempt consumes one one-shot
        inject rule, so a handful of attempts always converges."""
        for attempt in range(4):
            try:
                self.recovery.recover_object(oid, {shard})
                return
            except ValueError:
                if attempt == 3:
                    raise

    def ev_inject_eio(self) -> None:
        if not self.model:
            return
        oid = self.rng.choice(sorted(self.model))
        shard = int(self.rng.integers(K + M))
        self.pkg.inject.ec_inject.read_error(
            oid, int(self.rng.integers(2)), duration=1, shard=shard
        )

    def ev_corrupt_and_scrub(self) -> None:
        """Flip a byte on a healthy shard of a scrubbable object, then
        prove scrub finds it and recovery repairs it."""
        candidates = [
            oid
            for oid in sorted(self.model)
            if self.model[oid]
            and (hi := self.rmw.hinfo(oid)) is not None
            and hi.get_total_chunk_size() > 0
        ]
        if not candidates or self.backend.down_shards:
            return
        oid = self.rng.choice(candidates)
        shard = int(self.rng.integers(K + M))
        store = self.backend.stores[shard]
        if not store.exists(oid) or store.stat(oid) == 0:
            return
        Transaction = self.pkg.store.Transaction
        pos = int(self.rng.integers(store.stat(oid)))
        byte = store.read(oid, pos, 1)
        store.queue_transactions(
            Transaction().write(oid, pos, bytes([byte[0] ^ 0x5A]))
        )
        res = self.scrub(oid)
        assert [e.shard for e in res.errors] == [shard], res.errors
        self.recovery.recover_object(oid, {shard})
        assert self.scrub(oid).ok

    def scrub(self, oid):
        return self.pkg.recovery.be_deep_scrub(
            self.sinfo, self.backend, oid, **self.pkg.kw)

    # -- schedule ------------------------------------------------------
    def run(self, events: int) -> None:
        weighted = (
            [self.ev_write] * 4
            + [self.ev_read] * 4
            + [self.ev_kill_shard] * 2
            + [self.ev_revive_shard] * 2
            + [self.ev_inject_eio] * 2
            + [self.ev_corrupt_and_scrub]
        )
        for _ in range(events):
            self.rng.choice(weighted)()
        self.final_check()

    def final_check(self) -> None:
        # Heal the pool, then verify every object under every
        # single-shard loss and a clean deep scrub.
        self.pkg.inject.ec_inject.clear_all()
        for shard in sorted(self.backend.down_shards):
            self.ev_revive_for(shard)
        for oid, cur in sorted(self.model.items()):
            if not cur:
                continue
            for lost in range(K + M):
                self.backend.down_shards = {lost}
                got = self.reads.read_sync(oid, 0, len(cur))
                assert got == bytes(cur), f"{oid} under loss of {lost}"
            self.backend.down_shards = set()

    def ev_revive_for(self, shard: int) -> None:
        self.backend.stores[shard] = self.pkg.store.MemStore(
            f"osd.{shard}.reborn")
        self.backend.down_shards.discard(shard)
        for oid in sorted(self.model):
            self._recover_retry(oid, shard)


@pytest.mark.parametrize("seed", [1, 7, 42])
def test_chaos_schedule(seed):
    runs = []
    with time_limit(120):
        for pkg in (REF, PORT):
            h = ChaosHarness(pkg, seed)
            h.run(EVENTS)
            runs.append((
                {s: store_snapshot(st) for s, st in h.backend.stores.items()},
                {oid: bytes(cur) for oid, cur in h.model.items()},
                pkg.inject.ec_inject.injected_count,
            ))
            pkg.inject.ec_inject.clear_all()
    assert runs[1] == runs[0]

"""Fault injection — the ``ECInject`` analog (osd/ECInject.{h,cc}).

A process-global registry of per-object (optionally per-shard) error
injections, consulted from the sub-read / sub-write dispatch paths
exactly where the reference hooks ``handle_sub_read`` /
``handle_sub_write``:

- read type 0: sub-read fails with EIO.
- read type 1: shard reports the object missing (ENOENT-alike) —
  exercises the same retry path with a different error class.
- read type 2: SILENT corruption — the sub-read succeeds but the
  returned shard payload has bytes flipped. Nothing errors at the
  transport: only an integrity tier (BlockStore csums at rest, deep
  scrub's HashInfo comparison, the client's content verify) can
  catch it — the bit-rot-on-the-wire / buggy-drive-firmware case.
- write type 0: the client write op fails before dispatch (abort).
- write type 1: the sub-write to a shard is silently dropped — the ack
  never arrives, leaving the op parked in the in-order commit queue
  (the rollback-forcing inject of the reference). Firing auto-arms a
  type-2 inject on the same object, exactly as the reference does
  (ECInject.cc test_write_error1 → write_error(o, 2, 0, 1)).
- write type 2: "inject OSD down" — consulted on the primary when the
  final sub-write commit arrives (pending_commits == 1 in
  handle_sub_write_reply, ECBackend.cc:1158-1167); the primary marks
  itself down via the mon-command analog.
- write type 3: "write abort OSDs" — consulted in handle_sub_write
  (ECBackend.cc:922-926); the receiving OSD aborts (``ceph_abort``),
  so the write is never applied and the ack never arrives. The
  reference requires duration == 1 for this type.

Each injection has ``when`` (ops to let through first) and ``duration``
(ops to affect) counters, matching the reference's tell-command
parameters (ECInject.cc:47-69). Thread-safe; tests and the chaos
harness drive it.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from ceph_tpu_torch.utils.lockdep import DebugLock

ANY_SHARD = -1


def _base_oid(oid: str) -> str:
    """Strip a per-shard store-key suffix (``<oid>#s<n>``, the
    ghobject shard_id field) — object-wide rules (write types 2/3) are
    keyed by the base object, the way the reference normalizes
    ghobject→NO_SHARD before touching write_failures2/3
    (ECInject.cc test_write_error2/3)."""
    loc, sep, s = oid.rpartition("#s")
    if sep and s.isdigit():
        return loc
    return oid


@dataclass
class _Rule:
    when: int
    duration: int

    def fires(self) -> bool:
        """Count an op against this rule; True if the error injects."""
        if self.when > 0:
            self.when -= 1
            return False
        if self.duration > 0:
            self.duration -= 1
            return True
        return False

    @property
    def exhausted(self) -> bool:
        return self.when <= 0 and self.duration <= 0


class ECInject:
    """Global error-inject registry (singleton via module instance)."""

    def __init__(self) -> None:
        self._lock = DebugLock("ec.inject")
        # (kind, type, oid, shard) -> _Rule
        self._rules: dict[tuple[str, int, str, int], _Rule] = {}
        self.injected_count = 0

    # -- operator surface (the `ceph tell` analog) ---------------------
    def read_error(
        self, oid: str, type: int, when: int = 0, duration: int = 1,
        shard: int = ANY_SHARD,
    ) -> str:
        if type not in (0, 1, 2):
            return "unrecognized error inject type"
        with self._lock:
            self._rules[("read", type, oid, shard)] = _Rule(when, duration)
        return f"ok: read error type {type} on {oid}"

    def write_error(
        self, oid: str, type: int, when: int = 0, duration: int = 1,
        shard: int = ANY_SHARD,
    ) -> str:
        if type not in (0, 1, 2, 3):
            return "unrecognized error inject type"
        if type == 3 and duration != 1:
            # the reference refuses multi-shot OSD aborts
            # (ECInject.cc write_error case 3)
            return "duration must be 1"
        if type in (2, 3):
            shard = ANY_SHARD  # registered object-wide, never per-shard
            oid = _base_oid(oid)
        with self._lock:
            self._rules[("write", type, oid, shard)] = _Rule(when, duration)
        return f"ok: write error type {type} on {oid}"

    def clear_read_error(self, oid: str, type: int, shard: int = ANY_SHARD) -> str:
        with self._lock:
            self._rules.pop(("read", type, oid, shard), None)
        return "ok"

    def clear_write_error(self, oid: str, type: int, shard: int = ANY_SHARD) -> str:
        with self._lock:
            self._rules.pop(("write", type, oid, shard), None)
        return "ok"

    def clear_all(self) -> None:
        with self._lock:
            self._rules.clear()
            self.injected_count = 0

    # -- test hooks (called from the dispatch paths) -------------------
    def _test(self, kind: str, type: int, oid: str, shard: int) -> bool:
        with self._lock:
            for key in (
                (kind, type, oid, shard),
                (kind, type, oid, ANY_SHARD),
            ):
                rule = self._rules.get(key)
                if rule is None:
                    continue
                fired = rule.fires()
                if rule.exhausted:
                    del self._rules[key]
                if fired:
                    self.injected_count += 1
                    return True
        return False

    def test_read_error0(self, oid: str, shard: int) -> bool:
        return self._test("read", 0, oid, shard)

    def test_read_error1(self, oid: str, shard: int) -> bool:
        return self._test("read", 1, oid, shard)

    def test_read_error2(self, oid: str, shard: int) -> bool:
        """Silent corruption: the consult site flips bytes in the
        payload it is about to return (no error surfaces here)."""
        return self._test("read", 2, oid, shard)

    @staticmethod
    def corrupt(buf: bytes) -> bytes:
        """The canonical payload mangling for read type 2: invert the
        first byte (and one mid-buffer byte for runs long enough to
        span csum blocks) — enough for any integrity check, invisible
        to everything else."""
        if not buf:
            return buf
        out = bytearray(buf)
        out[0] ^= 0xFF
        if len(out) > 4096:
            out[4096] ^= 0xFF
        return bytes(out)

    def test_write_error0(self, oid: str) -> bool:
        return self._test("write", 0, oid, ANY_SHARD)

    def test_write_error1(self, oid: str, shard: int) -> bool:
        fired = self._test("write", 1, oid, shard)
        if fired:
            # a dropped sub-write arms an OSD-down inject on the same
            # object (ECInject.cc test_write_error1): the next commit
            # cycle takes the primary down, forcing the rollback path.
            # Keyed by the BASE object — the consult site passes the
            # client oid, not the per-shard store key.
            self.write_error(_base_oid(oid), 2, 0, 1)
        return fired

    def test_write_error2(self, oid: str) -> bool:
        return self._test("write", 2, _base_oid(oid), ANY_SHARD)

    def test_write_error3(self, oid: str, exact: bool = False) -> bool:
        """``exact=True`` consults the rule under the oid as given (no
        ghobject normalization) — the standalone pipeline tier uses it
        so a rule the daemon tier already consulted (with the
        normalized base oid) is not decremented a second time by the
        nested ShardBackend hop."""
        return self._test(
            "write", 3, oid if exact else _base_oid(oid), ANY_SHARD
        )


# The process-global registry, mirroring the reference's namespace-level
# singleton state.
ec_inject = ECInject()

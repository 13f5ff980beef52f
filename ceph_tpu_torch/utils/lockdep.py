"""Runtime lock-order and blocking-under-lock detection — the
``common/lockdep.cc`` + ``mutex_debug`` analog.

The cluster tier is a heavily threaded store (~30 named locks across
``cluster/``, ``pipeline/``, ``msg/``, ``store/``, ``loadgen/``), and
the last several rounds each found a concurrency bug by hand that
tooling should have found mechanically: the unlocked daemon-global
req-cache clear, the 2.5 s durability fan-out running *under*
``_op_lock``, stale recovering-marks wedging elections.  This module
is the mechanical net, armed by the ``lockdep`` config option:

- :func:`DebugLock` / :func:`DebugRLock` are drop-in constructors for
  ``threading.Lock()`` / ``threading.RLock()`` carrying a **lock-class
  name** (``"osd.op"``, ``"store.kv"``, ...), an optional **order
  rank**, and an ``op_serializing`` tag.  With ``lockdep=false`` (the
  default) they return the plain threading primitive — the config flag
  is read ONCE, at construction, so the steady-state cost of a
  disarmed build is exactly zero.

- When armed, every (blocking) acquire records the holder thread's
  current held-set into a process-global **lock-dependency graph**
  keyed by lock-class name.  A new edge that closes a cycle in the
  graph is an order inversion — two code paths acquire the same locks
  in opposite orders and WILL deadlock under the right interleaving.
  The cycle is reported (cluster-log ERR, ``lockdep`` perf counters,
  the admin-socket ``lockdep`` dump) with the acquisition backtraces
  of every edge on the cycle, without actually deadlocking: detection
  is observation, the acquire proceeds.

- Locks carrying a **rank** assert the documented order directly:
  acquiring a ranked lock while holding one of greater-or-equal rank
  (different class) is a rank violation even before any reverse path
  exists.  The rank map below documents the cluster tier's intended
  order; unranked locks are covered by cycle detection only.

- :func:`blocking_region` is the blocking-call checkpoint, wired into
  the messenger send path, the dispatcher's device-dispatch wait, the
  peer-RPC drain loop and the sleep shims: entering one while an
  op-serializing lock (``_op_lock``-class, tagged at construction) is
  held flags the site — blocking while holding the op-serializing
  lock IS the single-node tail generator (arxiv 1709.05365's
  queueing/interference finding applied in-process).  Sites that
  serialize *by design* are waived in :data:`BLOCKING_WAIVERS` with
  a one-line justification each; unwaived findings are ERRs.

Rank map (ascending = acquired later / closer to the leaves)::

    10  mon.cmd          monitor command lock (map pushes fan out
                         from under it into the daemons)
    20  osd.op           THE op-serializing lock (client-op order)
    30  osd.pg           daemon PG table + peer addrs
    60  store.*          object-store instance locks
    90  osd.req_flush    documented leaf — never held across another
                         acquire

Everything else is unranked: the graph still catches inversions, but
no order is asserted a priori.  Findings accumulate process-wide;
tests call :func:`reset` for a clean slate and read :func:`dump`
(also served as the admin-socket ``lockdep`` command).
"""

from __future__ import annotations

import sys
import threading

__all__ = [
    "DebugLock",
    "DebugRLock",
    "blocking_region",
    "checked_sleep",
    "enabled",
    "dump",
    "reset",
    "BLOCKING_WAIVERS",
]

#: blocking_region labels that are ALLOWED under an op-serializing
#: lock, each with its one-line justification (the runtime analog of
#: tools/lint_waivers.txt).  A waived hit counts ``blocking_waived``
#: instead of raising an ERR finding — the waiver is a reviewed
#: decision, not a silence switch.
BLOCKING_WAIVERS: dict[str, str] = {
    # The op lock IS the client-op serialization point: the sub-write
    # fan-out and its ack drain are the op itself, bounded by
    # op_timeout (the round-8 fix moved the UNBOUNDED durability
    # fan-out off this lock; the per-op drain stays by design).
    "peers.drain_until":
        "the sub-op drain is the serialized client op itself, "
        "bounded by op_timeout (PR 3 moved the unbounded durability "
        "fan-out off the op lock)",
    # Recovery pushes serialize with live writes UNDER the op lock by
    # construction (round-12 find: a push computed from survivors
    # read at T must not land at T+d over an extent a client write
    # committed in between).
    "recovery.push":
        "catch-up/rewind pushes hold the op lock on purpose — they "
        "must serialize with live writes (the round-12 lost-update "
        "shard tear)",
    # Device dispatches issued from the op path are the op's own
    # encode/decode work — the serialized section IS the operation.
    "dispatcher.submit_wait":
        "the batched device dispatch is the serialized op's own "
        "encode work, not a foreign wait",
    "messenger.send":
        "framed sends are one non-blocking-in-practice socket write "
        "(TCP_NODELAY, k+m-scale fan-out), part of the serialized "
        "op's commit path",
}

# ---------------------------------------------------------------------------
# module state — all guarded by _state_lock, which is a PLAIN lock and
# must never wrap a tracked one (the detector cannot watch itself)
# ---------------------------------------------------------------------------

_state_lock = threading.Lock()
_tls = threading.local()

#: lock-class adjacency: name -> set of names acquired while holding it
_graph: dict[str, set[str]] = {}
#: (holder_name, acquired_name) -> edge record with both backtraces
_edge_info: dict[tuple[str, str], dict] = {}
#: cycle findings (deduped by the frozenset of names on the cycle)
_cycles: list[dict] = []
_cycle_keys: set[frozenset] = set()
#: rank-violation findings, deduped by (held_name, acquired_name)
_rank_violations: list[dict] = []
_rank_keys: set[tuple[str, str]] = set()
#: blocking-under-lock findings, deduped by (label, lock_name)
_blocking: list[dict] = []
_blocking_keys: set[tuple[str, str]] = set()
#: lock classes ever constructed armed (name -> count)
_classes: dict[str, int] = {}

_PERF = None


def _get_perf():
    global _PERF
    if _PERF is None:
        from .perf_counters import PerfCountersBuilder, perf_collection

        _PERF = (
            PerfCountersBuilder(perf_collection, "lockdep")
            .add_u64_counter("locks_constructed",
                             "DebugLocks constructed armed")
            .add_u64_counter("acquires", "tracked blocking acquires")
            .add_u64_counter("edges", "distinct dependency edges recorded")
            .add_u64_counter("cycles", "order-inversion cycles detected")
            .add_u64_counter("rank_violations",
                             "acquires violating the declared rank order")
            .add_u64_counter("blocking_checks",
                             "blocking_region checkpoints crossed")
            .add_u64_counter("blocking_under_lock",
                             "UNWAIVED blocking calls under an "
                             "op-serializing lock")
            .add_u64_counter("blocking_waived",
                             "blocking-under-lock hits on waived labels")
            .create_perf_counters()
        )
    return _PERF


def enabled() -> bool:
    """The construction-time gate: one config read per lock built."""
    from .config import config

    return bool(config.get("lockdep"))


def _held() -> list:
    held = getattr(_tls, "held", None)
    if held is None:
        held = _tls.held = []
    return held


def _stack(skip: int = 2, limit: int = 20) -> list[tuple[str, int, str]]:
    """A cheap acquisition backtrace: raw (file, line, fn) triples —
    no linecache formatting on the hot path, rendered only when a
    finding is reported."""
    try:
        f = sys._getframe(skip)
    except ValueError:
        return []
    out = []
    while f is not None and len(out) < limit:
        co = f.f_code
        out.append((co.co_filename, f.f_lineno, co.co_name))
        f = f.f_back
    return out


def _fmt_stack(frames: list[tuple[str, int, str]]) -> list[str]:
    return [f"{fn}:{ln} in {name}" for fn, ln, name in frames]


def _find_path(src: str, dst: str) -> "list[str] | None":
    """DFS src -> dst over the dependency graph (caller holds
    _state_lock). Returns the node path including both ends."""
    stack = [(src, [src])]
    seen = {src}
    while stack:
        node, path = stack.pop()
        for nxt in _graph.get(node, ()):
            if nxt == dst:
                return path + [dst]
            if nxt not in seen:
                seen.add(nxt)
                stack.append((nxt, path + [nxt]))
    return None


def _cluster_log_err(type_: str, message: str, **fields) -> None:
    try:
        from .cluster_log import cluster_log

        cluster_log.log("lockdep", type_, message, severity="ERR",
                        **fields)
    except Exception:
        pass  # reporting must never fault the locked path


class _HeldRecord:
    __slots__ = ("lock", "name", "rank", "op_serializing", "frames")

    def __init__(self, lock, frames) -> None:
        self.lock = lock
        self.name = lock.name
        self.rank = lock.rank
        self.op_serializing = lock.op_serializing
        self.frames = frames


def _record_acquire(lock: "_DebugLockBase",
                    frames: list[tuple[str, int, str]]) -> None:
    """Record the dependency edges held-set -> lock and run the cycle
    + rank checks.  Called BEFORE the blocking acquire so a genuine
    runtime deadlock still leaves its report behind."""
    perf = _get_perf()
    perf.inc("acquires")
    held = _held()
    for h in held:
        if h.name == lock.name:
            continue  # same class (reentry or sibling instance)
        if (
            lock.rank is not None and h.rank is not None
            and h.rank >= lock.rank
            and (h.name, lock.name) not in _rank_keys
        ):
            with _state_lock:
                if (h.name, lock.name) not in _rank_keys:
                    _rank_keys.add((h.name, lock.name))
                    _rank_violations.append({
                        "held": h.name, "held_rank": h.rank,
                        "acquired": lock.name, "acquired_rank": lock.rank,
                        "held_backtrace": _fmt_stack(h.frames),
                        "acquire_backtrace": _fmt_stack(frames),
                    })
                    perf.inc("rank_violations")
                    _cluster_log_err(
                        "lockdep_rank",
                        f"rank violation: {lock.name} "
                        f"(rank {lock.rank}) acquired while holding "
                        f"{h.name} (rank {h.rank})",
                    )
        edge = (h.name, lock.name)
        with _state_lock:
            if edge in _edge_info:
                _edge_info[edge]["count"] += 1
                continue
            _edge_info[edge] = {
                "count": 1,
                "holder_backtrace": _fmt_stack(h.frames),
                "acquire_backtrace": _fmt_stack(frames),
            }
            _graph.setdefault(h.name, set()).add(lock.name)
            perf.inc("edges")
            # the NEW edge h.name -> lock.name closes a cycle iff
            # lock.name already reaches h.name
            path = _find_path(lock.name, h.name)
            if path is None:
                continue
            cycle = path + [lock.name]  # h -> lock implied by closing
            key = frozenset(path)
            if key in _cycle_keys:
                continue
            _cycle_keys.add(key)
            edges = []
            for a, b in zip(cycle[:-1], cycle[1:]):
                info = _edge_info.get((a, b), {})
                edges.append({
                    "from": a, "to": b,
                    "holder_backtrace": info.get("holder_backtrace"),
                    "acquire_backtrace": info.get("acquire_backtrace"),
                })
            finding = {
                "cycle": cycle,
                "pair": [h.name, lock.name],
                "edges": edges,
                # the would-deadlock pair's two acquisition traces:
                # where this thread acquired h then lock, and where
                # some earlier thread did the reverse
                "this_backtrace": _fmt_stack(frames),
                "held_backtrace": _fmt_stack(h.frames),
            }
            _cycles.append(finding)
            perf.inc("cycles")
        if path is not None:
            _cluster_log_err(
                "lockdep_cycle",
                "lock-order inversion: acquiring "
                f"{lock.name} while holding {h.name}, but "
                f"{' -> '.join(path)} already ordered the other way "
                "(would deadlock under the right interleaving)",
            )


class _DebugLockBase:
    """Shared tracking for the Lock/RLock wrappers.  ``name`` is the
    lock CLASS (graph node) — instances of one class share a node, so
    the graph stays readable and sibling instances (per-PG, per-OSD)
    do not explode it."""

    __slots__ = ("_lock", "name", "rank", "op_serializing", "_depth")

    def __init__(self, lock, name: str, rank: "int | None",
                 op_serializing: bool) -> None:
        self._lock = lock
        self.name = name
        self.rank = rank
        self.op_serializing = op_serializing
        self._depth = 0  # RLock reentry (thread-local by ownership)
        with _state_lock:
            _classes[name] = _classes.get(name, 0) + 1
        _get_perf().inc("locks_constructed")

    # -- the threading.Lock surface -------------------------------------
    def acquire(self, blocking: bool = True, timeout: float = -1):
        if not blocking:
            # a trylock cannot deadlock: no edge is recorded, the
            # held-set only grows on success
            got = self._lock.acquire(False)
            if got:
                self._note_held(_stack())
            return got
        frames = _stack()
        if self._my_depth() == 0:
            _record_acquire(self, frames)
        got = self._lock.acquire(True, timeout)
        if got:
            self._note_held(frames)
        return got

    def release(self) -> None:
        self._lock.release()
        held = _held()
        for i in range(len(held) - 1, -1, -1):
            if held[i].lock is self:
                del held[i]
                break

    def locked(self) -> bool:
        return self._lock.locked()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    def __repr__(self) -> str:
        return (f"<{type(self).__name__} {self.name!r} rank={self.rank} "
                f"op_serializing={self.op_serializing} {self._lock!r}>")

    # -- helpers ---------------------------------------------------------
    def _my_depth(self) -> int:
        return sum(1 for h in _held() if h.lock is self)

    def _note_held(self, frames) -> None:
        _held().append(_HeldRecord(self, frames))


class _DebugRLock(_DebugLockBase):
    """Reentrant variant: only the OUTERMOST acquire records edges
    (reentry cannot introduce new order)."""

    def locked(self) -> bool:  # RLock grew .locked() only in 3.12+
        locked = getattr(self._lock, "locked", None)
        return locked() if locked is not None else self._my_depth() > 0

    # threading.Condition integration: delegate the RLock internals so
    # a Condition wrapping a DebugRLock releases ALL recursion levels
    # (and our held-tracking follows).
    def _is_owned(self):
        return self._lock._is_owned()

    def _release_save(self):
        state = self._lock._release_save()
        held = _held()
        for i in range(len(held) - 1, -1, -1):
            if held[i].lock is self:
                del held[i]
        return state

    def _acquire_restore(self, state):
        self._lock._acquire_restore(state)
        self._note_held(_stack())


def DebugLock(name: str, rank: "int | None" = None,
              op_serializing: bool = False):
    """``threading.Lock()`` drop-in: a tracked wrapper when the
    ``lockdep`` config option is true AT CONSTRUCTION, else the plain
    primitive (zero steady-state cost)."""
    if not enabled():
        return threading.Lock()
    return _DebugLockBase(threading.Lock(), name, rank, op_serializing)


def DebugRLock(name: str, rank: "int | None" = None,
               op_serializing: bool = False):
    """``threading.RLock()`` drop-in — see :func:`DebugLock`."""
    if not enabled():
        return threading.RLock()
    return _DebugRLock(threading.RLock(), name, rank, op_serializing)


# ---------------------------------------------------------------------------
# blocking-under-lock checkpoints
# ---------------------------------------------------------------------------

class _NullCtx:
    """Shared no-op context — blocking_region sits on hot send/dispatch
    paths, so the disarmed cost must be one call + one thread-local
    read, no generator frame, no allocation."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_CTX = _NullCtx()


def blocking_region(label: str):
    """Checkpoint for code that may block (socket IO, device
    dispatch, sleeps, peer-RPC waits).  Crossing one while an
    op-serializing DebugLock is held records a blocking-under-lock
    finding unless ``label`` is justified in :data:`BLOCKING_WAIVERS`.
    Near-zero cost disarmed: one thread-local read finds no held
    locks."""
    held = getattr(_tls, "held", None)
    if held:
        _check_blocking(label, held)
    return _NULL_CTX


def checked_sleep(seconds: float, label: str = "sleep") -> None:
    """``time.sleep`` shim for polling loops in the threaded tier:
    sleeping while holding an op-serializing lock parks every queued
    client op behind a timer — exactly the tail generator lockdep
    exists to catch."""
    import time

    with blocking_region(label):
        time.sleep(seconds)


def _check_blocking(label: str, held: list) -> None:
    op_locks = [h for h in held if h.op_serializing]
    perf = _get_perf()
    perf.inc("blocking_checks")
    if not op_locks:
        return
    h = op_locks[-1]
    waived = label in BLOCKING_WAIVERS
    if waived:
        perf.inc("blocking_waived")
        return
    key = (label, h.name)
    if key in _blocking_keys:
        perf.inc("blocking_under_lock")
        return
    with _state_lock:
        if key in _blocking_keys:
            return
        _blocking_keys.add(key)
        _blocking.append({
            "label": label,
            "lock": h.name,
            "lock_backtrace": _fmt_stack(h.frames),
            "blocking_backtrace": _fmt_stack(_stack(skip=3)),
        })
    perf.inc("blocking_under_lock")
    _cluster_log_err(
        "lockdep_blocking",
        f"blocking region {label!r} entered while holding "
        f"op-serializing lock {h.name} (unwaived — fix the site or "
        "justify it in lockdep.BLOCKING_WAIVERS)",
    )


# ---------------------------------------------------------------------------
# reporting surface
# ---------------------------------------------------------------------------

def dump() -> dict:
    """The admin-socket ``lockdep`` command payload: the dependency
    graph summary and every finding, with backtraces."""
    with _state_lock:
        return {
            "enabled": enabled(),
            "lock_classes": dict(_classes),
            "edges": {
                f"{a} -> {b}": info["count"]
                for (a, b), info in sorted(_edge_info.items())
            },
            "cycles": [dict(c) for c in _cycles],
            "rank_violations": [dict(r) for r in _rank_violations],
            "blocking_under_lock": [dict(b) for b in _blocking],
            "blocking_waivers": dict(BLOCKING_WAIVERS),
        }


def findings() -> dict:
    """Just the failure counts — the soak/bench green-check surface."""
    with _state_lock:
        return {
            "cycles": len(_cycles),
            "rank_violations": len(_rank_violations),
            "blocking_under_lock": len(_blocking),
        }


def reset() -> None:
    """Clear the graph and every finding (tests / soak laps). Held
    sets of live threads are untouched — they reflect reality."""
    with _state_lock:
        _graph.clear()
        _edge_info.clear()
        _cycles.clear()
        _cycle_keys.clear()
        _rank_violations.clear()
        _rank_keys.clear()
        _blocking.clear()
        _blocking_keys.clear()
        _classes.clear()
    if _PERF is not None:
        _PERF.reset()

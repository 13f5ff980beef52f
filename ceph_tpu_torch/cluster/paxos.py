"""Paxos-replicated monitor store (src/mon/Paxos.cc, Elector.cc).

The reference monitor commits every map change through Paxos so that
any majority of monitors can continue and no committed epoch is ever
lost. This module is the analog, scoped the way the reference scopes
it: a **replicated log of control-plane values** (serialized
``Incremental`` blobs — tiny, rare), not a data-path protocol.

Shape (mirroring mon/Paxos.h's collect/begin/commit phases):

- ``PaxosNode`` — one monitor's consensus state: per-slot acceptor
  registers (promised proposal number, accepted pn/value) and the
  learned committed log.
- classic two-phase single-decree Paxos per log slot: ``prepare``
  (collect) gathers promises + any previously accepted value from a
  majority — the proposer must adopt the highest-numbered accepted
  value it sees (this is what makes competing proposers converge);
  ``accept`` (begin) writes the value at a majority; ``learn``
  (commit) distributes the decision.
- ``Transport`` — delivery seam; tests drop links to form partitions.
  A proposer that cannot reach a majority raises ``QuorumLost``
  and nothing is committed (the mon "no quorum" stall).
- rank-based leader election (ElectionLogic: lowest reachable rank
  wins): ``elect`` probes reachability and returns the leader; a new
  leader first syncs — re-runs prepare on every undecided slot so
  anything a dead leader got accepted at a majority survives.

Proposal numbers are ``(round << 16) | rank`` so rounds dominate and
ranks break ties, giving every proposer a disjoint pn space.
"""

from __future__ import annotations

import random
import threading
import time
from dataclasses import dataclass, field
from ceph_tpu_torch.utils.lockdep import DebugRLock, checked_sleep

#: propose() gives up (QuorumLost) after this many prepare/accept
#: rounds: an unbounded retry loop livelocks when two proposers keep
#: refusing each other's pn (round-4 advisor finding). The cap is
#: deliberately high and the backoff jittered: with randomized
#: desynchronization, dueling proposers converge in a handful of
#: rounds, so hitting the cap means something is genuinely wedged.
#: CAVEAT (inherent to Paxos, same as the reference's mon): a
#: round-capped abort cannot prove its value was never accepted — a
#: minority accept can still be resurrected and chosen by a rival's
#: prepare. Callers retrying after this QuorumLost must go through
#: the at-most-once machinery (mon_quorum's pending-blob check), not
#: blind re-submission.
PROPOSE_MAX_ROUNDS = 256


class QuorumLost(Exception):
    """A majority could not be reached; nothing was committed."""


@dataclass
class _SlotState:
    """Acceptor registers for one log slot (Paxos.h accepted_pn etc.)."""

    promised: int = 0
    accepted_pn: int = 0
    accepted_value: bytes | None = None
    committed: bytes | None = None


class Transport:
    """Reachability matrix between monitor ranks. Tests cut links to
    model partitions; delivery is synchronous in-process calls (the
    reference monitors also run consensus over their messenger, but
    the protocol contract is transport-independent)."""

    def __init__(self) -> None:
        self.nodes: dict[int, "PaxosNode"] = {}
        self._cut: set[tuple[int, int]] = set()

    def register(self, node: "PaxosNode") -> None:
        self.nodes[node.rank] = node

    def cut(self, a: int, b: int) -> None:
        self._cut.add((a, b))
        self._cut.add((b, a))

    def heal(self, a: int | None = None, b: int | None = None) -> None:
        """heal() restores every link; heal(a) restores all of a's
        links; heal(a, b) restores the one pair."""
        if a is None:
            self._cut.clear()
        elif b is None:
            self._cut = {
                pair for pair in self._cut if a not in pair
            }
        else:
            self._cut.discard((a, b))
            self._cut.discard((b, a))

    def partition(self, *groups: tuple[int, ...]) -> None:
        """Cut every link between the given groups."""
        for i, g1 in enumerate(groups):
            for g2 in groups[i + 1 :]:
                for a in g1:
                    for b in g2:
                        self.cut(a, b)

    def reachable(self, src: int, dst: int) -> bool:
        return dst in self.nodes and (src, dst) not in self._cut

    def call(self, src: int, dst: int, method: str, *args):
        """None = unreachable (dropped message)."""
        if not self.reachable(src, dst):
            return None
        return getattr(self.nodes[dst], method)(*args)


class PaxosNode:
    """One monitor rank: acceptor + learner + (when leader) proposer."""

    def __init__(self, rank: int, transport: Transport, n_nodes: int) -> None:
        self.rank = rank
        self.transport = transport
        self.n_nodes = n_nodes
        self.slots: dict[int, _SlotState] = {}
        self._round = 0
        self._lock = DebugRLock("mon.paxos")
        transport.register(self)

    # -- local helpers --------------------------------------------------
    def _slot(self, n: int) -> _SlotState:
        return self.slots.setdefault(n, _SlotState())

    @property
    def majority(self) -> int:
        return self.n_nodes // 2 + 1

    def last_committed(self) -> int:
        """Highest contiguous committed slot (-1 if none)."""
        n = -1
        while self.slots.get(n + 1) and self.slots[n + 1].committed is not None:
            n += 1
        return n

    def committed_values(self) -> list[bytes]:
        out = []
        n = 0
        while True:
            s = self.slots.get(n)
            if s is None or s.committed is None:
                return out
            out.append(s.committed)
            n += 1

    # -- acceptor side (remote-invoked via transport) --------------------
    def on_prepare(self, slot: int, pn: int) -> tuple[bool, int, bytes | None]:
        """Returns (promised?, accepted_pn, accepted_value)."""
        with self._lock:
            s = self._slot(slot)
            if pn <= s.promised:
                return (False, s.accepted_pn, s.accepted_value)
            s.promised = pn
            return (True, s.accepted_pn, s.accepted_value)

    def on_accept(self, slot: int, pn: int, value: bytes) -> bool:
        with self._lock:
            s = self._slot(slot)
            if pn < s.promised:
                return False
            s.promised = pn
            s.accepted_pn = pn
            s.accepted_value = value
            return True

    def on_learn(self, slot: int, value: bytes) -> None:
        with self._lock:
            self._slot(slot).committed = value

    def on_probe(self, src: int) -> int:
        """Election/sync probe: answers with last committed slot."""
        return self.last_committed()

    # -- proposer side ---------------------------------------------------
    def _next_pn(self) -> int:
        with self._lock:
            self._round += 1
            return (self._round << 16) | self.rank

    def propose(self, slot: int, value: bytes) -> bytes:
        """Drive one slot to a decision. Returns the DECIDED value —
        which may differ from ``value`` if a competing proposer got
        there first (callers must check and re-propose at a new slot).
        Raises QuorumLost if a majority is unreachable.

        The node lock is NOT held across transport calls: a proposer
        blocking inside a peer's acceptor while that peer's proposer
        blocks inside ours would be an ABBA deadlock; only the local
        register reads/writes need the lock (the acceptor methods
        take it themselves)."""
        with self._lock:
            committed = self._slot(slot).committed
        if committed is not None:
            return committed
        for round_no in range(PROPOSE_MAX_ROUNDS):
            if round_no:
                # jittered backoff: two live proposers refusing each
                # other's pn forever is the classic Paxos livelock;
                # desynchronizing the rounds lets one win
                checked_sleep(
                    random.uniform(0, 0.002 * round_no),
                    label="paxos.backoff",
                )
            pn = self._next_pn()
            # phase 1: prepare / collect
            promises = 0
            responders = 0
            best_pn, best_val = 0, None
            for rank in self.transport.nodes:
                r = self.transport.call(
                    self.rank, rank, "on_prepare", slot, pn
                )
                if r is None:
                    continue
                responders += 1
                ok, acc_pn, acc_val = r
                if ok:
                    promises += 1
                    if acc_val is not None and acc_pn > best_pn:
                        best_pn, best_val = acc_pn, acc_val
            if responders < self.majority:
                # a genuine partition: a majority is UNREACHABLE
                raise QuorumLost(
                    f"rank {self.rank}: {responders}/{self.n_nodes} "
                    f"reachable for slot {slot}"
                )
            if promises < self.majority:
                # refused, not unreachable: peers promised a higher pn
                # (a proposer with a stale round — e.g. a revived
                # ex-leader). Retry with the next round; conflating
                # this with QuorumLost wedged exactly that revival.
                continue
            # adopt any previously accepted value (convergence rule)
            chosen = best_val if best_val is not None else value
            # phase 2: accept / begin
            accepts = 0
            for rank in self.transport.nodes:
                if self.transport.call(
                    self.rank, rank, "on_accept", slot, pn, chosen
                ):
                    accepts += 1
            if accepts >= self.majority:
                # phase 3: commit / learn (best-effort fan-out; the
                # decision is already durable at a majority)
                for rank in self.transport.nodes:
                    self.transport.call(
                        self.rank, rank, "on_learn", slot, chosen
                    )
                return chosen
            # lost a race: retry with a higher pn
        raise QuorumLost(
            f"rank {self.rank}: slot {slot} undecided after "
            f"{PROPOSE_MAX_ROUNDS} propose rounds (dueling proposers)"
        )


class MonCluster:
    """N monitor ranks + election + the replicated-log client API the
    ``Monitor`` plugs into (``commit_fn``)."""

    def __init__(self, n: int = 3) -> None:
        self.transport = Transport()
        self.nodes = [PaxosNode(r, self.transport, n) for r in range(n)]

    # -- election (ElectionLogic: lowest reachable rank wins) ------------
    def elect(self, from_rank: int = 0) -> PaxosNode:
        """Probe reachability from ``from_rank``'s partition; lowest
        rank that can see a majority becomes leader, then syncs."""
        reachable = [
            r for r in sorted(self.transport.nodes)
            if self.transport.call(from_rank, r, "on_probe", from_rank)
            is not None
        ]
        if len(reachable) < self.nodes[0].majority:
            raise QuorumLost(
                f"only {len(reachable)} ranks reachable from {from_rank}"
            )
        leader = self.nodes[reachable[0]]
        self._sync(leader)
        return leader

    def _sync(self, leader: PaxosNode) -> None:
        """New-leader recovery (Paxos 'collect' on undecided slots):
        re-drive every slot where a reachable peer holds a value
        (committed or merely accepted), so majority-accepted-but-
        unlearned values get committed. Quorum intersection guarantees
        any majority-accepted value is visible on at least one
        reachable peer. Slots that were only PREPARED (no value
        accepted anywhere) are left alone — proposing a filler there
        would poison the log with undecodable entries; the next real
        commit claims them naturally."""
        horizon = -1
        for rank in self.transport.nodes:
            if not self.transport.reachable(leader.rank, rank):
                continue
            peer = self.transport.nodes[rank]
            if peer.slots:
                horizon = max(horizon, max(peer.slots))
        for slot in range(horizon + 1):
            if leader._slot(slot).committed is not None:
                continue
            seed = None
            for rank in self.transport.nodes:
                if not self.transport.reachable(leader.rank, rank):
                    continue
                s = self.transport.nodes[rank].slots.get(slot)
                if s is None:
                    continue
                if s.committed is not None:
                    seed = s.committed
                    break
                if s.accepted_value is not None:
                    seed = s.accepted_value
            if seed is not None:
                leader.propose(slot, seed)

    # -- client API ------------------------------------------------------
    def commit(self, value: bytes, leader: PaxosNode | None = None) -> int:
        """Append ``value`` to the replicated log; returns its slot.
        Retries at later slots if another proposer won the race."""
        node = leader or self.elect()
        while True:
            slot = node.last_committed() + 1
            if node.propose(slot, value) == value:
                return slot

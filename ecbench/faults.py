"""Faults planted under the timed path, for the control and the tests
that show ``correct`` can come out false. No benchmark run plants one:
``run.py --fault <name>`` is the control's entry, and the tests call
``plant`` themselves.

Each fault wraps one method of the program for the life of the
``with`` block and restores it after:

- ``parity_unapplied`` (the control): the stores drop every write to a
  parity shard while the op is still acknowledged, the step below the
  configurations' guarantee "acknowledged after the sub-writes of every
  up shard are applied";
- ``state_unchanged``: the stores drop every write to data shard 0, so
  a write returns with the object's state unchanged there;
- ``half_shards``: the stores drop the writes of every odd shard, half
  of each op's shard batch;
- ``answer_altered``: a byte flipped in every parity write where the
  encode hands it to the store, and in every read's answer where the
  client receives it.
"""

from __future__ import annotations

import contextlib
import dataclasses
import re

FAULTS = ("parity_unapplied", "state_unchanged", "half_shards",
          "answer_altered")

_SHARD = re.compile(r"#s(\d+)$")


def _shard(oid: str) -> int | None:
    m = _SHARD.search(oid)
    return int(m.group(1)) if m else None


def _flip(data: bytes) -> bytes:
    return bytes([data[0] ^ 0x01]) + data[1:] if data else data


@contextlib.contextmanager
def plant(name: str, k: int):
    if name not in FAULTS:
        raise ValueError(f"unknown fault {name!r}; have {FAULTS}")
    from ceph_tpu_torch.cluster.objecter import Objecter
    from ceph_tpu_torch.store.memstore import MemStore
    from ceph_tpu_torch.store.transaction import OpKind

    def edit(op):
        """The op as the fault lets it reach the store, or None."""
        shard = _shard(op.oid)
        if op.kind is not OpKind.WRITE or shard is None:
            return op
        if name == "parity_unapplied" and shard >= k:
            return None
        if name == "state_unchanged" and shard == 0:
            return None
        if name == "half_shards" and shard % 2:
            return None
        if name == "answer_altered" and shard >= k:
            return dataclasses.replace(op, data=_flip(op.data), csums=None)
        return op

    queue = MemStore.queue_transactions
    reply = Objecter._handle_reply

    def queue_transactions(self, txns):
        txns = [txns] if not isinstance(txns, list) else txns
        for t in txns:
            t.ops = [o for o in (edit(op) for op in t.ops) if o is not None]
        return queue(self, txns)

    def handle_reply(self, aop, msg):
        if aop.op == "read" and msg.data and not msg.error:
            msg = dataclasses.replace(msg, data=_flip(msg.data))
        return reply(self, aop, msg)

    MemStore.queue_transactions = queue_transactions
    if name == "answer_altered":
        Objecter._handle_reply = handle_reply
    try:
        yield
    finally:
        MemStore.queue_transactions = queue
        Objecter._handle_reply = reply

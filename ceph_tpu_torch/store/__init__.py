"""Local object persistence — the ``ObjectStore`` boundary.

Behavioral mirror of the reference's store contract
(src/os/ObjectStore.h ``queue_transactions`` + src/os/Transaction.h):
writes arrive as ordered, atomic ``Transaction`` op lists; reads are
direct. ``MemStore`` (src/os/memstore/) is the in-RAM implementation
the reference uses to run its OSD pipeline tests hardware-free; here it
holds the shards of the EC pipeline. ``MemStore.from_snapshot`` builds
a store from plain data read out of another store, so two stores (or
two packages) start from the same state.

FileStore and BlockStore come in a later slice (ROADMAP.md).
"""

from .transaction import Op, OpKind, Transaction
from .memstore import MemStore

__all__ = ["MemStore", "Op", "OpKind", "Transaction"]

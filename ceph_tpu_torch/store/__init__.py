"""Local object persistence — the ``ObjectStore`` boundary.

Behavioral mirror of the reference's store contract
(src/os/ObjectStore.h ``queue_transactions`` + src/os/Transaction.h):
writes arrive as ordered, atomic ``Transaction`` op lists; reads are
direct. ``MemStore`` (src/os/memstore/) is the in-RAM implementation
the reference uses to run its OSD pipeline tests hardware-free; here it
holds the shards of the EC pipeline in tests and the chip smoke's
pipeline path. ``MemStore.from_snapshot`` builds a store from plain data
read out of another store, so two stores (or two packages) start from
the same state.

The persistent tier: ``FileStore`` (a journaled file per object) and
``BlockStore``, the BlueStore analogue — objects as COW blobs on one
preallocated device file, onodes in the embedded ``kvstore``, whose WAL
and snapshot live in the same device (``devicefs``), free space in the
``allocator`` family, and blob csums verified on every read (adopted
from Kernel B's fused csums on the EC write path). Their on-disk
formats equal ``ceph_tpu``'s: a store written by one package opens in
the other.
"""

from .transaction import Op, OpKind, Transaction
from .memstore import MemStore
from .filestore import FileStore
from .blockstore import BlockStore, CsumError

__all__ = [
    "BlockStore",
    "CsumError",
    "FileStore",
    "MemStore",
    "Op",
    "OpKind",
    "Transaction",
]


def open_store(data_path: str):
    """Open an existing OSD store dir with the backend it was created
    with: the ``backend`` marker the CLI writes, else device-file
    detection. Shared by the dev-cluster CLI and the offline
    objectstore tool so backend detection cannot diverge."""
    import os

    marker = os.path.join(data_path, "backend")
    if os.path.exists(marker):
        kind = open(marker).read().strip()
    else:
        kind = (
            "block" if os.path.exists(os.path.join(data_path, "block"))
            else "file"
        )
    return BlockStore(data_path) if kind == "block" else FileStore(data_path)

"""Host-level distributed communication — the ``src/msg`` analog.

The reference fans EC sub-ops to remote OSDs through AsyncMessenger's
ProtocolV2 framed wire protocol (msg/async/ProtocolV2.h: segmented
frames, per-segment crc32c). This package is that tier: the same
framed, crc-protected wire protocol carrying typed, versioned messages
between clients, OSD daemons and shard servers, over TCP or, between
peers in one process, a shared-memory ring lane. Frames and message
encodings are byte-equal to ``ceph_tpu``'s, so either package's
daemons read the other's frames.

``NetShardBackend`` is a drop-in ``ShardBackend`` whose sub-ops travel
over sockets, so the whole RMW/read/recovery pipeline runs unchanged
against remote shard daemons — the standalone-cluster test tier
(qa/standalone/erasure-code) boots exactly that topology in-process.
"""

from .wire import BadFrame, decode_frame, encode_frame
from .messages import (
    ECSubRead,
    ECSubReadReply,
    ECSubWrite,
    ECSubWriteReply,
    decode_message,
)
from .messenger import Connection, Messenger
from .shard_server import NetShardBackend, ShardServer

__all__ = [
    "BadFrame",
    "decode_frame",
    "encode_frame",
    "ECSubRead",
    "ECSubReadReply",
    "ECSubWrite",
    "ECSubWriteReply",
    "decode_message",
    "Connection",
    "Messenger",
    "NetShardBackend",
    "ShardServer",
]

"""Cluster control plane — the OSDMap / monitor / client tier.

The reference's control plane (SURVEY.md §2.4, §3.4): an epoch-
versioned cluster map (src/osd/OSDMap.h) published by a monitor
authority (src/mon/OSDMonitor.cc) and consumed by clients that target
ops via the map (src/osdc/Objecter.cc). This package is the analog:

- ``osdmap``:   OSDMap + Incremental — devices, pools, EC profiles,
                up/down/in/out, pg→acting arithmetic with EC holes.
- ``monitor``:  the map authority — commands, profile validation
                (trial codecs on the monitor's device), failure
                reports, subscriptions, incremental catch-up.
- ``paxos``:    quorum-replicated commit for the monitor store;
                ``mon_quorum`` runs a Monitor per rank behind it with
                leader routing and failover, ``mon_store`` persists
                the committed map versions.
- ``osd_daemon`` / ``objecter``: the data-plane daemon serving client
                ops (every PG's codec, HashInfo and scrub hash on the
                daemon's device, ``"cuda"`` unless the caller asks for
                the CPU) and the map-aware resending client, which does
                no codec work.
- ``peering``:  the explicit per-PG peering state machine
                (PeeringState.cc analog) + crash-point injection.
- ``pgmap``:    the stats plane — per-PG stats reports folded into
                the PGMap aggregate (pg_stats_t / MgrStatMonitor
                analog) behind `status` / `pg dump` / `df`.
- ``mgr``, ``qos``, ``striper``: the health model, the multi-tenant
                dmClock plane and the striped client.
"""

from .osdmap import Incremental, OSDInfo, OSDMap, PoolSpec, SHARD_NONE
from .mgr import Manager
from .monitor import CommandError, Monitor
from .objecter import IoCtx, NoPrimary, Objecter, RadosClient
from .osd_daemon import OSDDaemon
from .peering import PgPeeringFsm, crash_points
from .pgmap import OSDStat, PGMap, PGStats
from .striper import StripedIoCtx

__all__ = [
    "Manager",
    "OSDStat",
    "PGMap",
    "PGStats",
    "CommandError",
    "PgPeeringFsm",
    "crash_points",
    "Incremental",
    "IoCtx",
    "Monitor",
    "NoPrimary",
    "OSDDaemon",
    "OSDInfo",
    "OSDMap",
    "Objecter",
    "PoolSpec",
    "RadosClient",
    "StripedIoCtx",
    "SHARD_NONE",
]

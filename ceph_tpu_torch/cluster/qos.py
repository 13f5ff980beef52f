"""Multi-tenant QoS plane — the osd_mclock / dmClock analog.

The scheduler core (utils/mclock.py) arbitrates named classes; this
module is everything that makes those classes MEAN something in a
multi-tenant cluster:

- **Tenant identity.**  A client opens ``open_ioctx(pool,
  tenant="gold")``; the tenant rides every op through the objecter and
  the OSD op wire format (``MOSDOp`` carries the entity the same way)
  and lands in a dynamic mClock class ``client.<tenant>`` —
  ``client.<pool>`` when untagged — so one flooding tenant queues
  behind its own tags, not everyone's (``client_class``).

- **QoS specs.**  ``QoSSpec`` declares reservation/weight/limit in
  ops/s AND bytes/s per pool or per tenant.  Both axes convert through
  the byte-cost quantum into the scheduler's single cost-unit clock:
  an op costs ``1 + nbytes/65536`` units (``op_cost``), so a spec's
  effective reservation is ``res_ops + res_bytes/65536`` units/s —
  guaranteed op quanta plus guaranteed byte quanta (the dmclock
  cost-per-io + cost-per-byte folding).  Specs live in pool metadata
  on the monitor (``PoolSpec.qos``, ``osd pool qos set``) and reach
  every OSD with the map push, so a spec change applies live.

- **The byte-cost model.**  ``op_cost`` prices client ops, recovery
  pushes, backfill items and scrub sweeps by payload size — a 4 MB
  push can no longer starve a 4 KB stat stream by costing the same.

- **The recovery-vs-client slosh knob.**  ``derive_profiles`` builds
  the base-class profile table from ``osd_mclock_profile``
  (high_client / balanced / high_recovery: fractions of
  ``osd_mclock_capacity``) and re-derives background reservations from
  MEASURED client demand: reservation capacity the clients aren't
  using sloshes to recovery/backfill instead of sitting idle (the
  reference's mclock profile auto-tuning role).

- **Observability.**  ``make_qos_perf`` builds the ``osd.N.qos``
  aggregate set; ``make_qos_class_perf`` builds per-class
  ``osd.N.qos.pool.<label>`` sets so the Prometheus exporter renders
  the tenant as a ``pool`` label (the round-15 suffix mechanism).
  The admin-socket ``dump_mclock`` (registered here, EC101: the utils
  tier never imports up) shows live per-class tags and queue depths
  for every registered daemon.
"""

from __future__ import annotations

import weakref
from dataclasses import dataclass

from ceph_tpu_torch.utils.mclock import ClientProfile

#: one cost unit per this many payload bytes (the 64 KiB the client
#: op path has always normalized against)
COST_QUANTUM_BYTES = 65536

#: slosh-knob presets: fraction of osd_mclock_capacity each base class
#: is guaranteed (res), its spare-capacity weight, and its cap (lim,
#: 0 = uncapped) — the osd_mclock_profile built-in profile shapes
MCLOCK_PROFILES: dict[str, dict[str, tuple[float, float, float]]] = {
    "high_client": {
        "client":   (0.80, 4.0, 0.0),
        "recovery": (0.10, 0.5, 0.20),
        "backfill": (0.05, 0.25, 0.10),
        "scrub":    (0.0, 0.1, 0.05),
        "gc":       (0.0, 0.1, 0.05),
    },
    "balanced": {
        "client":   (0.50, 2.0, 0.0),
        "recovery": (0.25, 1.0, 0.50),
        "backfill": (0.10, 0.5, 0.25),
        "scrub":    (0.0, 0.2, 0.10),
        "gc":       (0.0, 0.2, 0.10),
    },
    "high_recovery": {
        "client":   (0.30, 1.0, 0.0),
        "recovery": (0.60, 2.0, 0.0),
        "backfill": (0.20, 1.0, 0.50),
        "scrub":    (0.0, 0.2, 0.10),
        "gc":       (0.0, 0.2, 0.10),
    },
}


def op_cost(nbytes: int) -> float:
    """Byte-proportional mClock cost of one op: a base quantum for the
    fixed per-op work plus one unit per 64 KiB of payload."""
    return 1.0 + max(int(nbytes), 0) / COST_QUANTUM_BYTES


def client_class(tenant: str, pool: str) -> str:
    """The dynamic mClock class a client op schedules under:
    ``client.<tenant>`` when tagged, ``client.<pool>`` otherwise.
    Both inherit the base ``client`` profile until a QoS spec of their
    own lands (mclock ``_profile_for`` prefix resolution)."""
    return f"client.{tenant}" if tenant else f"client.{pool}"


def class_label(class_name: str) -> str:
    """The dot-free exporter label for a class: the tenant/pool part
    of a ``client.<x>`` class, the class name itself otherwise (the
    ``.pool.<label>`` suffix only splits when the label is dot-free)."""
    if "." in class_name:
        return class_name.split(".", 1)[1].replace(".", "_")
    return class_name


@dataclass(frozen=True)
class QoSSpec:
    """One pool's or tenant's QoS declaration: reservation / weight /
    limit with BOTH an ops/s and a bytes/s axis.  ``to_profile`` folds
    the axes into the scheduler's cost-unit clock (see module doc)."""

    res_ops: float = 0.0
    res_bytes: float = 0.0
    weight: float = 1.0
    lim_ops: float = 0.0
    lim_bytes: float = 0.0

    def to_profile(self) -> ClientProfile:
        res = self.res_ops + self.res_bytes / COST_QUANTUM_BYTES
        lim = self.lim_ops + self.lim_bytes / COST_QUANTUM_BYTES
        return ClientProfile(
            reservation=res, weight=max(self.weight, 1e-9), limit=lim,
        )

    def to_obj(self) -> dict:
        return {
            "res_ops": self.res_ops, "res_bytes": self.res_bytes,
            "weight": self.weight,
            "lim_ops": self.lim_ops, "lim_bytes": self.lim_bytes,
        }

    @classmethod
    def from_obj(cls, o: dict) -> "QoSSpec":
        return cls(
            res_ops=float(o.get("res_ops", 0.0)),
            res_bytes=float(o.get("res_bytes", 0.0)),
            weight=float(o.get("weight", 1.0)),
            lim_ops=float(o.get("lim_ops", 0.0)),
            lim_bytes=float(o.get("lim_bytes", 0.0)),
        )


def derive_profiles(
    profile_name: str,
    capacity: float,
    client_demand: float = 0.0,
) -> dict[str, ClientProfile]:
    """Build the base-class profile table for one slosh-knob setting.

    ``capacity`` is the daemon's notional service rate in cost units/s
    (``osd_mclock_capacity``); each preset guarantees fractions of it.
    ``client_demand`` is the MEASURED client service rate (cost
    units/s over the recent tick window): reservation capacity the
    clients demonstrably aren't using — ``client_res - demand``, never
    negative — is re-granted to recovery and backfill pro rata to
    their own reservations, so an idle cluster recovers at full tilt
    while a saturated one keeps the configured floor.  Monotone in the
    knob: high_client <= balanced <= high_recovery recovery rates for
    any fixed demand."""
    shape = MCLOCK_PROFILES.get(profile_name)
    if shape is None:
        raise ValueError(
            f"unknown mclock profile {profile_name!r} "
            f"(one of {sorted(MCLOCK_PROFILES)})"
        )
    capacity = max(capacity, 1.0)
    table: dict[str, ClientProfile] = {}
    for cls, (res_frac, wgt, lim_frac) in shape.items():
        table[cls] = ClientProfile(
            reservation=res_frac * capacity,
            weight=wgt,
            limit=lim_frac * capacity,
        )
    client_res = table["client"].reservation
    spare = max(client_res - max(client_demand, 0.0), 0.0)
    bg_res = (
        table["recovery"].reservation + table["backfill"].reservation
    )
    if spare > 0.0 and bg_res > 0.0:
        for cls in ("recovery", "backfill"):
            p = table[cls]
            grant = spare * (p.reservation / bg_res)
            lim = p.limit
            if lim > 0.0:
                lim = max(lim, p.reservation + grant)
            table[cls] = ClientProfile(
                reservation=p.reservation + grant,
                weight=p.weight, limit=lim,
            )
    return table


#: reservations may claim at most this fraction of the (measured)
#: capacity; the rest is the weight phase's guaranteed floor, so
#: weight-only classes can never be starved outright by oversubscribed
#: reservations (the dmClock paper's sum(rho_i) <= capacity admission
#: condition, enforced by scaling instead of rejecting)
RESERVATION_FRAC = 0.8


def normalize_reservations(
    table: dict[str, ClientProfile],
    capacity: float,
    frac: float = RESERVATION_FRAC,
) -> dict[str, ClientProfile]:
    """Scale every reservation down pro rata when their sum exceeds
    ``frac * capacity``.

    Reservations are promises against real service capacity; when the
    configured specs oversubscribe the *measured* rate (a 1000-unit/s
    notional capacity on a host that serves 80), the reservation phase
    never drains and weight-only classes starve until their clients
    time out and resend — the resend storm is the noisy-neighbor cliff
    this guard removes.  Weights and limits pass through untouched:
    only the constraint clocks are rescaled, so relative guarantees
    survive."""
    if capacity <= 0.0 or frac <= 0.0:
        return table
    total = sum(p.reservation for p in table.values())
    budget = frac * capacity
    if total <= budget:
        return table
    f = budget / total
    return {
        cls: ClientProfile(
            reservation=p.reservation * f,
            weight=p.weight, limit=p.limit,
        )
        for cls, p in table.items()
    }


# -- perf sets (EC103: counters declared through the builder) ----------
def make_qos_perf(name: str):
    """The ``osd.N.qos`` aggregate set: scheduler-wide dequeue /
    throttle / admit-timeout counters and queue-depth / tag-lag
    gauges (perf dump + exporter)."""
    from ceph_tpu_torch.utils.perf_counters import (
        PerfCountersBuilder, perf_collection,
    )

    return (
        PerfCountersBuilder(perf_collection, name)
        .add_u64_counter(
            "dequeue_r", "ops dequeued in the reservation phase"
        )
        .add_u64_counter(
            "dequeue_p", "ops dequeued in the weight phase"
        )
        .add_u64_counter(
            "throttle", "dequeue stalls with every class limit-gated"
        )
        .add_u64_counter(
            "admit_timeout",
            "admit() waits that timed out and proceeded unthrottled",
        )
        .add_u64_gauge("queue_depth", "ops queued across all classes")
        .add_u64_gauge(
            "tag_lag_ms",
            "worst per-class head tag lag (ms behind its clocks)",
        )
        .add_u64_gauge(
            "qos_classes", "mClock classes with live queue state"
        )
        .add_u64_gauge(
            "capacity",
            "effective capacity (cost units/s) the profile table is "
            "derived against: osd_mclock_capacity clamped to the "
            "measured backlogged service rate (the osd bench "
            "auto-capacity analog)",
        )
        .create_perf_counters()
    )


def make_qos_class_perf(base: str, class_name: str):
    """One class's ``<base>.pool.<label>`` set — the exporter splits
    the suffix into a ``pool`` label, so per-tenant dequeue/throttle
    counters land as a proper Prometheus dimension."""
    from ceph_tpu_torch.utils.perf_counters import (
        PerfCountersBuilder, perf_collection,
    )

    return (
        PerfCountersBuilder(
            perf_collection, f"{base}.pool.{class_label(class_name)}"
        )
        .add_u64_counter(
            "dequeue", "ops dequeued for this class (both phases)"
        )
        .add_u64_counter(
            "throttle", "dequeue stalls while this class was "
                        "limit-gated at the head"
        )
        .add_u64_counter(
            "admit_timeout", "admit() timeouts charged to this class"
        )
        .add_u64_gauge("queue_depth", "ops queued in this class")
        .create_perf_counters()
    )


# -- the dump_mclock admin surface -------------------------------------
#: daemon name -> its scheduler (weak: a stopped daemon drops out)
_schedulers: "weakref.WeakValueDictionary[str, object]" = (
    weakref.WeakValueDictionary()
)


def register_scheduler(daemon: str, scheduler) -> None:
    """Hang a daemon's scheduler on the ``dump_mclock`` surface."""
    _schedulers[daemon] = scheduler


def _register_admin() -> None:
    """``dump_mclock`` registers HERE (not in utils/admin_socket.py's
    builtins) so the utils tier never imports up into the cluster
    tier — ECLint EC101 pins that layering."""
    from ceph_tpu_torch.utils.admin_socket import admin_socket

    def _dump(daemon=None):
        if daemon is not None:
            sched = _schedulers.get(str(daemon))
            return sched.dump() if sched is not None else {}
        return {
            name: sched.dump()
            for name, sched in sorted(_schedulers.items())
        }

    try:
        admin_socket.register(
            "dump_mclock", _dump,
            "live mClock state per daemon: per-class profiles, queue "
            "depths, head tags, tag lag and service counters",
        )
    except ValueError:
        pass  # already registered (module reloaded)


_register_admin()

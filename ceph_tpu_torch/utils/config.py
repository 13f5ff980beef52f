"""Declarative, layered configuration — the Option/ConfigProxy analog.

Mirrors the reference's config system (common/options/*.yaml.in
declarative Option specs code-generated by y2c.py; layered resolution
in common/config.cc): options are declared once with type, default,
bounds/enum, and description; effective values resolve through layers

    compiled default < config file < environment < runtime override

(the reference adds the mon config database between file and env; here
the file layer plays that role). Observers are notified when a key's
effective value changes (common/config_obs.h).

Environment variables use the ``CEPH_TPU_TORCH_`` prefix with the option
name upper-cased, e.g. ``CEPH_TPU_TORCH_EC_HOST_DISPATCH_BYTES=0``. The
schema holds the options this package reads; the names and defaults
are ``ceph_tpu``'s, with its TPU-only keys renamed or dropped.
"""

from __future__ import annotations

import json
import os
import threading
from contextlib import contextmanager
from dataclasses import dataclass

ENV_PREFIX = "CEPH_TPU_TORCH_"

# Layer precedence, low to high (config.cc layered resolution).
#: precedence, lowest to highest. "mon" is the ConfigMonitor analog's
#: layer: the mon-replicated central db overrides compiled defaults
#: but local file/env/runtime settings override IT (the reference's
#: local-emergency-override ordering, doc/rados/configuration).
LAYERS = ("default", "mon", "file", "env", "runtime")


@dataclass(frozen=True)
class Option:
    """One declared option (the Option type of common/options.h)."""

    name: str
    type: type  # int | float | bool | str
    default: object
    desc: str = ""
    level: str = "advanced"  # basic | advanced | dev
    min: float | None = None
    max: float | None = None
    enum_values: tuple[str, ...] = ()
    see_also: tuple[str, ...] = ()

    def parse(self, raw):
        if isinstance(raw, str) and self.type is not str:
            if self.type is bool:
                val = raw.strip().lower() in ("1", "true", "yes", "on")
            else:
                val = self.type(raw)
        else:
            val = self.type(raw)
        self.validate(val)
        return val

    def validate(self, val) -> None:
        if self.min is not None and val < self.min:
            raise ValueError(f"{self.name}={val} below min {self.min}")
        if self.max is not None and val > self.max:
            raise ValueError(f"{self.name}={val} above max {self.max}")
        if self.enum_values and val not in self.enum_values:
            raise ValueError(
                f"{self.name}={val!r} not one of {self.enum_values}"
            )


# The option schema. Names follow the reference's where a direct analog
# exists, ceph_tpu's otherwise.
OPTIONS: tuple[Option, ...] = (
    Option(
        "ec_use_kernels", bool, True,
        desc="serve CUDA-tensor matrix applies and crc32c folds with the "
             "hand-written CUDA kernels (csrc/); off runs the plain "
             "PyTorch versions on the card, counted as plain_* — the "
             "A/B arm, never a silent fallback",
    ),
    Option(
        "ec_fused_csum", bool, True,
        desc="let encode_chunks_with_csums fuse per-csum-block CRC32C "
             "into the encode launch (parity AND the k+m shards' block "
             "csums in one pass); consumers seed HashInfo and blob "
             "csums from the kernel output instead of re-hashing",
    ),
    Option(
        "csum_device_min_bytes", int, 1 << 18,
        desc="host-array checksum batches below this many bytes run on "
             "the host scalar path instead of the device fold — "
             "per-launch latency and the copy dwarf the hash there; "
             "0 = always use the device",
        min=0,
    ),
    Option(
        "ec_use_sched", bool, True,
        desc="serve 0/1 GF(2^8) byte matrices (the xor plugin, LRC "
             "xor-local layers, all-ones decode rows) on the card with "
             "the XOR-schedule kernel (csrc/xor_schedule.cu) instead of "
             "the GF(2^8) apply kernel. Packet bit-matrices (liberation "
             "family) always take the XOR-schedule kernel: the apply "
             "kernel takes at most 32 columns, they have k*w",
    ),
    Option(
        "ec_sched_opt", bool, True,
        desc="superoptimize XOR schedules (arxiv 2108.02692): greedy "
             "pairwise CSE factors shared subexpressions across rows "
             "into scratch intermediates, the DAG is reordered for "
             "operand locality, and the gate moves to post-CSE op "
             "count; off = the un-optimized selection-form schedule "
             "under the raw density gate, the pinned bit-equal escape "
             "hatch",
        see_also=("ec_use_sched",),
    ),
    Option(
        "ec_clay_kernels", bool, True,
        desc="serve CLAY fractional repair of tensors with the "
             "hand-written CUDA repair kernels (csrc/clay_repair.cu: "
             "uncoupled values, then couple + scatter; any geometry) "
             "around one GF(2^8) apply per intersection-score group; "
             "CPU tensors run their plain PyTorch versions. Off runs "
             "the whole-tensor (no aloof helper) or itemized PyTorch "
             "routes on the tensors' device",
    ),
    Option(
        "ec_host_dispatch_bytes", int, 1 << 20,
        desc="host-array ops at or below this many input bytes encode/"
             "decode on the host GF tables instead of the device "
             "(0 = always use the device)",
        min=0,
    ),
    # -- the EC pipeline, stores and runtime (ceph_tpu's texts) ------
    Option(
        "ec_streaming_dispatch", bool, False,
        desc="route pipeline encodes through the native-ring streaming "
             "dispatcher: concurrent small ops across PGs aggregate "
             "into one batched device dispatch with completion "
             "callbacks (SURVEY step-4 staging tier; sharded op "
             "queue role, osd/OSD.cc:9874)",
    ),
    Option(
        "csum_block_size", int, 4096,
        desc="bytes per checksum block", min=16,
    ),
    Option(
        "ec_extent_cache_lines", int, 1024,
        desc="LRU lines kept by the write-back extent cache "
             "(ECExtentCache LRU analog)", min=0,
    ),
    Option(
        "ec_recovery_verify", bool, True,
        desc="verify fully reconstructed shards against the persisted "
             "HashInfo cumulative crcs (device-batched) before "
             "pushing them to the replacement store",
    ),
    Option(
        "osd_deep_scrub_stride", int, 524288,
        desc="bytes read per shard per step during deep scrub "
             "(bounds scrub memory/latency; osd_deep_scrub_stride)",
        min=4096,
    ),
    Option(
        "lockdep", bool, False,
        desc="arm the runtime lock-order / blocking-under-lock "
             "detector (utils/lockdep.py, the common/lockdep.cc + "
             "mutex_debug analog): DebugLock/DebugRLock construct "
             "tracked wrappers that record every acquire into a "
             "process-global lock-dependency graph, report order-"
             "inversion cycles and rank violations (cluster-log ERR "
             "+ `lockdep` perf counters + the admin-socket `lockdep` "
             "dump) WITHOUT deadlocking, and blocking_region() "
             "checkpoints flag blocking calls made while an op-"
             "serializing lock is held. Off (the default) the "
             "constructors hand back plain threading primitives — "
             "the flag is read once per lock construction, so arming "
             "applies to daemons built after the flip",
        level="dev",
    ),
    Option(
        "osd_enable_op_tracker", bool, True,
        desc="register every live operation (client op, RMW op, peer "
             "sub-op, peering pass, recovery push, backfill item) "
             "with the process OpTracker: dump_ops_in_flight shows "
             "age-sorted live ops with their event timelines and the "
             "slow-op watchdog complains past osd_op_complaint_time. "
             "Off = register() hands back a null op whose marks are "
             "one attribute access (the bench A/B's untracked arm)",
    ),
    Option(
        "osd_op_complaint_time", float, 30.0,
        desc="seconds a tracked op may stay live before the watchdog "
             "flags it slow: bumps the owning daemon's slow_ops "
             "counters (gauge + age histogram on perf dump and the "
             "exporter) and posts a WRN complaint to the cluster log "
             "(osd_op_complaint_time analog)",
        min=0.01,
    ),
    Option(
        "cluster_log_file", str, "",
        desc="JSONL sink for cluster-log events (the ceph.log file "
             "role); empty = in-memory ring only. Applied when the "
             "first event lands after the value changes",
    ),
)


class ConfigProxy:
    """Effective-value resolver + observer hub (config_proxy.h)."""

    def __init__(self, options: tuple[Option, ...] = OPTIONS) -> None:
        self._lock = threading.Lock()
        self.schema: dict[str, Option] = {o.name: o for o in options}
        self._layers: dict[str, dict[str, object]] = {
            layer: {} for layer in LAYERS
        }
        self._layers["default"] = {
            o.name: o.default for o in options
        }
        self._observers: list[tuple[str, object]] = []
        self._load_env()

    # -- layers --------------------------------------------------------
    def _load_env(self) -> None:
        for opt in self.schema.values():
            raw = os.environ.get(ENV_PREFIX + opt.name.upper())
            if raw is not None:
                self._layers["env"][opt.name] = opt.parse(raw)

    def load_file(self, path: str) -> None:
        """Load a JSON config file into the file layer."""
        with open(path) as f:
            data = json.load(f)
        for name, raw in data.items():
            opt = self._require(name)
            self.set(name, raw, layer="file")

    def _require(self, name: str) -> Option:
        opt = self.schema.get(name)
        if opt is None:
            raise KeyError(f"unknown option {name!r}")
        return opt

    # -- access --------------------------------------------------------
    def get(self, name: str):
        opt = self._require(name)
        with self._lock:
            for layer in reversed(LAYERS):
                if name in self._layers[layer]:
                    return self._layers[layer][name]
        return opt.default

    def get_source(self, name: str) -> str:
        self._require(name)
        with self._lock:
            for layer in reversed(LAYERS):
                if name in self._layers[layer]:
                    return layer
        return "default"

    def set(self, name: str, raw, layer: str = "runtime") -> None:
        opt = self._require(name)
        if layer not in LAYERS or layer == "default":
            raise ValueError(f"cannot set layer {layer!r}")
        val = opt.parse(raw)
        before = self.get(name)
        with self._lock:
            self._layers[layer][name] = val
        after = self.get(name)
        if after != before:
            self._notify(name, after)

    @contextmanager
    def override(self, **kv):
        """Temporarily set options in the runtime layer — the test
        form of ``config set``; restores prior state (including
        absence) on exit, firing observers both ways."""
        saved = {}
        with self._lock:
            for name in kv:
                layer = self._layers["runtime"]
                saved[name] = (name in layer, layer.get(name))
        try:
            # inside the try: a failing set mid-application must not
            # leak the overrides already applied
            for name, raw in kv.items():
                self.set(name, raw, layer="runtime")
            yield
        finally:
            for name, (present, old) in saved.items():
                if present:
                    self.set(name, old, layer="runtime")
                else:
                    self.rm(name, layer="runtime")

    def rm(self, name: str, layer: str = "runtime") -> None:
        self._require(name)
        before = self.get(name)
        with self._lock:
            self._layers[layer].pop(name, None)
        after = self.get(name)
        if after != before:
            self._notify(name, after)

    def show(self) -> dict:
        """Effective value + winning layer per option (config show)."""
        return {
            name: {"value": self.get(name), "source": self.get_source(name)}
            for name in sorted(self.schema)
        }

    # -- observers (config_obs.h) --------------------------------------
    def add_observer(self, prefix: str, fn) -> None:
        """``fn(name, new_value)`` fires when a matching key changes."""
        self._observers.append((prefix, fn))

    def _notify(self, name: str, value) -> None:
        for prefix, fn in self._observers:
            if name.startswith(prefix):
                fn(name, value)


# Process-global config, mirroring g_conf().
config = ConfigProxy()

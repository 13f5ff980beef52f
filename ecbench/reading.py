"""What a metric's reader is handed: the window's ops, the program's
counters across the window, the device trace of a traced run, and the
cell's shapes. A reader (``ecbench/e2e/<name>.py`` or
``ecbench/metrics/<name>.py``) defines ``read(r: Reading)`` and returns
a number, or None when it finds nothing to read: the harness then
leaves the metric out of the result line."""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class Reading:
    #: the cell's configuration and mix, as their files hold them
    config: dict
    mix: dict
    #: seconds of the measured window, on the host's clock
    window_s: float
    #: the ops that completed without error inside the window
    #: (``loop.Record``: ``op``, ``t_issue``, ``t_done``, ``data``)
    ops: list
    #: process start to the window's start, seconds
    setup_s: float
    #: the window's delta of every numeric perf counter of the program,
    #: ``{counter set: {key: delta}}``
    counters: dict
    #: ``trace.DeviceTrace`` of a traced run, else None
    trace: object | None
    #: object index -> shard ids whose OSD was killed before the window
    lost: dict
    #: the card's name, as ``torch.cuda.get_device_name()`` gives it
    device_kind: str

    @property
    def k(self) -> int:
        return int(self.config["k"])

    @property
    def m(self) -> int:
        return int(self.config["m"])

    def counter_sum(self, prefix: str, suffix: str, key: str) -> int:
        """Sum of ``key`` over every counter set named
        ``prefix...suffix`` (e.g. ``osd.`` ... ``.coalesce``)."""
        return sum(v.get(key, 0) for name, v in self.counters.items()
                   if name.startswith(prefix) and name.endswith(suffix))

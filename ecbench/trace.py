"""The traced window: torch.profiler over the card, plus a sampler of
the host's Python stacks, reduced to device intervals, busy time and a
breakdown.

Busy time is the union of the kernel, memcpy and memset intervals the
trace holds inside the window (the idle-share arithmetic of the port's
``chip_smoke.py``, ``device_busy_us``, with overlapping records counted
once). The window runs between two ``record_function`` marks, so the
host's clock and the trace's share one origin. The host sampler reads
every thread's stack every 10 ms and counts a thread as working when
its innermost frame moved since the last sample (a thread blocked in a
socket read, a lock or a sleep sits on the same instruction); an idle
gap of the device is named by the program frame sampled most often in
working threads inside it.
"""

from __future__ import annotations

import collections
import json
import os
import sys
import tempfile
import threading
import time

_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_MARK = "ecbench_window"
_NAME_CHARS = 160


def _label(frame) -> str:
    """``dir/file.py:function`` of the innermost frame of the program
    (or of the benchmark), else of the innermost frame."""
    inner = frame
    while frame is not None:
        path = frame.f_code.co_filename
        for root in ("ceph_tpu_torch", "ecbench"):
            cut = path.rfind(os.sep + root + os.sep)
            if cut >= 0:
                return f"{path[cut + 1:]}:{frame.f_code.co_name}"
        frame = frame.f_back
    return f"{os.path.basename(inner.f_code.co_filename)}:{inner.f_code.co_name}"


class HostSampler:
    def __init__(self, period_s: float = 0.01) -> None:
        self.period_s = period_s
        self.samples: list[tuple[float, collections.Counter]] = []
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._loop, name="ecbench-sampler", daemon=True)

    def _loop(self) -> None:
        me = threading.get_ident()
        last: dict[int, tuple[int, int]] = {}
        while not self._stop.wait(self.period_s):
            t = time.perf_counter()
            seen = collections.Counter()
            now: dict[int, tuple[int, int]] = {}
            for tid, frame in sys._current_frames().items():
                if tid == me:
                    continue
                where = (id(frame), frame.f_lasti)
                now[tid] = where
                if last.get(tid) != where:
                    seen[_label(frame)] += 1
            last = now
            self.samples.append((t, seen))

    def start(self) -> None:
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        self._thread.join(timeout=5.0)


class DeviceTrace:
    """Start before the window, stop after it; then read ``events``,
    ``busy_s``, ``window_s`` and ``breakdown()``."""

    def __init__(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        self._prof = profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self.sampler = HostSampler()
        self.events: list[dict] = []
        self.window_s = 0.0
        self.busy_s = 0.0
        self._t0 = self._t1 = 0.0
        self._lo = self._hi = 0.0

    def start(self) -> None:
        import torch

        self._prof.start()
        with torch.profiler.record_function(_MARK):
            self._t0 = time.perf_counter()
        self.sampler.start()

    def stop(self) -> None:
        import torch

        with torch.profiler.record_function(_MARK):
            self._t1 = time.perf_counter()
        self.sampler.stop()
        torch.cuda.synchronize()
        self._prof.stop()
        self.window_s = self._t1 - self._t0
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self._prof.export_chrome_trace(path)
            with open(path) as f:
                raw = json.load(f)
        finally:
            os.unlink(path)
        events = raw.get("traceEvents", raw) if isinstance(raw, dict) else raw
        marks = sorted(e["ts"] for e in events
                       if e.get("name") == _MARK and e.get("ph") == "X")
        if len(marks) < 2:
            raise RuntimeError("the trace lost the window's marks")
        self._lo, self._hi = marks[0], marks[-1]
        for e in events:
            if e.get("ph") != "X" or e.get("cat") not in _DEVICE_CATS:
                continue
            lo = max(float(e["ts"]), self._lo)
            hi = min(float(e["ts"]) + float(e.get("dur", 0.0)), self._hi)
            if hi > lo:
                self.events.append({
                    "name": e.get("name", ""), "cat": e["cat"],
                    "ts": lo, "dur": hi - lo,
                    "bytes": (e.get("args") or {}).get("bytes"),
                })
        self.events.sort(key=lambda e: e["ts"])
        self.busy_s = sum(hi - lo for lo, hi in self._union()) / 1e6

    def _union(self) -> list[tuple[float, float]]:
        out: list[list[float]] = []
        for e in self.events:
            lo, hi = e["ts"], e["ts"] + e["dur"]
            if out and lo <= out[-1][1]:
                out[-1][1] = max(out[-1][1], hi)
            else:
                out.append([lo, hi])
        return [(lo, hi) for lo, hi in out]

    def device_s(self, match) -> float:
        """Seconds of device time of the events whose name ``match``es."""
        return sum(e["dur"] for e in self.events if match(e["name"])) / 1e6

    def breakdown(self, top: int = 10) -> dict:
        by_name: collections.Counter = collections.Counter()
        for e in self.events:
            by_name[e["name"]] += e["dur"] / 1e6
        gaps = []
        edge = self._lo
        for lo, hi in self._union() + [(self._hi, self._hi)]:
            if lo > edge:
                gaps.append((edge, lo))
            edge = max(edge, hi)
        gaps.sort(key=lambda g: g[0] - g[1])
        named = []
        for lo, hi in gaps[:top]:
            h_lo = self._t0 + (lo - self._lo) / 1e6
            h_hi = self._t0 + (hi - self._lo) / 1e6
            seen: collections.Counter = collections.Counter()
            for t, counts in self.sampler.samples:
                if h_lo <= t <= h_hi:
                    seen.update(counts)
            what = seen.most_common(1)[0][0] if seen else "no host sample"
            named.append([what, (hi - lo) / 1e6])
        return {
            "device_ops": [[n[:_NAME_CHARS], s]
                           for n, s in by_name.most_common(top)],
            "idle_gaps": named,
        }

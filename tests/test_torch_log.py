"""The port's ring-buffered logger against ceph_tpu's, on the CPU.

Mirrors ``tests/test_log.py`` on ``ceph_tpu_torch.utils.log``: the
gather-versus-flush level split, lazy formatting, runtime level
changes, the ``dump_recent`` crash banner, the admin-socket log
commands, and an OSD daemon (``device="cpu"``) whose worker raises
dumping its ring. The twin runs one script of levels and lines through
both packages' ``Log``: the flushed sink text (timestamps and thread
names aside), the dumped ring and the level table are equal.
"""

import importlib
import io
import time

import pytest

pytest.importorskip("torch")

from ceph_tpu_torch.utils.log import (  # noqa: E402
    DEFAULT_GATHER_LEVEL,
    DEFAULT_LOG_LEVEL,
    Log,
    Logger,
)


def make_log():
    sink = io.StringIO()
    log = Log(sink=sink, max_recent=100)
    return log, sink


def wait_flushed(log, sink, needle, timeout=2.0):
    end = time.monotonic() + timeout
    while time.monotonic() < end:
        log.flush()
        if needle in sink.getvalue():
            return True
        time.sleep(0.01)
    return False


class TestLevels:
    def test_info_flushes_debug_gathers(self):
        log, sink = make_log()
        lg = Logger("osd", log)
        lg.info("visible line")
        lg.debug("ring only line")
        assert wait_flushed(log, sink, "visible line")
        assert "ring only line" not in sink.getvalue()
        # ...but the ring has it, and dump_recent surfaces it
        lines = log.dump_recent("test")
        assert any("ring only line" in x for x in lines)

    def test_deep_needs_raised_gather(self):
        log, sink = make_log()
        lg = Logger("osd", log)
        lg.deep("too deep")
        assert not log.dump_recent("t1")
        log.set_level("osd", 0, 10)
        lg.deep("now gathered")
        assert any("now gathered" in x for x in log.dump_recent("t2"))

    def test_runtime_level_raise_flushes_debug(self):
        log, sink = make_log()
        lg = Logger("ec", log)
        log.set_level("ec", 5)
        lg.debug("debug now flushed")
        assert wait_flushed(log, sink, "debug now flushed")

    def test_levels_are_per_subsystem(self):
        log, _ = make_log()
        log.set_level("osd", 5, 20)
        assert log.levels("osd") == (5, 20)
        assert log.levels("mon") == (
            DEFAULT_LOG_LEVEL, DEFAULT_GATHER_LEVEL
        )
        assert log.dump_levels()["osd"] == "5/20"


class TestLazyFormatting:
    def test_suppressed_line_never_formats(self):
        log, _ = make_log()
        lg = Logger("osd", log)

        class Boom:
            def __str__(self):
                raise AssertionError("formatted a suppressed line")

        lg.deep("ctx", Boom())  # prio 10 > gather 5: dropped unformatted

    def test_gathered_line_formats_at_dump(self):
        log, _ = make_log()
        lg = Logger("osd", log)
        calls = []

        class Probe:
            def __str__(self):
                calls.append(1)
                return "probe"

        lg.debug("ctx", Probe())
        assert not calls  # gathered, not yet rendered
        log.dump_recent("t")
        assert calls


class TestDumpRecent:
    def test_banner_and_order(self):
        log, sink = make_log()
        lg = Logger("osd", log)
        for i in range(5):
            lg.debug(f"event {i}")
        log.dump_recent("unit test")
        out = sink.getvalue()
        assert "begin dump of recent events (unit test)" in out
        assert out.index("event 0") < out.index("event 4")
        assert "end dump of recent events (5)" in out

    def test_ring_is_bounded(self):
        log, _ = make_log()  # max_recent=100
        lg = Logger("osd", log)
        for i in range(500):
            lg.debug(f"e{i}")
        lines = log.dump_recent("t")
        assert len(lines) == 100
        assert "e499" in lines[-1]

    def test_broken_sink_never_raises(self):
        class BadSink:
            def write(self, s):
                raise OSError("disk full")

            def flush(self):
                raise OSError("disk full")

        log = Log(sink=BadSink(), max_recent=10)
        lg = Logger("osd", log)
        lg.info("x")
        log.dump_recent("t")  # must not raise


class TestAdminSurface:
    def test_log_commands(self):
        from ceph_tpu_torch.utils.admin_socket import admin_socket

        assert admin_socket.execute(
            "log set", subsys="testsub", level=3, gather=12
        ) == "3/12"
        levels = admin_socket.execute("log levels")
        assert levels["testsub"] == "3/12"
        admin_socket.execute("log flush")
        lines = admin_socket.execute("log dump", reason="unit")
        assert isinstance(lines, list)


class TestDaemonCrashPath:
    def test_worker_exception_dumps_ring(self, tmp_path):
        """An unexpected exception on the OSD worker dumps the gather
        ring to the log sink (the crash-context contract)."""
        from ceph_tpu_torch.cluster.monitor import Monitor
        from ceph_tpu_torch.cluster.osd_daemon import OSDDaemon
        from ceph_tpu_torch.utils.log import root_log

        sink = io.StringIO()
        old_levels = dict(root_log._levels)
        root_log.set_sink(sink)
        try:
            mon = Monitor(device="cpu")
            mon.osd_crush_add(0, zone="z0")
            osd = OSDDaemon(0, mon, device="cpu")
            osd.start()
            try:
                osd.log.debug("context before the fault")
                osd._schedule("client", lambda: 1 / 0)
                end = time.monotonic() + 3
                while (
                    "begin dump of recent events" not in sink.getvalue()
                    and time.monotonic() < end
                ):
                    time.sleep(0.02)
                out = sink.getvalue()
                assert "unexpected worker exception" in out
                assert "begin dump of recent events" in out
                assert "context before the fault" in out
            finally:
                osd.stop()
        finally:
            import sys

            root_log.set_sink(sys.stderr)
            root_log._levels = old_levels


# -- twin ------------------------------------------------------------------

def _log_script(root):
    mod = importlib.import_module(f"{root}.utils.log")
    sink = io.StringIO()
    log = mod.Log(sink=sink, max_recent=5)
    osd, ec = mod.Logger("osd", log), mod.Logger("ec", log)
    osd.info("visible", 1, {"k": 2})
    osd.debug("ring only")
    ec.deep("too deep")
    log.set_level("ec", 5, 20)
    ec.debug("now flushed")
    ec.deep("gathered", [3])
    for i in range(6):
        osd.debug("fill", i)
    log.flush()
    body = lambda lines: [ln.split(" ", 2)[-1] for ln in lines]  # noqa: E731
    return (body(sink.getvalue().splitlines()),
            body(log.dump_recent("twin")[1:-1]),
            {k: v for k, v in log._levels.items() if k in ("osd", "ec")})


def test_log_script_equals_the_reference():
    ref, port = (_log_script(r) for r in ("ceph_tpu", "ceph_tpu_torch"))
    assert port == ref
    assert any("now flushed" in ln for ln in port[0])

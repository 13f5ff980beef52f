"""The port's native host tier (``ceph_tpu_torch/native``) against the
Python oracles and against ``ceph_tpu.native``, byte for byte
(tolerance 0), on the CPU: the C++ source is the reference's with the
same C ABI, built by the port's own loader into the port's build
directory.

The cases mirror ``tests/test_native.py`` (crc32c against the oracle,
chaining, unaligned offsets, the GF region ops and ``gf_matrix_encode``,
the host dispatch being native, the ring's FIFO, full, overflow,
threads and close cases); each also runs the same inputs through
``ceph_tpu.native`` and, for the frame codec, ``ceph_tpu``'s wire
encoder on its native and pure-Python paths.
"""

import os
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from ceph_tpu import native as ref_native  # noqa: E402
from ceph_tpu.msg import wire as ref_wire  # noqa: E402
from ceph_tpu.utils.config import config as ref_config  # noqa: E402
from ceph_tpu_torch import native  # noqa: E402
from ceph_tpu_torch.checksum.reference import crc32c_ref  # noqa: E402
from ceph_tpu_torch.gf.tables import gf_mul  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True)
def _native_tier():
    # decided in a fixture, never at import: every worker collects the
    # same tests whether or not g++ is present
    if not native.available():
        pytest.skip("no C++ toolchain: " + native.build_log[-300:])


class TestCrc32c:
    def test_matches_oracle(self, rng):
        for n in (0, 1, 7, 8, 9, 63, 64, 1000, 4096):
            data = rng.integers(0, 256, n, np.uint8).tobytes()
            for init in (0xFFFFFFFF, 0, 0x12345678):
                want = crc32c_ref(init, data)
                assert native.crc32c(init, data) == want, n
                assert native.crc32c_bytes(init, data) == want, n
                assert ref_native.crc32c(init, data) == want, n

    def test_chaining(self, rng):
        """Cumulative chaining (the HashInfo pattern) must compose."""
        a = rng.integers(0, 256, 1000, np.uint8).tobytes()
        b = rng.integers(0, 256, 999, np.uint8).tobytes()
        assert native.crc32c(
            native.crc32c(0xFFFFFFFF, a), b
        ) == crc32c_ref(crc32c_ref(0xFFFFFFFF, a), b)

    def test_unaligned_offsets(self, rng):
        buf = rng.integers(0, 256, 4096, np.uint8)
        for off in range(1, 9):
            view = np.ascontiguousarray(buf[off:])
            want = crc32c_ref(0xFFFFFFFF, view.tobytes())
            assert native.crc32c(0xFFFFFFFF, view) == want
            assert ref_native.crc32c(0xFFFFFFFF, view) == want


class TestGfRegionOps:
    def test_xor_region(self, rng):
        a = rng.integers(0, 256, 1027, np.uint8)
        b = rng.integers(0, 256, 1027, np.uint8)
        dst, ref_dst = a.copy(), a.copy()
        native.xor_region(dst, b)
        ref_native.xor_region(ref_dst, b)
        assert (dst == a ^ b).all() and (dst == ref_dst).all()

    @pytest.mark.parametrize("accumulate", [False, True])
    def test_mul_region_matches_table(self, rng, accumulate):
        src = rng.integers(0, 256, 515, np.uint8)
        base = rng.integers(0, 256, 515, np.uint8)
        for c in (0, 1, 2, 0x53, 0xFF):
            dst, ref_dst = base.copy(), base.copy()
            native.gf_mul_region(dst, src, c, accumulate=accumulate)
            ref_native.gf_mul_region(ref_dst, src, c, accumulate=accumulate)
            expect = np.array([gf_mul(c, int(v)) for v in src], np.uint8)
            if accumulate:
                expect ^= base
            assert (dst == expect).all(), c
            assert (dst == ref_dst).all(), c

    def test_matrix_encode_matches_device_and_reference(self, rng):
        """Host native encode == the plain bit-plane engine == ceph_tpu's
        native encode."""
        from ceph_tpu_torch.gf import (
            gf_matrix_to_bitmatrix,
            vandermonde_rs_matrix,
        )
        from ceph_tpu_torch.ops.bitplane import gf_encode_bitplane

        k, m, n = 6, 3, 2048
        g = vandermonde_rs_matrix(k, m)
        data = rng.integers(0, 256, (k, n), np.uint8)
        parity = native.gf_matrix_encode(g[k:, :], data)
        bmat = gf_matrix_to_bitmatrix(g[k:, :])
        expect = gf_encode_bitplane(bmat, torch.from_numpy(data)).numpy()
        assert (parity == expect).all()
        assert (parity == ref_native.gf_matrix_encode(g[k:, :], data)).all()


class TestHostDispatch:
    def test_host_dispatch_is_native_here(self, rng):
        from ceph_tpu.checksum import host as ref_host
        from ceph_tpu_torch.checksum import host

        data = rng.integers(0, 256, 4097, np.uint8).tobytes()
        assert host.native_selected()
        for fn in (host.crc32c, host.crc32c_wire):
            assert fn(0xFFFFFFFF, data) == ref_host.crc32c(0xFFFFFFFF, data)

    def test_host_facade_records_host_backend(self, rng):
        from ceph_tpu.checksum import crc32c_scalar as ref_scalar
        from ceph_tpu_torch.checksum import backends, crc32c_scalar

        data = rng.integers(0, 256, 3000, np.uint8)
        backends.reset()
        got = crc32c_scalar(0xFFFFFFFF, data)
        assert got == ref_scalar(0xFFFFFFFF, data)
        assert backends.counts() == {"host": 1}

    @pytest.mark.parametrize("lead", [(), (3,), (2, 2)])
    def test_gf_apply_bytes_host_native_matches_reference(self, rng, lead):
        from ceph_tpu.gf.tables import gf_apply_bytes_host as ref_apply
        from ceph_tpu_torch.gf import isa_rs_matrix
        from ceph_tpu_torch.gf.tables import gf_apply_bytes_host

        mat = isa_rs_matrix(5, 3)[5:]
        data = rng.integers(0, 256, lead + (5, 777), np.uint8)
        calls = []
        real = native.gf_matrix_encode

        def counted(*args):
            calls.append(1)
            return real(*args)

        native.gf_matrix_encode = counted
        try:
            got = gf_apply_bytes_host(mat, data)
        finally:
            native.gf_matrix_encode = real
        assert len(calls) == int(np.prod(lead, dtype=int))
        assert np.array_equal(got, ref_apply(mat, data))

    def test_switch_keeps_the_python_paths(self, rng):
        """CEPH_TPU_TORCH_NO_NATIVE (not ceph_tpu's switch) keeps the
        pure-Python host paths, bit-identical."""
        code = (
            "import sys, numpy as np\n"
            f"sys.path.insert(0, {str(ROOT)!r})\n"
            "from ceph_tpu_torch import native\n"
            "from ceph_tpu_torch.checksum import host\n"
            "from ceph_tpu_torch.gf.tables import gf_apply_bytes_host\n"
            "m = np.array([[1, 2], [3, 4]], np.uint8)\n"
            "d = np.arange(2 * 64, dtype=np.uint8).reshape(2, 64)\n"
            "print(native.available(), host.native_selected(),"
            " host.crc32c(0xFFFFFFFF, b'switch'),"
            " gf_apply_bytes_host(m, d).sum())\n"
        )
        env = dict(os.environ, **{native.NO_NATIVE_ENV: "1"})
        out = subprocess.run(
            [sys.executable, "-c", code], capture_output=True, text=True,
            timeout=120, check=True, env=env,
        ).stdout.split()
        from ceph_tpu_torch.gf.tables import gf_apply_bytes_host

        m = np.array([[1, 2], [3, 4]], np.uint8)
        d = np.arange(2 * 64, dtype=np.uint8).reshape(2, 64)
        assert out == ["False", "False",
                       str(crc32c_ref(0xFFFFFFFF, b"switch")),
                       str(gf_apply_bytes_host(m, d).sum())]


FRAME_CASES = [
    [b"x"],
    [b""],
    [b"payload" * 500],
    [b"a", b"", b"bb", b"ccc"],
    [bytes(range(256)) * 16] * 4,
    [b"\x00" * 4096, b"\xff" * 333],
]


class TestFrameCodec:
    @pytest.mark.parametrize("segs", FRAME_CASES)
    def test_frame_bytes_equal_the_reference(self, segs):
        got = native.frame_encode(9, 0, 77, segs)
        assert got == ref_native.frame_encode(9, 0, 77, segs)
        for native_codec in (True, False):
            with ref_config.override(msgr_native_codec=native_codec):
                assert got == ref_wire.encode_frame(9, 77, segs)


class TestRingBuffer:
    def test_fifo_and_lengths(self):
        ring = native.RingBuffer(4, 64)
        assert ring.push(b"one") and ring.push(b"two" * 10)
        assert len(ring) == 2
        assert ring.pop() == b"one"
        assert ring.pop() == b"two" * 10
        assert ring.pop(blocking=False) is None
        assert ring.total_pushed == 2

    def test_nonblocking_full(self):
        ring = native.RingBuffer(2, 16)
        assert ring.push(b"a", blocking=False)
        assert ring.push(b"b", blocking=False)
        assert not ring.push(b"c", blocking=False)

    def test_slot_overflow(self):
        ring = native.RingBuffer(2, 8)
        with pytest.raises(ValueError):
            ring.push(b"x" * 9)

    def test_producer_consumer_threads(self):
        ring = native.RingBuffer(8, 32)
        n = 200
        got = []

        def consumer():
            while True:
                item = ring.pop()
                if item is None:
                    return
                got.append(item)

        t = threading.Thread(target=consumer)
        t.start()
        for i in range(n):
            ring.push(f"item-{i}".encode())
        ring.close()
        t.join(timeout=10)
        assert not t.is_alive()
        assert got == [f"item-{i}".encode() for i in range(n)]

    def test_close_unblocks(self):
        ring = native.RingBuffer(1, 8)
        out = []
        t = threading.Thread(target=lambda: out.append(ring.pop()))
        t.start()
        ring.close()
        t.join(timeout=5)
        assert not t.is_alive()
        assert out == [None]

    def test_slots_equal_the_reference_ring(self, rng):
        """The same pushes through both packages' rings pop the same
        slots in the same order."""
        items = [rng.integers(0, 256, int(rng.integers(0, 65)),
                              np.uint8).tobytes() for _ in range(16)]
        ours, theirs = native.RingBuffer(16, 64), ref_native.RingBuffer(16, 64)
        for item in items:
            assert ours.push(item) and theirs.push(item)
        assert [ours.pop() for _ in items] == [theirs.pop() for _ in items]

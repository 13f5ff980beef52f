"""Import hygiene and device discipline of ceph_tpu_torch.

- No module of the package, and not ``chip_smoke.py`` or the port's
  experiment scripts, imports JAX or
  anything of ceph_tpu: checked on the source (every import statement)
  and in a fresh interpreter (this suite's conftest imports JAX, so
  ``sys.modules`` is only meaningful in a subprocess). ``ceph_tpu_torch``
  starts with ``ceph_tpu``: the check is for the module ``ceph_tpu`` and
  the prefix ``ceph_tpu.``.
- Entry points default to the card: without one they raise instead of
  running on the CPU; ``device="cpu"`` is the only way onto the plain
  path.
- Every configuration option is read somewhere in the package.
- Every kernel binding's ctypes signature (``kernels.py``) matches its C
  entry point in ``csrc/``, the stream included: a pointer or 64-bit
  integer passed without its type reaches C as a truncated int.
"""

import ast
import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parent.parent
PKG = ROOT / "ceph_tpu_torch"
SOURCES = sorted(PKG.rglob("*.py")) + [
    ROOT / "chip_smoke.py",
    ROOT / "experiments" / "torch_slice_breakdown.py",
    ROOT / "experiments" / "torch_kernel_variants.py",
]


def _forbidden(name: str) -> bool:
    return (
        name in ("jax", "jaxlib", "ceph_tpu")
        or name.startswith(("jax.", "jaxlib.", "ceph_tpu."))
    )


@pytest.mark.parametrize(
    "path", SOURCES, ids=[str(p.relative_to(ROOT)) for p in SOURCES]
)
def test_source_imports_no_jax_or_reference(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        bad = [n for n in names if _forbidden(n)]
        assert not bad, f"{path.name}:{node.lineno} imports {bad}"


def _option_names():
    from ceph_tpu_torch.utils.config import OPTIONS

    return [o.name for o in OPTIONS]


@pytest.mark.parametrize("name", _option_names())
def test_every_option_has_a_reader(name):
    """The schema holds only options the package reads: a declared
    option that nothing reads is accepted and silently does nothing."""
    config_py = PKG / "utils" / "config.py"
    readers = [p for p in PKG.rglob("*.py") if p != config_py
               and re.search(rf"[\"']{name}[\"']", p.read_text())]
    assert readers, f"option {name} is declared but never read"


def test_fresh_interpreter_loads_no_jax_or_reference():
    modules = sorted(
        ".".join(p.relative_to(ROOT).with_suffix("").parts).removesuffix(
            ".__init__")
        for p in PKG.rglob("*.py")
    )
    code = (
        "import importlib, json, sys\n"
        f"sys.path.insert(0, {str(ROOT)!r})\n"
        f"for m in {modules!r}: importlib.import_module(m)\n"
        "import chip_smoke\n"
        "print(json.dumps(sorted(sys.modules)))\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        timeout=120, check=True, cwd=ROOT,
    ).stdout
    loaded = json.loads(out.strip().splitlines()[-1])
    for name in (
        "ceph_tpu_torch.codecs.isa", "ceph_tpu_torch.codecs.shec",
        "ceph_tpu_torch.checksum.u64", "ceph_tpu_torch.checksum.xxhash",
        "ceph_tpu_torch.pipeline.rmw", "ceph_tpu_torch.pipeline.recovery",
        "ceph_tpu_torch.pipeline.extent_cache", "ceph_tpu_torch.pipeline.pglog",
        "ceph_tpu_torch.pipeline.inject", "ceph_tpu_torch.store.memstore",
        "ceph_tpu_torch.store.transaction", "ceph_tpu_torch.utils.lockdep",
        "ceph_tpu_torch.utils.cluster_log", "ceph_tpu_torch.utils.crash_points",
        "ceph_tpu_torch.utils.optracker", "ceph_tpu_torch.utils.trace",
        "ceph_tpu_torch.native", "ceph_tpu_torch.pipeline.dispatcher",
        "ceph_tpu_torch.store.blockstore", "ceph_tpu_torch.store.filestore",
        "ceph_tpu_torch.store.kvstore", "ceph_tpu_torch.store.devicefs",
        "ceph_tpu_torch.store.allocator", "ceph_tpu_torch.store.framed_log",
        "ceph_tpu_torch.codecs.example", "ceph_tpu_torch.placement",
        "ceph_tpu_torch.crush", "ceph_tpu_torch.utils.log",
        "ceph_tpu_torch.utils.mclock", "ceph_tpu_torch.utils.reserver",
        "ceph_tpu_torch.utils.admin_socket", "ceph_tpu_torch.msg.wire",
        "ceph_tpu_torch.msg.secure", "ceph_tpu_torch.msg.shm_ring",
        "ceph_tpu_torch.msg.messages", "ceph_tpu_torch.msg.messenger",
        "ceph_tpu_torch.msg.shard_server", "ceph_tpu_torch.cluster.osdmap",
        "ceph_tpu_torch.cluster.pgmap", "ceph_tpu_torch.cluster.monitor",
        "ceph_tpu_torch.cluster.peering", "ceph_tpu_torch.cluster.qos",
        "ceph_tpu_torch.cluster.osd_daemon",
        "ceph_tpu_torch.cluster.objecter", "ceph_tpu_torch.cluster.mgr",
        "ceph_tpu_torch.cluster.striper", "ceph_tpu_torch.cluster.paxos",
        "ceph_tpu_torch.cluster.mon_quorum",
        "ceph_tpu_torch.cluster.mon_store", "ceph_tpu_torch.utils.exporter",
        "ceph_tpu_torch.utils.trace_assembly", "ceph_tpu_torch.bench_cli",
        "ceph_tpu_torch.loadgen", "ceph_tpu_torch.loadgen.bench_phase",
        "ceph_tpu_torch.loadgen.cluster", "ceph_tpu_torch.loadgen.driver",
        "ceph_tpu_torch.loadgen.faults", "ceph_tpu_torch.loadgen.forensics",
        "ceph_tpu_torch.loadgen.histogram", "ceph_tpu_torch.loadgen.recorder",
        "ceph_tpu_torch.loadgen.spec",
    ):
        assert name in loaded
    assert [m for m in loaded if _forbidden(m)] == []


HOST_TIER = sorted(
    [*(PKG / "native").rglob("*.py"), *(PKG / "native" / "src").glob("*.cc"),
     PKG / "pipeline" / "dispatcher.py", *(PKG / "store").glob("*.py"),
     PKG / "checksum" / "host.py", *(PKG / "msg").glob("*.py")]
)


@pytest.mark.parametrize(
    "path", HOST_TIER, ids=[str(p.relative_to(ROOT)) for p in HOST_TIER]
)
def test_host_tier_keeps_its_own_switch(path):
    """The native tier, the dispatcher, the stores and the messenger
    (its native frame codec and ring lane) read the port's switch (CEPH_TPU_TORCH_NO_NATIVE), never ceph_tpu's, and name no
    module of ceph_tpu or JAX even in a string (an importlib call)."""
    text = path.read_text()
    assert not re.search(r"CEPH_TPU_NO_NATIVE", text)
    assert not re.search(r"[\"'](jax|ceph_tpu)(\.[\w.]*)?[\"']", text)


def test_native_switch_is_the_ports_own():
    from ceph_tpu_torch import native

    assert native.NO_NATIVE_ENV == "CEPH_TPU_TORCH_NO_NATIVE"
    build = Path(native._BUILD_DIR).resolve()
    assert build.is_relative_to((PKG / "_build").resolve())
    ignored = (ROOT / ".gitignore").read_text().split()
    assert "ceph_tpu_torch/_build/" in ignored


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_default_device_entry_points_raise_without_a_card(no_card):
    from ceph_tpu_torch.checksum import Checksummer, crc32c_device
    from ceph_tpu_torch.codecs import create_codec, registry
    from ceph_tpu_torch.pipeline import HashInfo

    with pytest.raises(RuntimeError, match="no CUDA device"):
        registry.factory("isa", {"k": "4", "m": "2"})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        create_codec("isa", k="4", m="2")
    for plugin, profile in (("jerasure", {"technique": "liberation"}),
                            ("lrc", {"k": "4", "m": "2", "l": "3"}),
                            ("xor", {"k": "3"}),
                            ("clay", {"k": "8", "m": "4", "d": "11"})):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            registry.factory(plugin, profile)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Checksummer("crc32c", 4096)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        HashInfo(6)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        crc32c_device(np.zeros((2, 4096), np.uint8))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        registry.factory("shec", {"k": "4", "m": "3", "c": "2"})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Checksummer("xxhash64", 4096)
    from ceph_tpu_torch.checksum import xxh32_device

    with pytest.raises(RuntimeError, match="no CUDA device"):
        xxh32_device(np.zeros((2, 4096), np.uint8))
    from ceph_tpu_torch.pipeline import StripeInfo, be_deep_scrub
    from ceph_tpu_torch.pipeline.rmw import HINFO_KEY, ShardBackend
    from ceph_tpu_torch.store import MemStore, Transaction

    stores = {s: MemStore() for s in range(6)}
    for st in stores.values():
        st.queue_transactions(Transaction().touch("o").setattr(
            "o", HINFO_KEY, b'{"total_chunk_size": 0, "hashes": [0]}'))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        be_deep_scrub(StripeInfo(4, 2, 16384), ShardBackend(stores), "o")
    # the cluster tier: a monitor validates profiles on its device, an
    # OSD daemon runs every PG's codec, HashInfo and scrub on its own
    from ceph_tpu_torch.cluster import Monitor, OSDDaemon

    with pytest.raises(RuntimeError, match="no CUDA device"):
        Monitor()
    mon = Monitor(device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        OSDDaemon(0, mon)
    assert OSDDaemon(0, mon, device="cpu").device == torch.device("cpu")
    # asking for the CPU is the way onto the plain path
    codec = registry.factory("isa", {"k": "4", "m": "2"}, device="cpu")
    assert codec.device == torch.device("cpu")
    # the replicated monitor, the load generator's cluster and the bench
    # CLI (whose --device defaults to cuda)
    from ceph_tpu_torch import bench_cli
    from ceph_tpu_torch.cluster.mon_quorum import MonQuorumService
    from ceph_tpu_torch.loadgen import LoadCluster
    from ceph_tpu_torch.loadgen.bench_phase import hol_probe_ms

    with pytest.raises(RuntimeError, match="no CUDA device"):
        MonQuorumService(3)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LoadCluster(n_osds=3, k=2, m=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        hol_probe_ms(1)
    for argv in (["encode", "--size", "4096"], ["repair", "--size", "4096"],
                 ["checksum", "--size", "4096"],
                 ["loadgen", "--smoke"]):
        args = bench_cli.parse_args(argv)
        assert args.device == "cuda"
        with pytest.raises(RuntimeError, match="no CUDA device"):
            bench_cli.run(args)


@pytest.mark.parametrize("kw", [
    {"use_mesh": True}, {"use_mesh": True, "mesh_devices": 1},
    {"dcn_hosts": 2}, {"dcn_hosts": 1, "dcn_devices_per_host": 4},
], ids=lambda kw: ",".join(f"{k}={v}" for k, v in kw.items()))
def test_multi_device_options_raise_instead_of_running_on_one(kw):
    """The dispatch mesh and the DCN cluster belong to the multi-device
    tier, which is not ported: LoadCluster refuses them before it boots
    anything, on either device, rather than serve on one device."""
    from ceph_tpu_torch.loadgen import LoadCluster

    for device in ("cpu", "cuda"):
        with pytest.raises(NotImplementedError, match="multi-device"):
            LoadCluster(n_osds=3, k=2, m=1, device=device, **kw)
    cluster = LoadCluster.__new__(LoadCluster)
    with pytest.raises(NotImplementedError, match="multi-device"):
        cluster.kill_dcn_host(1)


def test_codec_without_device_refuses_host_input():
    from ceph_tpu_torch.codecs.isa import ErasureCodeIsa
    from ceph_tpu_torch.utils import config

    codec = ErasureCodeIsa()
    codec.init({"k": "4", "m": "2"})
    data = {i: np.zeros(4096, np.uint8) for i in range(4)}
    with config.override(ec_host_dispatch_bytes=0):
        with pytest.raises(RuntimeError, match="no device"):
            codec.encode_chunks(data)


def test_kernel_wrappers_never_run_plain_for_a_device_tensor():
    from ceph_tpu_torch.checksum.cuda_crc import crc32c_blocks
    from ceph_tpu_torch.gf import gf_matrix_to_bitmatrix, isa_rs_matrix
    from ceph_tpu_torch.ops import clay_repair, cuda_encode, cuda_xor

    bm = gf_matrix_to_bitmatrix(isa_rs_matrix(4, 2)[4:])
    rows = ((0, 1), (2, 3))
    meta = torch.empty((2, 4, 4096), dtype=torch.uint8, device="meta")
    for call in (
        lambda: cuda_encode.gf_apply(bm, meta),
        lambda: cuda_encode.gf_apply_shards(bm, list(meta.unbind(1))),
        lambda: cuda_encode.gf_apply_csum(bm, meta, 1024),
        lambda: crc32c_blocks(meta[:, 0], 0),
        lambda: cuda_xor.xor_schedule_apply(rows, meta),
        lambda: cuda_xor.xor_schedule_apply_shards(
            rows, list(meta.unbind(1)), 1),
        lambda: clay_repair.uncoupled_rows(
            2, (1,), (("r", "r"),), ((3, 2), (3, 2)),
            list(meta[:, :2].unbind(1)), 2, 2048),
        lambda: clay_repair.couple_scatter(
            2, 0, ("r", "r"), ((143, 142), (142, 143)),
            list(meta[:, :2].unbind(1)), [meta[:, 2]], 1, 2, 2048),
    ):
        with pytest.raises(ValueError, match="unsupported device"):
            call()


def _c_params(source: str, symbol: str) -> list[str]:
    text = (PKG / "csrc" / f"{source}.cu").read_text()
    m = re.search(r'extern "C" int ' + symbol + r"\((.*?)\)\s*\{", text, re.S)
    assert m, f"no C entry point {symbol} in {source}.cu"
    return [" ".join(p.split()) for p in m.group(1).split(",")]


def _ctype(param: str):
    if "*" in param:
        return ctypes.c_void_p
    kind = param.rsplit(" ", 1)[0]
    return {"int": ctypes.c_int, "long long": ctypes.c_longlong,
            "unsigned int": ctypes.c_uint}[kind]


def _bindings():
    from ceph_tpu_torch import kernels

    return kernels.ALL


@pytest.mark.parametrize("kern", _bindings(), ids=lambda k: k.symbol)
def test_kernel_bindings_match_the_sources(kern):
    params = _c_params(kern.source, kern.symbol)
    assert params[-1] == "void* stream"
    assert [_ctype(p) for p in params] == list(kern.argtypes)


def test_launch_and_backend_counts_hold_under_threads(monkeypatch):
    """The cluster tier launches and hashes from many threads at once
    (op workers, coalesce groups, recovery, the dispatcher): no
    increment of a kernel's ``launches`` or of a checksum backend count
    may be lost. More threads than cores, a short switch interval."""
    import threading
    from types import SimpleNamespace

    from ceph_tpu_torch import kernels
    from ceph_tpu_torch.checksum import backends

    kern = kernels.Kernel("none", "none", [])
    monkeypatch.setattr(kern, "_load", lambda: lambda *args: 0)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda *a: SimpleNamespace(cuda_stream=0))
    saved = backends.counts()
    backends.reset()
    threads_n, calls = 32, 2000
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(calls):
                kern()
                backends.record("kernel", 4096)

        threads = [threading.Thread(target=work) for _ in range(threads_n)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
        assert not any(th.is_alive() for th in threads)
    finally:
        sys.setswitchinterval(interval)
    try:
        assert kern.launches == threads_n * calls
        assert backends.counts() == {"kernel": threads_n * calls}
        assert backends.bytes_hashed() == {"kernel": threads_n * calls * 4096}
    finally:
        backends.reset()
        for name, n in saved.items():
            for _ in range(n):
                backends.record(name)

"""Multi-process DCN tier: worker hosts joined by ``torch.distributed``
under the socket messenger's control plane.

The reference scales past one host with AsyncMessenger carrying
MOSDECSubOpWrite/Read between OSD processes over the data-center
network. ``ceph_tpu`` maps that onto N jax multi-controller processes;
this module keeps its layout with torch:

- N OS processes ("hosts"), each owning ``devices_per_host`` devices
  of one (dp, sp) mesh. ``dp`` (stripe batch) is intra-host and ``sp``
  (the EC shard axis) spans hosts: host r holds shard block r.
- Each host computes its block's partial parity on each of its
  devices with Kernel A (``ops.cuda_encode.gf_apply``), then the
  partials combine across hosts with the schedule of
  ``collectives.ring_schedule`` (reduce-scatter + all-gather), each hop a
  send over a ``torch.distributed`` process group (the all-reduce
  schedule when the lane axis does not split into one slice a host).
- The backend is the caller's explicit choice. ``gloo`` carries host
  tensors, so each cross-host hop goes through host memory — what a
  DCN link is, and what one card shared by several ranks needs (NCCL
  refuses two ranks on one GPU). ``nccl`` carries the CUDA tensors
  directly and needs a GPU a rank.
- The framed socket messenger carries the control plane: the
  coordinator broadcasts identical op metadata to every host, each
  with its own shard-slice payload, and the hosts answer with their
  ``ec_dispatch`` counter deltas and Kernel A launch counts (rank 0
  with the result bytes).

The coordinator (``DcnCluster``) runs in the caller's process and does
not join the process group; workers are subprocesses running
``python -m ceph_tpu_torch.parallel.dcn``.
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys
import threading
import time

import numpy as np
import torch
import torch.distributed as dist

HELLO_TIMEOUT = 90.0
OP_TIMEOUT = 180.0
BACKENDS = ("gloo", "nccl")


# ---------------------------------------------------------------- worker
class _HostGroup:
    """This host's side of the cross-host sp axis: ring hops to rank+1,
    from rank-1, over the process group."""

    def __init__(self, rank: int, n: int, backend: str, devices: list):
        self.rank, self.n, self.backend = rank, n, backend
        self.devices = devices

    def _wire(self, x):
        # gloo carries host tensors: the hop goes through host memory
        return x.cpu() if self.backend == "gloo" else x.contiguous()

    def _exchange(self, x, dev):
        """Send ``x`` to rank+1 and receive rank-1's into a new buffer
        on ``dev``."""
        send = self._wire(x)
        recv = torch.empty_like(send)
        ops = [dist.P2POp(dist.isend, send, (self.rank + 1) % self.n),
               dist.P2POp(dist.irecv, recv, (self.rank - 1) % self.n)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        out = torch.empty(recv.shape, dtype=recv.dtype, device=dev)
        out.copy_(recv)
        return out

    def reduce(self, part):
        """The XOR of every host's ``part`` (same shape on each), on
        ``part``'s device: ring reduce-scatter + all-gather when the
        lane axis splits into n slices, else the all-reduce."""
        n, d, dev = self.n, self.rank, part.device
        if n == 1:
            return part
        lanes = part.shape[-1]
        if lanes % n:
            wire = self._wire(part)
            got = [torch.empty_like(wire) for _ in range(n)]
            dist.all_gather(got, wire)
            acc = part.clone()
            for j, g in enumerate(got):
                if j != d:
                    acc.bitwise_xor_(g.to(dev))
            return acc
        from .collectives import ring_schedule

        return ring_schedule(
            n, [d], [part], lambda xs: [self._exchange(xs[0], dev)])[0]

    def apply(self, bm_np: np.ndarray, local: np.ndarray) -> np.ndarray:
        """This host's share of one [8R, 8C] apply over [B, C, N]:
        ``local`` is its [B, C/n, N] shard block. Every host returns
        the full [B, R, N] result."""
        from .mesh import apply_block, place

        b, cb, lanes = local.shape
        dp = len(self.devices)
        fold = b % dp != 0
        if fold:
            if lanes % dp:
                raise ValueError(
                    f"batch {b} and lanes {lanes} both unsplittable by "
                    f"dp={dp}"
                )
            local = (local.reshape(b, cb, dp, lanes // dp)
                     .transpose(0, 2, 1, 3)
                     .reshape(b * dp, cb, lanes // dp))
        bb = local.shape[0] // dp
        cols = bm_np[:, self.rank * cb * 8:(self.rank + 1) * cb * 8]
        rows = []
        for i, dev in enumerate(self.devices):
            part = apply_block(cols, place(local[i * bb:(i + 1) * bb], dev))
            rows.append(self.reduce(part).cpu().numpy())
        out = np.concatenate(rows, axis=0)
        if fold:
            r = out.shape[1]
            out = (out.reshape(b, dp, r, lanes // dp)
                   .transpose(0, 2, 1, 3)
                   .reshape(b, r, lanes))
        return out


def _worker_main(argv: list[str]) -> None:
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--nprocs", type=int, required=True)
    ap.add_argument("--dist", required=True)     # process-group address
    ap.add_argument("--devices", type=int, required=True)  # per host
    ap.add_argument("--device", required=True)   # cuda or cpu
    ap.add_argument("--backend", required=True, choices=BACKENDS)
    ap.add_argument("--ctrl", required=True)     # messenger host:port
    args = ap.parse_args(argv)

    from ceph_tpu_torch.codecs.bitmatrix_codec import BitMatrixCodec
    from ceph_tpu_torch.codecs.matrix_codec import dispatch_counters
    from ceph_tpu_torch.codecs.registry import registry
    from ceph_tpu_torch.kernels import GF_APPLY
    from ceph_tpu_torch.msg.messages import DcnCmd, DcnHello, DcnReply
    from ceph_tpu_torch.msg.messenger import Messenger
    from ceph_tpu_torch.utils.device import resolve_device

    dev = resolve_device(args.device)
    if args.backend == "nccl":
        dev = torch.device("cuda", args.rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    dist.init_process_group(
        args.backend, init_method=args.dist, world_size=args.nprocs,
        rank=args.rank,
    )
    group = _HostGroup(args.rank, args.nprocs, args.backend,
                       [dev] * args.devices)

    msgr = Messenger(f"dcn-host-{args.rank}")
    done = threading.Event()

    def snap():
        pc = dispatch_counters()
        return {kk: pc.get(kk) for kk in pc.dump()}

    codecs: dict[tuple, object] = {}

    def get_codec(meta: dict):
        """One codec instance per (plugin, profile) for the worker's
        lifetime: its decode-table cache stays warm across commands."""
        key = (meta["plugin"], tuple(sorted(meta["profile"].items())))
        if key not in codecs:
            codecs[key] = registry.factory(
                meta["plugin"], dict(meta["profile"]), dev
            )
        return codecs[key]

    def reply(cmd, out, before, launches0):
        delta = {kk: v - before.get(kk, 0) for kk, v in snap().items()
                 if v != before.get(kk, 0)}
        meta = {"ok": True, "counters": delta, "shape": list(out.shape),
                "hosts": args.nprocs,
                "kernel_launches": GF_APPLY.launches - launches0}
        # every rank holds the whole result, but the coordinator reads
        # only rank 0's copy: the others answer with metadata
        payload = out.tobytes() if args.rank == 0 else b""
        return DcnReply(cmd.tid, args.rank, meta, payload)

    def run_cmd(cmd: DcnCmd) -> DcnReply:
        meta = cmd.meta
        if cmd.kind == "shutdown":
            done.set()
            return DcnReply(cmd.tid, args.rank, {"ok": True})
        before, launches0 = snap(), GF_APPLY.launches
        if cmd.kind == "apply":
            # the generic engine op the codec route ships: bitmatrix
            # bytes, then this host's shard block
            r8, c8 = meta["bm_shape"]
            nbm = r8 * c8
            bm_np = np.frombuffer(cmd.payload[:nbm], np.uint8).reshape(
                r8, c8)
            b, c, n = meta["shape"]
            local = np.frombuffer(cmd.payload[nbm:], np.uint8).reshape(
                b, c // args.nprocs, n)
            return reply(cmd, group.apply(bm_np, local), before, launches0)
        codec = get_codec(meta)
        b, c, n = meta["shape"]
        local = np.frombuffer(cmd.payload, np.uint8).reshape(
            b, c // args.nprocs, n)
        # packet codes (the liberation family) apply at packet
        # granularity: each host packetizes its own chunk block, so a
        # chunk's w packets stay on its host
        packets = isinstance(codec, BitMatrixCodec)
        if cmd.kind == "encode":
            if packets:
                mat01 = codec.coding_bitmatrix
            else:
                bm_np = codec._encode_bmat_np
        elif cmd.kind == "decode":
            present, want = list(meta["present"]), list(meta["want"])
            key = (tuple(present), tuple(want))
            if packets:
                mat01 = codec._host_tables.get(
                    key,
                    lambda: codec._build_decode_bitmatrix(present, want),
                )
            else:
                bm_np = codec._tables.get(
                    key, lambda: codec._build_decode_bmat(present, want)
                )
        else:
            raise ValueError(f"unknown DCN op {cmd.kind!r}")
        if packets:
            w = codec.w
            bm_np = np.kron(mat01, np.eye(8, dtype=np.uint8))
            local = local.reshape(b, (c // args.nprocs) * w, n // w)
        dispatch_counters().inc(f"mesh_{cmd.kind}")
        out = group.apply(bm_np, local)
        if packets:
            out = out.reshape(b, out.shape[1] // codec.w, n)
        return reply(cmd, out, before, launches0)

    def dispatch(c, msg) -> None:
        if isinstance(msg, DcnCmd):
            try:
                rep = run_cmd(msg)
            except Exception as e:  # surfaced to the coordinator
                rep = DcnReply(
                    msg.tid, args.rank,
                    {"ok": False, "error": f"{type(e).__name__}: {e}"},
                )
            c.send(rep)

    # dispatcher installed BEFORE connecting: the coordinator may send
    # the first command the moment it sees the hello
    msgr.set_dispatcher(dispatch)
    host, port = args.ctrl.rsplit(":", 1)
    conn = msgr.connect((host, int(port)))
    conn.send(DcnHello(
        args.rank, args.nprocs, args.devices, args.devices * args.nprocs
    ))
    while not done.wait(0.2):
        pass
    time.sleep(0.2)  # let the shutdown reply flush
    msgr.shutdown()
    dist.destroy_process_group()


# ------------------------------------------------------------ coordinator
class DcnCluster:
    """Spawn and drive N worker host processes.

    ``device`` is where each host runs its devices' Kernel A work
    (``"cuda"`` unless the caller asks for the CPU; without a card that
    raises). ``backend`` carries the cross-host hops: ``gloo`` through
    host memory (any device, one card shared by every host included),
    ``nccl`` between CUDA devices, one a host. The coordinator stays
    outside the process group and talks to the hosts over the
    messenger only.
    """

    def __init__(
        self, n_hosts: int = 2, devices_per_host: int = 2,
        device="cuda", backend: str = "gloo",
    ) -> None:
        from ceph_tpu_torch.utils.device import resolve_device

        if backend not in BACKENDS:
            raise ValueError(f"backend {backend!r} not in {BACKENDS}")
        self.device = resolve_device(device)
        if backend == "nccl" and (
            self.device.type != "cuda"
            or torch.cuda.device_count() < n_hosts
        ):
            raise ValueError(
                "the nccl backend needs a CUDA device for every host "
                f"({n_hosts} hosts, {torch.cuda.device_count()} cards); "
                "hosts sharing a card take gloo"
            )
        self.backend = backend
        self.n_hosts = n_hosts
        self.devices_per_host = devices_per_host
        self.procs: list[subprocess.Popen] = []
        self._errfiles: list = []
        #: tids with a waiter: replies for anything else (stragglers
        #: after a timeout) are dropped at arrival
        self._awaiting: set[int] = set()
        self.conns: dict[int, object] = {}
        self.hellos: dict[int, object] = {}
        self._replies: dict[tuple[int, int], object] = {}
        self._lock = threading.Lock()
        #: serializes whole ops (send fan-out through reply wait): every
        #: op ends in a cross-host collective, which needs all hosts to
        #: run ops in the same order
        self._op_lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._tid = 0
        self.msgr = None
        #: Kernel A launches the hosts reported, over every op
        self.kernel_launches = 0
        #: each host's counter deltas of the last op
        self.last_counters: dict[int, dict] = {}

    # -- lifecycle -----------------------------------------------------
    def start(self) -> "DcnCluster":
        import tempfile

        from ceph_tpu_torch.msg.messages import DcnHello, DcnReply
        from ceph_tpu_torch.msg.messenger import Messenger

        self.msgr = Messenger("dcn-coordinator")
        addr = self.msgr.bind("127.0.0.1", 0)

        def dispatch(conn, msg) -> None:
            with self._cv:
                if isinstance(msg, DcnHello):
                    self.hellos[msg.rank] = msg
                    self.conns[msg.rank] = conn
                elif isinstance(msg, DcnReply):
                    if msg.tid in self._awaiting:
                        self._replies[(msg.tid, msg.rank)] = msg
                    # else: straggler after a timeout — drop it
                self._cv.notify_all()

        self.msgr.set_dispatcher(dispatch)
        dist_addr = f"tcp://127.0.0.1:{_free_port()}"
        root = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(
            [root] + [p for p in [env.get("PYTHONPATH")] if p])
        for rank in range(self.n_hosts):
            # worker stderr lands in a temp file so a startup failure
            # keeps its traceback
            errf = tempfile.NamedTemporaryFile(
                mode="w+", prefix=f"dcn-host{rank}-", suffix=".err",
                delete=False,
            )
            self._errfiles.append(errf)
            self.procs.append(subprocess.Popen(
                [
                    sys.executable, "-m", "ceph_tpu_torch.parallel.dcn",
                    "--rank", str(rank),
                    "--nprocs", str(self.n_hosts),
                    "--dist", dist_addr,
                    "--devices", str(self.devices_per_host),
                    "--device", str(self.device),
                    "--backend", self.backend,
                    "--ctrl", f"{addr[0]}:{addr[1]}",
                ],
                env=env,
                stdout=subprocess.DEVNULL,
                stderr=errf,
            ))
        deadline = time.monotonic() + HELLO_TIMEOUT
        failed = False
        with self._cv:
            while len(self.hellos) < self.n_hosts:
                left = deadline - time.monotonic()
                if left <= 0 or any(
                    p.poll() is not None for p in self.procs
                ):
                    failed = True
                    break
                self._cv.wait(min(left, 0.5))
        if failed:
            # outside the cv: stop() -> _wait() re-acquires it
            got = len(self.hellos)
            tails = self._stderr_tails()
            self.stop()
            raise RuntimeError(
                f"DCN hosts failed to start ({got}/{self.n_hosts} "
                f"hellos); worker stderr tails: {tails}"
            )
        return self

    def _stderr_tails(self, limit: int = 800) -> dict[int, str]:
        tails = {}
        for rank, f in enumerate(self._errfiles):
            try:
                f.flush()
                with open(f.name) as fh:
                    tails[rank] = fh.read()[-limit:]
            except OSError:
                pass
        return tails

    def stop(self) -> None:
        from ceph_tpu_torch.msg.messages import DcnCmd

        try:
            if self.conns:
                tid = self._next_tid()
                for conn in self.conns.values():
                    conn.send(DcnCmd(tid, "shutdown", {}))
                self._wait(tid, timeout=5.0, strict=False)
        except Exception:
            pass  # a dead host cannot take the goodbye
        for p in self.procs:
            if p.poll() is None:
                p.terminate()
        for p in self.procs:
            try:
                p.wait(timeout=10)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait(timeout=10)
        if self.msgr is not None:
            self.msgr.shutdown()
        for f in self._errfiles:
            try:
                f.close()
                os.unlink(f.name)
            except OSError:
                pass
        self._errfiles = []

    def __enter__(self) -> "DcnCluster":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # -- ops -----------------------------------------------------------
    def _next_tid(self) -> int:
        # under the lock, and registered as awaited before any send, so
        # a fast reply can never race past the filter in the dispatcher
        with self._lock:
            self._tid += 1
            self._awaiting.add(self._tid)
            return self._tid

    def _wait(self, tid: int, timeout: float = OP_TIMEOUT,
              strict: bool = True) -> dict[int, object]:
        deadline = time.monotonic() + timeout
        with self._cv:
            try:
                while True:
                    got = {
                        r: self._replies[(tid, r)]
                        for r in range(self.n_hosts)
                        if (tid, r) in self._replies
                    }
                    if len(got) == self.n_hosts:
                        return got
                    left = deadline - time.monotonic()
                    if left <= 0:
                        if strict:
                            raise TimeoutError(
                                f"DCN op {tid}: {len(got)}/"
                                f"{self.n_hosts} replies"
                            )
                        return got
                    self._cv.wait(min(left, 0.5))
            finally:
                # consume on every exit: replies carry whole outputs
                self._awaiting.discard(tid)
                for r in range(self.n_hosts):
                    self._replies.pop((tid, r), None)

    def _broadcast(self, kind: str, meta: dict, data: np.ndarray,
                   head: bytes = b"", timeout: float = OP_TIMEOUT):
        """Send one op to every host — identical metadata, each host's
        own block of the shard axis after ``head`` — and collect rank
        0's result."""
        from ceph_tpu_torch.msg.messages import DcnCmd

        b, c, n = data.shape
        sp = self.n_hosts
        if c % sp:
            raise ValueError(f"shard axis {c} must divide hosts {sp}")
        tid = self._next_tid()
        blk = c // sp
        for rank, conn in self.conns.items():
            slice_ = np.ascontiguousarray(
                data[:, rank * blk:(rank + 1) * blk, :]
            )
            conn.send(DcnCmd(tid, kind, meta, head + slice_.tobytes()))
        replies = self._wait(tid, timeout=timeout)
        for r, rep in sorted(replies.items()):
            if not rep.meta.get("ok"):
                raise RuntimeError(f"DCN host {r}: {rep.meta.get('error')}")
        self.last_counters = {
            r: rep.meta["counters"] for r, rep in replies.items()
        }
        self.kernel_launches += sum(
            rep.meta.get("kernel_launches", 0) for rep in replies.values()
        )
        rep0 = replies[0]
        return np.frombuffer(rep0.payload, np.uint8).reshape(
            rep0.meta["shape"]
        )

    def _run(self, kind: str, plugin: str, profile: dict,
             data: np.ndarray, meta_extra: dict | None = None):
        """One codec op over the hosts: (output, per-host counters)."""
        meta = {"plugin": plugin, "profile": profile,
                "shape": list(data.shape), **(meta_extra or {})}
        with self._op_lock:
            out = self._broadcast(kind, meta, data)
            return out, dict(self.last_counters)

    def supported(self, bm_shape, data_shape) -> bool:
        """Divisibility contract for the generic apply route: the shard
        axis must split across hosts, the bitmatrix must match it, and
        the stripe batch must split over each host's devices — directly
        or by folding the lane axis (the GF(2) apply is independent per
        lane)."""
        if len(data_shape) != 3:
            return False
        b, c, n = data_shape
        dp = self.devices_per_host
        return (
            c % self.n_hosts == 0
            and bm_shape[1] == c * 8
            and (b % dp == 0 or n % dp == 0)
        )

    def apply_bitmatrix(self, bm_np: np.ndarray, data: np.ndarray,
                        timeout: float = 60.0) -> np.ndarray:
        """Generic [R*8, C*8] bitmatrix over [B, C, N] host data, fanned
        across hosts (encode, decode and parity delta of the codec route
        all arrive here). Shorter timeout than the command ops: this
        sits on the data path, where a dead host should fail fast into
        the dispatcher's fallback."""
        bm = np.ascontiguousarray(bm_np, np.uint8)
        meta = {"bm_shape": [int(bm.shape[0]), int(bm.shape[1])],
                "shape": list(data.shape)}
        with self._op_lock:
            return self._broadcast("apply", meta, data, bm.tobytes(),
                                   timeout)

    def encode(self, plugin: str, profile: dict, data: np.ndarray):
        """[B, k, N] data -> ([B, m, N] parity, per-host counters)."""
        return self._run("encode", plugin, profile, data)

    def decode(self, plugin: str, profile: dict, present: list[int],
               want: list[int], survivors: np.ndarray):
        """[B, len(present), N] survivors -> [B, len(want), N]."""
        return self._run(
            "decode", plugin, profile, survivors,
            {"present": list(present), "want": list(want)},
        )


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


if __name__ == "__main__":
    _worker_main(sys.argv[1:])

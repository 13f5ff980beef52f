"""The one traffic generator: a mix file's parameters and a seed in, a
fixed stream of ops and the bytes they write out.

Slimmed from the port's closed-loop load driver
(``ceph_tpu_torch/loadgen/driver.py``, its op classes, and
``loadgen/spec.py``'s content-as-a-function-of-the-seed idea), frozen
here so that a change to the program cannot change the yardstick.
What it dropped, and why: contents generated per op and two host CRCs
per read (host work inside the window, sharing the interpreter with the
in-process daemons), zipfian popularity and placement hashing (not
asked for by these mixes).

A mix file (``ecbench/mixes/<name>.json``) holds:

- ``objects``, ``object_bytes``: the working set; ``prefill`` writes it
  whole, from the seed, before anything is timed.
- ``ops``: a list of ``{"kind", "weight", "bytes", "align"}``; ``kind``
  is ``write_full`` (a whole object, named in turn and wrapping to a
  rewrite after ``objects``), ``write`` or ``read`` (``bytes`` at an
  ``align``-ed offset). Each round of ``sum(weight)`` ops holds exactly
  ``weight`` ops of each entry, in an order drawn from the seed.
- ``pick``: ``uniform`` (objects and offsets drawn uniformly) or
  ``shuffle`` (objects in seeded permutations, each once a round).
- ``depth``: ops kept outstanding by the closed loop.
- ``warmup_ops``: ops of the same stream run before the window.
- ``kill_osds``: OSDs stopped, and the PGs re-peered, before the window.
- ``pool_bytes``: the premade payload pool writes take their bytes from.

Every write's payload is a slice of the seeded pool with 16 bytes
stamped at the head of each 4 KiB block: the op's sequence number, the
object's index and a tag, so that any two writes differ in every block
they touch.
"""

from __future__ import annotations

import dataclasses
import struct

import numpy as np
import torch

BLOCK = 4096
_TAG = 0xEC0B

KINDS = ("write_full", "write", "read")


@dataclasses.dataclass(frozen=True)
class Op:
    seq: int
    kind: str
    obj: int
    offset: int
    length: int
    #: offset into the payload pool of a write's bytes (-1 for reads)
    src: int = -1

    @property
    def writes(self) -> bool:
        return self.kind != "read"

    def overlaps(self, other: "Op") -> bool:
        return (self.obj == other.obj
                and self.offset < other.offset + other.length
                and other.offset < self.offset + self.length)


def object_name(index: int) -> str:
    """Fixed names, the same for every seed, so every run maps the same
    objects to the same placement groups."""
    return f"ecbench_data.{index:08d}"


def stamp(buf: np.ndarray, seq: int, obj: int) -> None:
    """Write the 16-byte stamp at the head of every 4 KiB block."""
    head = np.frombuffer(struct.pack("<QII", seq, obj, _TAG), np.uint8)
    buf.reshape(-1, BLOCK)[:, :16] = head


def seeded_bytes(seed: int, n: int, stream: int, device) -> np.ndarray:
    """``n`` bytes drawn from ``seed`` on ``device`` in one call, brought
    to the host. ``stream`` keeps the pool and the image apart."""
    gen = torch.Generator(device=device)
    gen.manual_seed((seed * 1_000_003 + stream) % (1 << 63))
    return torch.randint(0, 256, (n,), generator=gen, dtype=torch.uint8,
                         device=device).cpu().numpy()


class Traffic:
    """The op stream of one mix under one seed, and its payloads."""

    def __init__(self, mix: dict, seed: int) -> None:
        self.mix = mix
        self.seed = seed
        self.objects = int(mix["objects"])
        self.object_bytes = int(mix["object_bytes"])
        self.depth = int(mix["depth"])
        self.prefill = bool(mix.get("prefill", False))
        self.pick = mix.get("pick", "uniform")
        if self.pick not in ("uniform", "shuffle"):
            raise ValueError(f"unknown pick {self.pick!r}")
        #: (kind, bytes, align) of each entry of ``ops``
        self.entries: list[tuple[str, int, int]] = []
        #: a round of the stream: each entry's index ``weight`` times
        self.round: list[int] = []
        for entry in mix["ops"]:
            kind = entry["kind"]
            if kind not in KINDS:
                raise ValueError(f"unknown op kind {kind!r}")
            nbytes = int(entry["bytes"])
            align = int(entry.get("align", nbytes))
            if kind == "write_full":
                nbytes = align = self.object_bytes
            if (nbytes % BLOCK or align % BLOCK
                    or self.object_bytes % align or nbytes > self.object_bytes):
                raise ValueError(f"op {entry} is not whole 4 KiB blocks "
                                 f"inside a {self.object_bytes}-byte object")
            self.round += [len(self.entries)] * int(entry["weight"])
            self.entries.append((kind, nbytes, align))
        kinds = {kind for kind, _n, _a in self.entries}
        if self.prefill and "write_full" in kinds:
            raise ValueError("write_full names new objects: no prefill")
        self.pool_bytes = int(mix.get("pool_bytes", 0))
        need = max((n for kind, n, _a in self.entries if kind != "read"),
                   default=0)
        if self.pool_bytes < need:
            raise ValueError(f"pool_bytes {self.pool_bytes} < {need}")
        self.pool: np.ndarray | None = None
        self.image: np.ndarray | None = None

    # -- set-up --------------------------------------------------------
    def make_data(self, device) -> None:
        """The payload pool and, for a prefilled mix, the image, from the
        seed, on the device, in one call each."""
        if self.pool_bytes:
            self.pool = seeded_bytes(self.seed, self.pool_bytes, 1, device)
        if self.prefill:
            self.image = seeded_bytes(
                self.seed, self.objects * self.object_bytes, 2, device
            ).reshape(self.objects, self.object_bytes)

    # -- the stream ----------------------------------------------------
    def stream(self):
        """Ops in issue order, without end; the same for the same seed."""
        rng = np.random.default_rng([self.seed, 7])
        seq = 0
        next_new = 0
        perm: list[int] = []
        while True:
            for index in rng.permutation(np.array(self.round)):
                kind, nbytes, align = self.entries[int(index)]
                if kind == "write_full":
                    obj = next_new % self.objects
                    next_new += 1
                    offset = 0
                else:
                    if self.pick == "shuffle":
                        if not perm:
                            perm = list(rng.permutation(self.objects))
                        obj = int(perm.pop())
                    else:
                        obj = int(rng.integers(self.objects))
                    slots = (self.object_bytes - nbytes) // align + 1
                    offset = int(rng.integers(slots)) * align
                src = -1
                if kind != "read":
                    slots = (self.pool_bytes - nbytes) // BLOCK + 1
                    src = int(rng.integers(slots)) * BLOCK
                yield Op(seq, kind, obj, offset, nbytes, src)
                seq += 1

    def payload(self, op: Op) -> np.ndarray:
        """A write's bytes: its pool slice, stamped."""
        buf = self.pool[op.src:op.src + op.length].copy()
        stamp(buf, op.seq, op.obj)
        return buf

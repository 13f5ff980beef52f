"""Golden-chunk corpus — the non-regression harness.

Mirrors src/test/erasure-code/ceph_erasure_code_non_regression.cc +
the ceph-erasure-code-corpus archive (SURVEY.md §2.1 "EC on-disk
corpus"): encoded chunks for each plugin/profile are frozen on disk;
``check`` re-encodes the archived payload and demands byte equality
(encode must be deterministic forever — the cross-version
bit-compatibility guarantee), then decodes every 1- and 2-erasure
combination back to the archived content.

Layout: ``<base>/<version>/<plugin>/<slug>/`` holding ``payload.bin``,
``profile.json``, and ``chunk.<i>``.

The payload generator is SHA-256 chaining — intentionally NOT a PRNG
library whose stream could change across releases; the corpus must be
reproducible from (seed, size) forever.

The payload generator, the slugs and the layout are ``ceph_tpu``'s,
frozen: an entry created by either package is byte-identical to the
other's, and both check the same archive. ``create`` and ``check`` run
the port's codecs on ``--device`` (``cuda`` unless the caller asks for
the CPU).

CLI:
    python -m ceph_tpu_torch.corpus create --base tests/corpus/v0
    python -m ceph_tpu_torch.corpus check  --base tests/corpus/v0
    python -m ceph_tpu_torch.corpus check  --base tests/corpus/v0 --device cpu
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys
from itertools import combinations

# The default suite frozen at v0: one profile per plugin family plus
# the headline configs from BASELINE.md.
DEFAULT_SUITE: list[tuple[str, dict[str, str]]] = [
    ("jerasure", {"technique": "reed_sol_van", "k": "4", "m": "2"}),
    ("jerasure", {"technique": "reed_sol_van", "k": "8", "m": "4"}),
    ("jerasure", {"technique": "reed_sol_r6_op", "k": "4", "m": "2"}),
    ("jerasure", {"technique": "cauchy_orig", "k": "4", "m": "2"}),
    ("jerasure", {"technique": "cauchy_good", "k": "4", "m": "2"}),
    # construction=v0 pins the round-1 matrices: re-creating the v0
    # tree must reproduce the ORIGINAL archive, not today's defaults
    ("jerasure", {"technique": "liberation", "k": "4", "m": "2",
                  "construction": "v0"}),
    ("jerasure", {"technique": "blaum_roth", "k": "4", "m": "2"}),
    ("jerasure", {"technique": "liber8tion", "k": "4", "m": "2",
                  "construction": "v0"}),
    ("isa", {"technique": "reed_sol_van", "k": "8", "m": "3"}),
    ("isa", {"technique": "cauchy", "k": "4", "m": "2"}),
    ("lrc", {"k": "4", "m": "2", "l": "3"}),
    ("shec", {"k": "4", "m": "3", "c": "2"}),
    ("clay", {"k": "4", "m": "2", "d": "5"}),
]

# v1 (round 5): the packet bit-matrix techniques under their
# reference-derived constructions (liberation = Plank FAST'08 port,
# blaum_roth = Blaum-Roth 1993 ring form, liber8tion = frozen
# minimal-density search) — the v0 entries for these pin
# construction=v0, so both matrix generations stay covered forever.
#
# Round 6 adds the byte-matrix families (reed_sol_van, cauchy_orig,
# cauchy_good, isa RS) at geometries the v0 suite does not cover —
# including the non-power-of-two k the zero-waste kernel pads and the
# cauchy k=10 bench geometry. Their chunks are additionally pinned
# against a from-scratch host GF apply of the gf/matrices.py ported
# constructions (tests/test_zero_waste_packing.py), so the repacked
# kernels regress against reference-derived vectors, not a v0 freeze
# of the engine under test.
V1_SUITE: list[tuple[str, dict[str, str]]] = [
    ("jerasure", {"technique": "liberation", "k": "4", "m": "2"}),
    ("jerasure", {"technique": "liberation", "k": "6", "m": "2",
                  "w": "7"}),
    ("jerasure", {"technique": "blaum_roth", "k": "4", "m": "2"}),
    ("jerasure", {"technique": "liber8tion", "k": "4", "m": "2"}),
    ("jerasure", {"technique": "liber8tion", "k": "8", "m": "2"}),
    ("jerasure", {"technique": "reed_sol_van", "k": "5", "m": "3"}),
    ("jerasure", {"technique": "cauchy_orig", "k": "5", "m": "3"}),
    ("jerasure", {"technique": "cauchy_good", "k": "10", "m": "4"}),
    ("isa", {"technique": "reed_sol_van", "k": "6", "m": "3"}),
]

# v2 (round 8): CLAY breadth (VERDICT #7 remainder) — the (8,4,d=10)
# profile (d < k+m-1: helper planes span fewer nodes than the d=11
# default, a distinct repair-plan shape) and a SHORTENED geometry
# ((4,3,d=6): q=3 does not divide k+m=7, so nu=2 virtual zero chunks
# pad the inner code — the ErasureCodeClay.cc:330 shortening path the
# v0 (4,2,d=5) entry never exercises).
#
# Round 9 adds the general-d kernel-path profiles: (6,3,d=7) is
# ALOOF + SHORTENED at once (one aloof node, nu=1 virtual chunk —
# the B1/B2 split with virtual members in the aloof row), and the
# (4,2,d=5) @ 516 KiB entry pins a chunk whose
# ``SB * sub_chunk_no * sc`` (2 Mi lanes at sc=16512) overflowed the
# retired round-7 whole-chunk scatter budget — the plane-blocked
# kernels must keep re-encoding/repairing it bit-identically
# (tests/test_clay_general_d.py runs repair-vs-archive through the
# kernels in interpret mode).  An optional third tuple element is the
# payload size (default PAYLOAD_SIZE).
V2_SUITE: list[tuple] = [
    ("clay", {"k": "8", "m": "4", "d": "10"}),
    ("clay", {"k": "4", "m": "3", "d": "6"}),
    ("clay", {"k": "6", "m": "3", "d": "7"}),
    ("clay", {"k": "4", "m": "2", "d": "5"}, 4 * 132096),
]

SUITES = {"v0": DEFAULT_SUITE, "v1": V1_SUITE, "v2": V2_SUITE}

PAYLOAD_SIZE = 31 * 1024 + 17  # ragged on purpose: exercises padding


def deterministic_payload(size: int, seed: str) -> bytes:
    """SHA-256 counter-mode byte stream: stable across releases."""
    out = bytearray()
    counter = 0
    while len(out) < size:
        out += hashlib.sha256(f"{seed}:{counter}".encode()).digest()
        counter += 1
    return bytes(out[:size])


def profile_slug(plugin: str, profile: dict[str, str]) -> str:
    parts = [plugin] + [
        f"{k}={profile[k]}" for k in sorted(profile)
    ]
    return "_".join(parts).replace("/", "-")


def _codec(plugin: str, profile: dict[str, str], device="cuda"):
    from ceph_tpu_torch.codecs import registry

    return registry.factory(plugin, dict(profile), device)


def run_create(
    base: str, plugin: str, profile: dict[str, str],
    size: int = PAYLOAD_SIZE, device="cuda",
) -> str:
    """Archive payload + encoded chunks for one plugin/profile."""
    slug = profile_slug(plugin, profile)
    path = os.path.join(base, plugin, slug)
    os.makedirs(path, exist_ok=True)
    payload = deterministic_payload(size, seed=slug)
    codec = _codec(plugin, profile, device)
    chunks = codec.encode(payload)
    with open(os.path.join(path, "payload.bin"), "wb") as f:
        f.write(payload)
    with open(os.path.join(path, "profile.json"), "w") as f:
        json.dump({"plugin": plugin, "profile": profile, "size": size}, f,
                  indent=1, sort_keys=True)
    for i, chunk in sorted(chunks.items()):
        with open(os.path.join(path, f"chunk.{i}"), "wb") as f:
            f.write(chunk)
    return path


def run_check(
    path: str, max_erasures: int = 2, device="cuda"
) -> list[str]:
    """Verify one archived corpus entry; returns a list of failures."""
    errors: list[str] = []
    with open(os.path.join(path, "profile.json")) as f:
        meta = json.load(f)
    plugin, profile = meta["plugin"], meta["profile"]
    with open(os.path.join(path, "payload.bin"), "rb") as f:
        payload = f.read()
    if len(payload) != meta["size"]:
        errors.append(f"payload size {len(payload)} != {meta['size']}")
    codec = _codec(plugin, profile, device)
    n = codec.get_chunk_count()
    stored: dict[int, bytes] = {}
    for i in range(n):
        with open(os.path.join(path, f"chunk.{i}"), "rb") as f:
            stored[i] = f.read()

    # 1. Bit-compatibility: today's encode == the archived chunks.
    now = codec.encode(payload)
    for i in range(n):
        if now[i] != stored[i]:
            errors.append(f"chunk {i} re-encodes differently")

    # 2. Every 1..max_erasures erasure combination decodes to the
    #    archived chunks (the decode_erasures recursion of the
    #    reference tool).
    m = codec.get_coding_chunk_count()
    for count in range(1, min(max_erasures, m) + 1):
        for erased in combinations(range(n), count):
            have = {i: c for i, c in stored.items() if i not in erased}
            try:
                out = codec.decode(set(erased), have)
            except ValueError:
                # Non-MDS families (SHEC trades decodability for
                # recovery cost) legitimately reject some patterns.
                if plugin in ("shec",):
                    continue
                errors.append(f"decode refused erasure {erased}")
                continue
            for e in erased:
                if bytes(out[e]) != stored[e]:
                    errors.append(f"erasure {erased}: chunk {e} differs")
    return errors


def iter_entries(base: str):
    for plugin in sorted(os.listdir(base)):
        pdir = os.path.join(base, plugin)
        if not os.path.isdir(pdir):
            continue
        for slug in sorted(os.listdir(pdir)):
            entry = os.path.join(pdir, slug)
            if os.path.isfile(os.path.join(entry, "profile.json")):
                yield entry


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(prog="ceph_tpu_torch.corpus")
    p.add_argument("action", choices=["create", "check"])
    p.add_argument("--base", default="tests/corpus/v0")
    p.add_argument("--size", type=int, default=PAYLOAD_SIZE)
    p.add_argument("--device", default="cuda",
                   help="where the codecs run (cuda, or cpu)")
    args = p.parse_args(argv)

    if args.action == "create":
        version = os.path.basename(os.path.normpath(args.base))
        suite = SUITES.get(version)
        if suite is None:
            p.error(
                f"--base must end in a known corpus version "
                f"({sorted(SUITES)}), got {version!r}"
            )
        for entry in suite:
            plugin, profile = entry[0], entry[1]
            size = entry[2] if len(entry) > 2 else args.size
            path = run_create(args.base, plugin, profile, size,
                              args.device)
            print(f"created {path}")
        return 0

    failed = 0
    for entry in iter_entries(args.base):
        errors = run_check(entry, device=args.device)
        status = "ok" if not errors else "FAIL"
        print(f"{status}  {entry}")
        for e in errors:
            print(f"      {e}")
        failed += bool(errors)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())

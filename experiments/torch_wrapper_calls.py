"""Time a call of the Kernel A, B and C wrappers on one CUDA card, for
the package found first on ``sys.path``, so that two trees compare in
one run.

At the shapes of ``chip_smoke.py``'s phase 2 (EC(8,4) over [8, 8, 1 MiB]
with 4 KiB windows; C over the 96 MiB of all 12 rows in 4 KiB blocks)
it times ``gf_apply``, ``gf_apply_csum`` and ``crc32c_blocks``: CUDA
events and the host clock around ``--calls`` back-to-back calls after a
warm-up, ``--reps`` times. When the wrapper's host work outlasts its
kernel, both read the host's time a call. Prints one JSON line: the
package's path, and per wrapper the median and the extremes of the reps
in microseconds a call. Imports nothing of JAX or ceph_tpu.

Usage, from a checkout (another tree's package first on the path times
that tree):

    python3 experiments/torch_wrapper_calls.py [--calls 2000] [--reps 5]
    PYTHONPATH=OTHER_TREE python3 experiments/torch_wrapper_calls.py
"""

from __future__ import annotations

import argparse
import json
import statistics
import time

import numpy as np
import torch

K, M, STRIPES, CHUNK, CSUM_BLOCK = 8, 4, 8, 1 << 20, 4096


def wrappers(dev):
    """{name: call} at phase 2's shapes, on seeded device data."""
    import ceph_tpu_torch.ops.cuda_encode as ce
    from ceph_tpu_torch.checksum.cuda_crc import crc32c_blocks
    from ceph_tpu_torch.gf import gf_matrix_to_bitmatrix, vandermonde_rs_matrix

    enc = gf_matrix_to_bitmatrix(vandermonde_rs_matrix(K, M)[K:, :])
    rng = np.random.default_rng(0)
    main = torch.from_numpy(
        rng.integers(0, 256, (STRIPES, K, CHUNK), np.uint8)).to(dev)
    verify = torch.from_numpy(rng.integers(
        0, 256, ((K + M) * STRIPES * CHUNK // CSUM_BLOCK, CSUM_BLOCK),
        np.uint8)).to(dev)
    return {
        "gf_apply": lambda: ce.gf_apply(enc, main),
        "gf_apply_csum": lambda: ce.gf_apply_csum(enc, main, CSUM_BLOCK),
        "crc32c_blocks": lambda: crc32c_blocks(verify, 0xFFFFFFFF),
    }


def per_call_us(fn, calls: int) -> tuple[float, float]:
    """(events, host clock) microseconds a call over ``calls`` calls."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    end.synchronize()
    host = time.perf_counter() - t0
    return start.elapsed_time(end) * 1e3 / calls, host * 1e6 / calls


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--calls", type=int, default=2000)
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA card")
    import ceph_tpu_torch

    dev = torch.device("cuda")
    out = {"package": ceph_tpu_torch.__file__.rsplit("/", 2)[0]}
    for name, fn in wrappers(dev).items():
        for _ in range(50):
            fn()
        reps = [per_call_us(fn, args.calls) for _ in range(args.reps)]
        for i, clock in enumerate(("events_us", "host_us")):
            vals = [r[i] for r in reps]
            out[f"{name}_{clock}"] = [round(statistics.median(vals), 2),
                                      round(min(vals), 2),
                                      round(max(vals), 2)]
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

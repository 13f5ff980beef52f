"""The multi-device tier across physical CUDA cards (run on four).

Checks, on a box with several cards, what one card cannot show:

- a mesh of the box's physical cards (``make_ec_mesh(n, k=8)``, cuda:0
  .. cuda:n-1): ``sharded_encode`` and ``ring_parity`` of ISA EC(8,4)
  over 8 stripes x 8 x 1 MiB, each byte-equal to one Kernel A launch on
  cuda:0, timed on the host clock after a warm-up call (every card
  synchronized);
- DCN hosts, one card a host, over the ``nccl`` backend and then over
  ``gloo``: three encodes of 4 stripes x 8 x 1 MiB (the first carries
  the hosts' CUDA start) and a decode of data shards {0, 1} from shards
  2-9, each byte-equal to Kernel A; the hosts' Kernel A launches.

Prints each card's name and power limit first. Usage:
``python3 experiments/torch_multi_card.py`` (``cpu`` as the argument
runs the DCN legs with four gloo hosts on the CPU instead).
"""

import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from ceph_tpu_torch import kernels  # noqa: E402
from ceph_tpu_torch.codecs import registry  # noqa: E402
from ceph_tpu_torch.ops import cuda_encode  # noqa: E402
from ceph_tpu_torch.parallel import (  # noqa: E402
    make_ec_mesh,
    ring_parity,
    sharded_encode,
)
from ceph_tpu_torch.parallel.dcn import DcnCluster  # noqa: E402

PROFILE = {"k": "8", "m": "4"}


def sync(kind: str) -> None:
    if kind == "cuda":
        for i in range(torch.cuda.device_count()):
            torch.cuda.synchronize(i)


def main() -> int:
    kind = sys.argv[1] if len(sys.argv) > 1 else "cuda"
    if kind == "cuda":
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, check=True).stdout.strip())
        kernels.build_all()
    n = torch.cuda.device_count() if kind == "cuda" else 4
    codec = registry.factory("isa", PROFILE, device=kind)
    bm = codec._encode_bmat_np
    rng = np.random.default_rng(0)
    data = torch.from_numpy(
        rng.integers(0, 256, (8, 8, 1 << 20), dtype=np.uint8))
    ref = cuda_encode.gf_apply(bm, data.to(kind)).cpu()

    if kind == "cuda":
        mesh = make_ec_mesh(n, k=8)
        print("physical mesh:", mesh,
              [str(d) for row in mesh.devices for d in row])
        src = data.to("cuda:0")
        for fn in (sharded_encode, ring_parity):
            fn(mesh, bm, src)
            sync(kind)
            t = time.perf_counter()
            out = fn(mesh, bm, src)
            sync(kind)
            ms = (time.perf_counter() - t) * 1e3
            assert torch.equal(out.cpu(), ref), fn.__name__
            print(f"{fn.__name__} over {n} cards: {ms:.3f} ms (host "
                  "clock), byte-equal to Kernel A")
    for backend in (["nccl", "gloo"] if kind == "cuda" else ["gloo"]):
        t = time.perf_counter()
        with DcnCluster(n, 1, device=kind, backend=backend) as dcn:
            start = time.perf_counter() - t
            host = data[:4].numpy()
            for it in range(3):
                t = time.perf_counter()
                par, _counters = dcn.encode("isa", PROFILE, host)
                ms = (time.perf_counter() - t) * 1e3
                assert np.array_equal(par, ref[:4].numpy()), backend
                print(f"dcn {backend} {n} hosts encode 32 MiB #{it}: "
                      f"{ms:.1f} ms; hosts' A launches so far "
                      f"{dcn.kernel_launches}")
            present = list(range(2, 10))
            chunks = np.concatenate([host, par], axis=1)
            out, _ = dcn.decode("isa", PROFILE, present, [0, 1],
                                chunks[:, present])
            assert np.array_equal(out, host[:, :2]), "decode"
            print(f"dcn {backend}: start {start:.1f} s, decode byte-equal")
    print("multi-card check ok")
    return 0


if __name__ == "__main__":
    sys.exit(main())

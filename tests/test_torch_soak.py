"""Slow-tier soak gate of the port, on the CPU.

Mirrors ``tests/test_soak.py``: the port's churn-sensitive peering and
quorum mirrors (``test_torch_cluster_peering.py``, ``test_torch_mon.py``)
rerun in fresh interpreter processes while the port's load generator
keeps primary-victim kill/revive smokes running beside them
(``device="cpu"``). Marked ``slow`` as the reference's is.
"""

import os
import subprocess
import sys
import threading

import pytest

pytest.importorskip("torch")

SUITES = (
    "tests/test_torch_cluster_peering.py",
    "tests/test_torch_mon.py",
)

#: slow-tier iteration count
N_ITER = int(os.environ.get("SOAK_TEST_ITERATIONS", "3"))


def _run_suites_once() -> subprocess.CompletedProcess:
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run(
        [
            sys.executable, "-m", "pytest", *SUITES, "-q",
            "-m", "not slow", "-p", "no:cacheprovider",
            "-p", "no:randomly",
        ],
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        env=env, capture_output=True, text=True, timeout=600,
    )


@pytest.mark.slow
@pytest.mark.soak
def test_peering_quorum_soak_under_parallel_load():
    from ceph_tpu_torch.loadgen import (
        FaultSchedule,
        LoadCluster,
        preset,
        run_spec,
    )

    stop = threading.Event()

    def load_loop() -> None:
        while not stop.is_set():
            cluster = LoadCluster(
                n_osds=5, k=2, m=1, pg_num=4, chunk_size=1024,
                device="cpu",
            )
            try:
                spec = preset("smoke", total_ops=60, warmup_ops=6)
                run_spec(
                    cluster, spec,
                    FaultSchedule.primary_kill(spec.total_ops),
                )
            except Exception:
                pass  # load is pressure, not the assertion
            finally:
                cluster.shutdown()

    loader = threading.Thread(target=load_loop, daemon=True)
    loader.start()
    try:
        for i in range(1, N_ITER + 1):
            proc = _run_suites_once()
            assert proc.returncode == 0, (
                f"soak iteration {i}/{N_ITER} went non-green:\n"
                f"{proc.stdout[-3000:]}\n{proc.stderr[-2000:]}"
            )
    finally:
        stop.set()
        loader.join(timeout=120)

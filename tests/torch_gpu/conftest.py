"""Registers the ``gpu`` marker: tests that need a CUDA card (the
ceph_tpu_torch kernels) and skip without one."""


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA card (ceph_tpu_torch kernels); "
        "skips without one",
    )

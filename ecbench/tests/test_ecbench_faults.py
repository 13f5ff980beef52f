"""``correct`` comes out false under the control and under each fault a
cell can have, with the rest of a run driven as the benchmark drives it
(tiny sizes, on the CPU); and true without one."""

from __future__ import annotations

import pytest

from ecbench.faults import FAULTS
from ecbench.tests.tiny import run_tiny, tiny_copy


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny_copy(tmp_path_factory.mktemp("ecbench"))


@pytest.mark.parametrize("cell", ["isa-k8m4.write-4m",
                                  "isa-k8m4.degraded-read-4m"])
def test_sound_run_is_correct(root, cell):
    res = run_tiny(root, cell)
    assert res["correct"], res["limits"]
    assert res["metrics"]["client_gbps"]["value"] > 0


@pytest.mark.parametrize("cell", ["isa-k8m4.write-4m",
                                  "isa-k8m4.degraded-read-4m"])
def test_control_is_not_correct(root, cell):
    """The control: parity sub-writes dropped while the op is
    acknowledged."""
    res = run_tiny(root, cell, fault="parity_unapplied")
    assert not res["correct"]
    assert res["limits"]["shard_bytes_wrong"]["value"] > 0 \
        or res["limits"]["ops_failed"]["value"] > 0


@pytest.mark.parametrize("fault", [f for f in FAULTS
                                   if f != "parity_unapplied"])
def test_each_fault_is_not_correct(root, fault):
    res = run_tiny(root, "isa-k8m4.write-4m", fault=fault)
    assert not res["correct"], fault
    assert res["limits"]["shard_bytes_wrong"]["value"] > 0


def test_altered_read_answers_are_not_correct(root):
    res = run_tiny(root, "isa-k8m4.degraded-read-4m", fault="answer_altered")
    assert not res["correct"]
    assert res["limits"]["read_bytes_wrong"]["value"] > 0

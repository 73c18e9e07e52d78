"""The launch counters' groups: counts on the host and on a device, read
and zeroed together, and every kernel module's group registered for
graphs.Graph to make before it captures."""

import torch

from portrayer_tpu_torch import counters, rng
from portrayer_tpu_torch.ops import cuda_intersect


def test_kernel_modules_register_their_groups():
    assert rng._COUNTERS in counters._GROUPS
    assert cuda_intersect._COUNTERS in counters._GROUPS
    assert cuda_intersect.counts is not rng.counts


def test_a_group_counts_on_host_and_device(monkeypatch):
    monkeypatch.setattr(counters, "_GROUPS", [])
    group = counters.Group(("a", "b"), host_only=("c",))
    cpu = torch.device("cpu")
    counters.make_all(cpu)
    assert group.on(cpu).tolist() == [0, 0]
    group.add_on_device(cpu, "b", 3)
    group.add_on_device(cpu, "b", torch.tensor(2))
    group.host["c"] += 1
    assert group.read() == {"a": 0, "b": 5, "c": 1}
    # The device's counts moved to the host and zeroed there, read once.
    assert group.read() == {"a": 0, "b": 5, "c": 1}
    assert group.on(cpu).tolist() == [0, 0]
    group.add_on_device(cpu, "a")
    group.reset()
    assert group.read() == {"a": 0, "b": 0, "c": 0}

"""Launch counters of the port's kernel modules, one named group each.

A group counts on the host (a dict, ``host``) and, for the names it keeps
on the device, in one int64 tensor a device (``on``): a launch recorded
into a captured CUDA graph adds to that tensor where it runs, at each
replay, and in a conditional body only when the body runs.  A caller
zeroes a group (``reset``) before a run and reads it after it (``read``,
one read a device).  The device tensors must exist before a capture that
adds to them: ``graphs.Graph`` calls ``make_all`` first, which makes them
for every group registered so far (each kernel module registers its group
when it is imported, so before any of its launches).
"""

from __future__ import annotations

import torch

_GROUPS = []


class Group:
    """Counts named `host_only` (on the host alone) and `device` (on the
    host, and on the device in that order)."""

    def __init__(self, device, host_only=()):
        self.device = tuple(device)
        self.host = dict.fromkeys(self.device + tuple(host_only), 0)
        self._on = {}
        _GROUPS.append(self)

    def on(self, device: torch.device) -> torch.Tensor:
        """The counters of `device`, [len(self.device)] int64, made at first
        call (outside every capture)."""
        if device not in self._on:
            self._on[device] = torch.zeros(len(self.device), dtype=torch.int64, device=device)
        return self._on[device]

    def add_on_device(self, device: torch.device, name: str, n=1):
        """Add n (an int or a 0-d int64 on `device`) to the count of `name`
        on `device`, without a read on the host."""
        self.on(device)[self.device.index(name)].add_(n)

    def reset(self):
        for k in self.host:
            self.host[k] = 0
        for t in self._on.values():
            t.zero_()

    def read(self) -> dict:
        """The counts since reset, those on the devices moved into host."""
        for t in self._on.values():
            for name, n in zip(self.device, t.tolist()):
                self.host[name] += n
            t.zero_()
        return dict(self.host)


def make_all(device: torch.device):
    """Make every registered group's counters on `device`."""
    for group in _GROUPS:
        group.on(device)

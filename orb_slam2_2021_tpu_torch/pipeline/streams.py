"""CUDA streams of async mode, one per role (counterpart of the device
pacing in orb_slam2_2021_tpu/utils/pacer.py and local_mapping._yield_device).

The reference's TPU runs every dispatch in order on one queue, so its
background threads had to yield between bounded units to keep the tracking
lane from queueing behind them. A CUDA card runs several streams at once
and schedules their blocks by priority, so here each role gets a
non-blocking stream of its own:

- "lane": the tracking lane (the caller's thread), at the highest priority
  the card offers;
- "mapping": the local-mapping worker, which also runs loop closing inline;
- "gba": the ephemeral global-BA thread;

the last two at the lowest priority. PyTorch's current stream is per
thread, so each thread enters its role's stream (`enter`) for as long as it
launches work. On a CPU device every role is the host and the contexts do
nothing.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Iterable, Optional

import torch

from ..io import trace

ROLES = ("lane", "mapping", "gba")


class DeviceStreams:
    """The per-role streams of one System on one device."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.streams: Dict[str, Optional[torch.cuda.Stream]] = {r: None for r in ROLES}
        if self.device.type == "cuda":
            low, high = torch.cuda.Stream.priority_range()  # (least, greatest): lower is more urgent
            self.streams = {
                "lane": torch.cuda.Stream(self.device, priority=high),
                "mapping": torch.cuda.Stream(self.device, priority=low),
                "gba": torch.cuda.Stream(self.device, priority=low),
            }

    def enter(self, role: str):
        """Make `role`'s stream the calling thread's current stream."""
        s = self.streams[role]
        return torch.cuda.stream(s) if s is not None else contextlib.nullcontext()

    def handoff(self, tensors: Iterable[torch.Tensor], to_role: str):
        """Hand tensors made on the current stream to `to_role`'s thread:
        returns an event recorded after the work that made them (None on
        the CPU). The receiver waits for it (`wait`) before reading. Each
        tensor is marked as in use by the receiving stream, so the caching
        allocator does not give its memory back to the maker while the
        receiver may still read it."""
        s = self.streams[to_role]
        if s is None:
            return None
        for t in tensors:
            t.record_stream(s)
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(self.device))
        return ev

    def wait(self, event):
        """Order the current stream's next work after `event` (from
        `handoff`); nothing on the CPU."""
        if event is not None:
            torch.cuda.current_stream(self.device).wait_event(event)

    def wait_role(self, role: str):
        """Order the current stream's next work after everything `role` has
        enqueued so far (a reader of what that thread writes on the card)."""
        s = self.streams[role]
        if s is not None:
            torch.cuda.current_stream(self.device).wait_stream(s)

    def synchronize(self, *roles: str):
        """Block the host until the given roles' streams (all by default)
        have finished their work."""
        for r in roles or ROLES:
            s = self.streams[r]
            if s is not None:
                s.synchronize()


def pull_after(x: torch.Tensor, then=None):
    """x -> numpy, the device -> host copy enqueued before `then()` runs: on
    a card the copy goes to pinned memory, `then` enqueues its own work
    after it, and the host waits for the copy alone, not for `then`'s work.
    The host's wait is the `track.readback` span (io/trace.py). Returns
    (array, then's result)."""
    if x.device.type != "cuda" or then is None:
        res = then() if then is not None else None
        with trace.span("track.readback"):
            return x.cpu().numpy(), res
    host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
    host.copy_(x, non_blocking=True)
    done = torch.cuda.Event()
    done.record(torch.cuda.current_stream(x.device))
    res = then() if then is not None else None
    with trace.span("track.readback"):
        done.synchronize()
    return host.numpy(), res

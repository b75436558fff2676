"""A profiled slice of a run's window, read in memory and never exported.

``Slice`` runs ``torch.profiler`` (host and device activity) over a block of
the window and keeps what the per-layer metrics read: each device
operation's name and interval, the host's events, the flash kernel's
launches with their shapes (``launches``, recorded by the driver), and the
slice's length on the host clock.
"""

from __future__ import annotations

import bisect
import time
from typing import Dict, List, Tuple

import torch

#: Host events looked back through for the one under an idle gap.
SCAN = 4096


class Slice:
    """``with Slice(sync=True) as s: ...``; ``sync`` waits for the device at
    both ends, so the slice holds whole steps."""

    def __init__(self, sync: bool = True):
        self.sync = sync
        self.window_s = 0.0
        self.device: List[Tuple[str, int, int]] = []   # (name, start ns, end ns)
        self.host: List[Tuple[str, int, int]] = []
        self.launches: List[tuple] = []                # flash launches: (q shape, Nk, bf16, kv_lens)
        self._prof = None
        self.t_start = 0.0
        self.started = False

    @staticmethod
    def _profiler():
        from torch.profiler import ProfilerActivity, profile

        # Host events of the profiling thread; the device's of every thread.
        return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])

    @classmethod
    def prime(cls) -> None:
        """One profile of a trivial operation, for the set-up: a process's
        first profile spends seconds setting the profiler up, which then
        falls in no window."""
        with cls._profiler():
            torch.ones(1, device="cuda").add_(1)
            torch.cuda.synchronize()

    @property
    def running(self) -> bool:
        return self._prof is not None

    def start(self) -> None:
        self.started = True
        if self.sync:
            torch.cuda.synchronize()
        prof = self._profiler()
        prof.start()
        self.t_start = time.perf_counter()
        self._prof = prof

    def stop(self) -> None:
        if self.sync:
            torch.cuda.synchronize()
        self.window_s = time.perf_counter() - self.t_start
        self._prof.stop()
        cuda = torch.autograd.DeviceType.CUDA
        device = []
        for e in self._prof.profiler.kineto_results.events():
            item = (e.name(), e.start_ns(), e.end_ns())
            (device if e.device_type() == cuda else self.host).append(item)
        # A host span (record_function) is drawn on the device's row too,
        # under its own name; kernels and copies never bear a host event's.
        spans = {name for name, _, _ in self.host}
        self.device = [d for d in device if d[0] not in spans]
        self._prof = None
        if not self.device:
            raise RuntimeError("torch.profiler recorded no device operation in the traced slice")

    def __enter__(self) -> "Slice":
        self.start()
        return self

    def __exit__(self, *exc) -> None:
        self.stop()

    # -- what the readers take --------------------------------------------------------

    def busy_intervals(self) -> List[Tuple[int, int]]:
        merged: List[List[int]] = []
        for _, a, b in sorted(self.device, key=lambda x: x[1]):
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        return [(a, b) for a, b in merged]

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals()) * 1e-9

    def idle_percent(self) -> float:
        return 100.0 * (1.0 - self.busy_s / self.window_s)

    def kernels(self, contains: str = "") -> List[Tuple[str, int, int]]:
        """Device kernels (memory copies and sets left out) whose name
        contains ``contains``."""
        return [k for k in self.device
                if contains in k[0] and not k[0].startswith(("Memcpy", "Memset"))]

    def breakdown(self, top: int = 10) -> Dict[str, list]:
        """The device operations that took most time, and the idle gaps
        between device operations summed by the innermost host event under
        each gap's middle."""
        by_op: Dict[str, int] = {}
        for name, a, b in self.device:
            by_op[name] = by_op.get(name, 0) + (b - a)
        busy = self.busy_intervals()
        host = sorted(self.host, key=lambda x: x[1])
        starts = [ev[1] for ev in host]
        gaps: Dict[str, int] = {}
        for (_, end), (start, _) in zip(busy, busy[1:]):
            mid = (end + start) // 2
            # The latest-starting host event that still runs at mid.
            name = "no host event"
            i = bisect.bisect_right(starts, mid)
            for j in range(i - 1, max(-1, i - 1 - SCAN), -1):
                if host[j][2] >= mid:
                    name = host[j][0]
                    break
            gaps[name] = gaps.get(name, 0) + (start - end)

        def top_of(d):
            return [[k[:120], v * 1e-9] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]

        return {"device_ops": top_of(by_op), "idle_gaps": top_of(gaps)}

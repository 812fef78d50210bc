"""A bounded profile of the window's last steps, reduced in memory.

``profile(fn, calls)`` runs ``fn`` ``calls`` times under ``torch.profiler``
(host and device activity) between two synchronisations and returns a
``Profile``: every device operation (kernels, copies, sets) and every host
event on the thread that drove the steps, as (name, start s, end s). From
it: the device's busy seconds (the union of its operations' intervals), the
profiled span (first device operation's start to the last one's end), the
operations that took most time, and the longest idle gaps, each named by
the innermost host event that covers its start.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Tuple

Event = Tuple[str, float, float]  # (name, start s, end s)
CALL = "portbench.call"  # the host span around each profiled call: a gap that only it
#                          covers is the host running the step's Python between operations


@dataclasses.dataclass
class Profile:
    device: List[Event]
    host: List[Event]
    calls: int

    def span_s(self) -> float:
        if not self.device:
            return 0.0
        return max(e[2] for e in self.device) - min(e[1] for e in self.device)

    def busy_s(self) -> float:
        return union_s([(s, e) for _, s, e in self.device])

    def kernel_s(self, match: Callable[[str], bool]) -> float:
        """Device seconds of the operations whose name ``match`` accepts."""
        return sum(e - s for name, s, e in self.device if match(name))

    def top_ops(self, n: int = 10) -> List[Tuple[str, float]]:
        by_name: dict = {}
        for name, s, e in self.device:
            by_name[name] = by_name.get(name, 0.0) + (e - s)
        return sorted(by_name.items(), key=lambda kv: -kv[1])[:n]

    def idle_gaps(self, n: int = 10) -> List[Tuple[str, float]]:
        longest = sorted(gaps_of([(s, e) for _, s, e in self.device]),
                         key=lambda g: g[0] - g[1])[:n]
        out = []
        for start, end in longest:
            covering = [h for h in self.host if h[1] <= start < h[2]]
            name = min(covering, key=lambda h: h[2] - h[1])[0] if covering else "(no host event)"
            out.append((name, end - start))
        return out


def union_s(intervals: List[Tuple[float, float]]) -> float:
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e <= end:
            continue
        total += e - max(s, end)
        end = e
    return total


def gaps_of(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """The idle intervals between the first start and the last end."""
    out, end = [], None
    for s, e in sorted(intervals):
        if end is not None and s > end:
            out.append((end, s))
        end = e if end is None else max(end, e)
    return out


def profile(fn: Callable[[], None], calls: int) -> Profile:
    import torch
    from torch.profiler import ProfilerActivity

    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            with torch.profiler.record_function(CALL):
                fn()
        torch.cuda.synchronize()
    device, host = [], {}
    results = prof.profiler.kineto_results
    base = results.trace_start_ns()
    for ev in results.events():
        start = (ev.start_ns() - base) * 1e-9
        item = (ev.name(), start, start + ev.duration_ns() * 1e-9)
        if "CUDA" not in str(ev.device_type()):
            host.setdefault(ev.start_thread_id(), []).append(item)
        elif not (ev.is_user_annotation() or item[0] == CALL):  # a host span's shadow
            device.append(item)
    # the driving thread is the one whose events include the calls' spans
    threads = [t for t, evs in host.items() if any(e[0] == CALL for e in evs)]
    return Profile(device=device, host=host[threads[0]] if threads else [], calls=calls)

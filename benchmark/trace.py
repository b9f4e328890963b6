"""Reading a ``torch.profiler`` trace of the window.

The device's activities (kernels, copies, fills) come with their start and
length; the host's operators and the harness's own ranges
(``record_function``) too. From them: the time the device was busy (the
union of its activities), the kernels by the stem of their name, the
longest idle gaps named by what the host was doing in them, and the
breakdown the result line carries.
"""

from __future__ import annotations

import re
from typing import Dict, List, NamedTuple

DEVICE_KINDS = ("kernel", "gpu_memcpy", "gpu_memset")
TOP = 10


class Activity(NamedTuple):
    name: str
    kind: str
    start: float  # seconds, on the profiler's clock
    end: float


def stem(name: str) -> str:
    """A kernel's name without its return type, namespaces and template
    or call arguments: ``void (anonymous namespace)::lstm_grid_kernel<4>(...)``
    → ``lstm_grid_kernel``."""
    s = name.replace("(anonymous namespace)::", "")
    s = re.sub(r"^void\s+", "", s)
    s = re.split(r"[<(]", s, maxsplit=1)[0]
    return s.split("::")[-1].strip()


def _kind(e, name: str, ranges: str) -> str:
    """An event's kind, told from its device and name (not every torch's
    events carry their activity type): the harness's ranges, copies and
    fills by their names, other device events kernels, other host events
    operators and runtime calls."""
    from torch.autograd import DeviceType

    if name.startswith(ranges):
        return "gpu_user_annotation" if e.device_type() == DeviceType.CUDA else "user_annotation"
    if e.device_type() == DeviceType.CUDA:
        if name.startswith("Memcpy"):
            return "gpu_memcpy"
        return "gpu_memset" if name.startswith("Memset") else "kernel"
    return "cpu_op"


class Trace:
    """The activities of one profiled window, on the device and the host."""

    def __init__(self, device: List[Activity], host: List[Activity], window: tuple):
        self.window = window  # (start, end) in seconds on the profiler's clock
        lo, hi = window
        self.device = sorted((a for a in device if a.end > lo and a.start < hi), key=lambda a: a.start)
        self.host = [a for a in host if a.end > lo and a.start < hi]
        self.kernels = [a for a in self.device if a.kind == "kernel"]

    @classmethod
    def from_profiler(cls, prof, window_name: str = "bench.window", ranges: str = "bench.") -> "Trace":
        """From a stopped ``torch.profiler.profile``: the window is the
        harness's ``record_function`` range ``window_name``; its ranges
        are the host's annotations (names starting with ``ranges``)."""
        from torch.autograd import DeviceType

        device, host, window = [], [], None
        for e in prof.profiler.kineto_results.events():
            name = e.name()
            start = e.start_ns() / 1e9
            a = Activity(name, _kind(e, name, ranges), start, start + e.duration_ns() / 1e9)
            if e.device_type() == DeviceType.CUDA and a.kind in DEVICE_KINDS:
                device.append(a)
            elif e.device_type() == DeviceType.CPU:
                if a.kind == "user_annotation" and name == window_name:
                    window = (a.start, a.end)
                host.append(a)
        if window is None:
            raise RuntimeError(f"the trace has no range {window_name!r}")
        return cls(device, host, window)

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    def busy_intervals(self) -> List[tuple]:
        lo, hi = self.window
        merged: List[list] = []
        for a in self.device:
            s, e = max(a.start, lo), min(a.end, hi)
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return [tuple(m) for m in merged]

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals())

    def kernel_seconds(self, stems: tuple) -> float:
        """Summed time of the kernels whose stem starts with one of ``stems``."""
        return sum(k.end - k.start for k in self.kernels if stem(k.name).startswith(stems))

    def device_seconds(self, exclude: tuple = ()) -> float:
        """Summed time of every device activity (kernels by stem, copies and
        fills by name) that starts with none of ``exclude``."""
        tot = 0.0
        for a in self.device:
            key = stem(a.name) if a.kind == "kernel" else a.name
            if not (exclude and key.startswith(exclude)):
                tot += a.end - a.start
        return tot

    def gaps(self) -> List[tuple]:
        """(start, end) of every stretch of the window with no device activity."""
        lo, hi = self.window
        out, t = [], lo
        for s, e in self.busy_intervals():
            if s > t:
                out.append((t, s))
            t = max(t, e)
        if hi > t:
            out.append((t, hi))
        return out

    def host_at(self, times: List[float]) -> List[str]:
        """What the host was doing at each of ``times``: the innermost
        operator or runtime call spanning it, within the harness's
        innermost range (one sweep over the host's activities)."""
        import heapq

        order = sorted(range(len(times)), key=times.__getitem__)
        host = sorted(self.host, key=lambda a: a.start)
        out: List[str] = [""] * len(times)
        active: list = []
        i = 0
        for j in order:
            t = times[j]
            while i < len(host) and host[i].start <= t:
                heapq.heappush(active, (host[i].end, i))
                i += 1
            while active and active[0][0] <= t:
                heapq.heappop(active)
            spans = [host[k] for _, k in active]
            ranges = [a for a in spans if a.kind == "user_annotation"]
            ops = [a for a in spans if a.kind != "user_annotation"]
            where = min(ranges, key=lambda a: a.end - a.start).name if ranges else "outside the harness's ranges"
            what = min(ops, key=lambda a: a.end - a.start).name if ops else "python"
            out[j] = f"{where} / {what}"
        return out

    def breakdown(self) -> Dict[str, list]:
        """The device operations that took most time, by stem, and the idle
        time by what the host was doing at each gap's middle (at most
        ``TOP`` each)."""
        ops: Dict[str, float] = {}
        for a in self.device:
            key = stem(a.name) if a.kind == "kernel" else a.name
            ops[key] = ops.get(key, 0.0) + (a.end - a.start)
        idle: Dict[str, float] = {}
        gaps = self.gaps()
        for (s, e), key in zip(gaps, self.host_at([(s + e) / 2 for s, e in gaps])):
            idle[key] = idle.get(key, 0.0) + (e - s)
        top = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:TOP]]
        return {"device_ops": top(ops), "idle_gaps": top(idle)}

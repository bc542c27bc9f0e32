"""The device trace of a ``--trace 1`` run: ``torch.profiler`` over the
traced window, reduced to the device's operations (name, start, duration),
its busy time (the union of their intervals), and the breakdown the result
line carries."""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict

import torch

WINDOW = "perfbench.window"


def _ns(evt, what: str) -> float:
    for attr, scale in ((f"{what}_ns", 1.0), (f"{what}_us", 1e3)):
        fn = getattr(evt, attr, None)
        if fn is not None:
            return float(fn()) * scale
    raise AttributeError(f"profiler event has no {what}")


def _is_annotation(evt) -> bool:
    fn = getattr(evt, "is_user_annotation", None)
    return bool(fn()) if fn is not None else False


class DeviceTrace:
    """Context manager: profiles what runs inside it. Afterwards ``ops``
    holds (name, start ns, duration ns) of every device operation in the
    window, ``window_s`` the window's host-clock length, ``busy_s`` the
    union of the operations' intervals, ``host`` the host's operations."""

    def __init__(self, device: str):
        self.device = device
        self.ops: list[tuple[str, float, float]] = []
        self.host: list[tuple[str, float, float]] = []
        self.window_s = 0.0
        self.busy_s = 0.0
        self._bounds: tuple[float, float] | None = None

    @contextlib.contextmanager
    def window(self):
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.device == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        with torch.profiler.profile(activities=acts) as prof:
            with torch.profiler.record_function(WINDOW):
                t0 = time.perf_counter()
                yield
                if self.device == "cuda":
                    torch.cuda.synchronize()
                self.window_s = time.perf_counter() - t0
        self._read(prof)

    def _read(self, prof) -> None:
        dev_type = torch.autograd.DeviceType.CUDA
        for evt in prof.profiler.kineto_results.events():
            name = evt.name()
            start, dur = _ns(evt, "start"), _ns(evt, "duration")
            if evt.device_type() == dev_type:
                # the profiler mirrors host annotations onto the device's
                # timeline; they are not device operations
                if name != WINDOW and not _is_annotation(evt):
                    self.ops.append((name, start, dur))
            else:
                if name == WINDOW:
                    self._bounds = (start, start + dur)
                self.host.append((name, start, dur))
        lo, hi = self._bounds if self._bounds else (float("-inf"), float("inf"))
        self.ops = sorted((n, max(s, lo), min(s + d, hi) - max(s, lo))
                          for n, s, d in self.ops if s + d > lo and s < hi)
        self.ops.sort(key=lambda o: o[1])
        self.busy_s = sum(b - a for a, b in self._busy()) * 1e-9

    def _busy(self) -> list[tuple[float, float]]:
        spans: list[list[float]] = []
        for _, s, d in self.ops:
            if spans and s <= spans[-1][1]:
                spans[-1][1] = max(spans[-1][1], s + d)
            else:
                spans.append([s, s + d])
        return [(a, b) for a, b in spans]

    def breakdown(self) -> dict:
        """The ten device operations that took most time, and the ten
        host operations during which the device idled longest."""
        by_op: dict[str, float] = defaultdict(float)
        for name, _, d in self.ops:
            by_op[name[:160]] += d * 1e-9
        gaps: dict[str, float] = defaultdict(float)
        busy = self._busy()
        lo, hi = self._bounds if self._bounds else (busy[0][0] if busy else 0.0,
                                                    busy[-1][1] if busy else 0.0)
        edges = [lo] + [x for a, b in busy for x in (a, b)] + [hi]
        host = sorted((h for h in self.host if h[0] != WINDOW), key=lambda h: h[1])
        stack: list[tuple[str, float, float]] = []
        i = 0
        for a, b in zip(edges[0::2], edges[1::2]):
            if b <= a:
                continue
            mid = 0.5 * (a + b)
            # the innermost host operation open at the gap's middle: host
            # operations nest, so open ones form a stack in start order
            while i < len(host) and host[i][1] <= mid:
                while stack and stack[-1][1] + stack[-1][2] < host[i][1]:
                    stack.pop()
                stack.append(host[i])
                i += 1
            while stack and stack[-1][1] + stack[-1][2] < mid:
                stack.pop()
            label = stack[-1][0] if stack else "host (no operation recorded)"
            gaps[label[:160]] += (b - a) * 1e-9
        top = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]
        return {"device_ops": top(by_op), "idle_gaps": top(gaps)}


def kernel_base(name: str) -> str:
    """A device function's identifier from its demangled signature:
    ``void ns::foo_kernel<4>(float const*, ...)`` -> ``foo_kernel``."""
    head = name.replace("(anonymous namespace)", "").split("(")[0]
    depth, out = 0, []
    for ch in head:
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif depth == 0:
            out.append(ch)
    return "".join(out).split()[-1].split("::")[-1] if "".join(out).split() else ""

"""Tracing/profiling: phase timers + torch.profiler traces + per-step loss logs,
and the program's spans and counters.

Port of ``gpras_tpu/utils/profiling.py``: ``PhaseTimers`` (the reference's
timers.json surface, same JSON keys), ``profiler_trace`` on
``torch.profiler`` (a Chrome trace of the host and, on the card, the device,
written into ``log_dir``; ``None`` is a no-op), and ``log_fit_losses``.

Spans and counters (the port's own): ``span(name)`` marks a stretch of the
program at a layer boundary and ``count(name, n)`` adds to a counter there.
Both record only while a ``torch.profiler`` is recording; otherwise each is
one check of the profiler's state and nothing more, so the program pays for
them only under a profiler. A recorded span is a ``record_function`` of its
name (so the trace's own timeline shows it), a record in memory (name,
request id, parent, host start and end from ``time.time_ns()``, the counts
added inside it) and, when the program uses a CUDA device, a pair of timing
events whose interval ``records()`` resolves after the fact. The spans of one
root span (a served request, one mode's fit) share its request id.
``profiler_trace`` writes the records as ``spans.json`` beside its trace.

Counters: ``host_reads``, each call at which the host waits for the device
(a device value read on the host, or a copy up from pageable memory, which
waits for the device's queue); the same sites are counted on the CPU, where
nothing waits, so a CPU run counts what a run on the card would.
``cg.column_iters`` and ``cg.live_column_iters``, the column-iterations of
``gp/exact_cg.mbcg`` run and run on columns not yet frozen.
``eof.basis_uploads``, each time a ``PreProcessor`` puts its transform's
constants on its device (once per fit or load).
"""

from __future__ import annotations

import contextlib
import itertools
import json
import logging
import threading
import time
from pathlib import Path

import numpy as np
import torch

log = logging.getLogger("gpras_tpu_torch")


class PhaseTimers:
    """Named phase wall-clocks -> timers.json (reference pipeline.py:289-294)."""

    def __init__(self) -> None:
        self._starts: dict[str, float] = {}
        self.elapsed: dict[str, float] = {}

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.elapsed[name] = self.elapsed.get(name, 0.0) + time.perf_counter() - t0

    def start(self, name: str) -> None:
        self._starts[name] = time.perf_counter()

    def stop(self, name: str) -> None:
        self.elapsed[name] = time.perf_counter() - self._starts.pop(name)

    def to_file(self, path: str | Path) -> None:
        Path(path).parent.mkdir(parents=True, exist_ok=True)
        with open(path, "w") as f:
            json.dump(self.elapsed, f, indent=4)


@contextlib.contextmanager
def profiler_trace(log_dir: str | Path | None):
    """Capture a torch.profiler trace of the enclosed block into
    ``log_dir/trace.json`` (Chrome trace format; no-op if dir None), and the
    block's spans and counter totals into ``log_dir/spans.json``. The
    device's activity is recorded when a CUDA device is present."""
    if log_dir is None:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    Path(log_dir).mkdir(parents=True, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    clear()
    prof = profile(activities=activities)
    prof.start()
    try:
        yield
    finally:
        prof.stop()
        prof.export_chrome_trace(str(Path(log_dir) / "trace.json"))
        with open(Path(log_dir) / "spans.json", "w") as f:
            json.dump({"spans": records(), "totals": totals()}, f)


def log_fit_losses(info: dict, name: str = "fit", every: int = 50) -> list[float]:
    """Expand an optimizer ``info`` dict (NaN-padded losses, a tensor or a
    numpy array, possibly batched over modes) into logged per-step losses;
    returns the flat history."""
    if info.get("losses") is None:
        return []
    losses = info["losses"]
    if isinstance(losses, torch.Tensor):
        count("host_reads")
        losses = losses.detach().cpu().numpy()
    losses = np.asarray(losses)
    if losses.ndim > 1:  # (modes, steps) -> mean over modes per step
        losses = np.nanmean(losses, axis=0)
    valid = losses[np.isfinite(losses)]
    for i in range(0, len(valid), max(every, 1)):
        log.info("%s step %d: loss=%.6g", name, i, valid[i])
    if len(valid):
        log.info("%s final: loss=%.6g after %d steps", name, valid[-1], len(valid))
    return valid.tolist()


# ------------------------------------------------------------ spans, counters

_profiler_enabled = torch._C._autograd._profiler_enabled

#: the recorded spans since the last ``clear()``, in the order they opened;
#: a span's parent is an index into this list
_records: list[dict] = []
#: per record: its (start, end) CUDA events, or None
_events: list[tuple | None] = []
#: counter -> total since the last ``clear()``
_totals: dict[str, int] = {}
#: (counts dict, counter, 0-d device tensor): added when ``records()`` resolves
_pending: list[tuple[dict, str, torch.Tensor]] = []
_ids = itertools.count()
_lock = threading.Lock()
_open = threading.local()  # .stack: this thread's open spans, as record indices


def tracing() -> bool:
    """True while a ``torch.profiler`` records: spans and counts record only then."""
    return _profiler_enabled()


def _stack() -> list[int]:
    stack = getattr(_open, "stack", None)
    if stack is None:
        stack = _open.stack = []
    return stack


def current() -> tuple[int, int] | None:
    """(request id, record index) of this thread's innermost open span, or
    None. A span opened on another thread (an autograd backward) takes it as
    ``parent`` to join the request."""
    stack = getattr(_open, "stack", None)
    if not stack:
        return None
    i = stack[-1]
    return _records[i]["id"], i


_OFF = contextlib.nullcontext()  # what ``span`` returns while nothing records


def span(name: str, parent: tuple[int, int] | None = None):
    """A context manager that records the enclosed block as the span
    ``name`` while a profiler records, and is a shared no-op otherwise
    (``parent``: ``current()`` as another thread saw it, which records even
    where this thread's profiler state is not set; by default the innermost
    span open on this thread). A span without a parent starts a request id;
    its descendants share it."""
    if parent is None and not _profiler_enabled():
        return _OFF
    return _Span(name, parent)


class _Span:
    """One recorded span: see ``span``."""

    def __init__(self, name: str, parent: tuple[int, int] | None):
        self.name, self.parent = name, parent

    def __enter__(self) -> None:
        stack = _stack()
        parent = self.parent if self.parent is not None else current()
        rid = parent[0] if parent is not None else next(_ids)
        self.rec = {"name": self.name, "id": rid,
                    "parent": None if parent is None else parent[1],
                    "start_ns": time.time_ns(), "end_ns": None, "counts": {},
                    "device_s": None}
        self.events = None
        if torch.cuda.is_initialized():
            self.events = (torch.cuda.Event(enable_timing=True),
                           torch.cuda.Event(enable_timing=True))
        with _lock:
            stack.append(len(_records))
            _records.append(self.rec)
            _events.append(self.events)
        self.rf = torch.profiler.record_function(self.name)
        self.rf.__enter__()
        if self.events is not None:
            self.events[0].record()

    def __exit__(self, *exc) -> None:
        if self.events is not None:
            self.events[1].record()
        self.rf.__exit__(*exc)
        self.rec["end_ns"] = time.time_ns()
        _stack().pop()


def count(name: str, n: int | torch.Tensor = 1) -> None:
    """Add ``n`` (an int, or a 0-d tensor, never read here) to the counter
    ``name``: to this thread's innermost open span and to the total. Does
    nothing unless a profiler records."""
    if not _profiler_enabled():
        return
    stack = getattr(_open, "stack", None)
    targets = [_totals] + ([_records[stack[-1]]["counts"]] if stack else [])
    with _lock:
        for d in targets:
            if isinstance(n, torch.Tensor):
                _pending.append((d, name, n))
                d.setdefault(name, 0)
            else:
                d[name] = d.get(name, 0) + int(n)


def _resolve() -> None:
    """Fill in the device intervals and the device counts, after one
    synchronize."""
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()
    for d, name, t in _pending:
        d[name] += int(t)
    _pending.clear()
    for rec, ev in zip(_records, _events):
        if ev is not None and rec["device_s"] is None and rec["end_ns"] is not None:
            rec["device_s"] = ev[0].elapsed_time(ev[1]) * 1e-3


def records() -> list[dict]:
    """The spans recorded since the last ``clear()``, resolved: each a dict
    of ``name``, ``id`` (request), ``parent`` (index in this list, or None),
    ``start_ns`` and ``end_ns`` (host, ``time.time_ns()``), ``counts`` and
    ``device_s`` (between the span's CUDA events; None off the card)."""
    _resolve()
    return _records


def totals() -> dict[str, int]:
    """Each counter's total since the last ``clear()``, resolved."""
    _resolve()
    return dict(_totals)


def clear() -> None:
    """Forget every record and total."""
    with _lock:
        _records.clear()
        _events.clear()
        _totals.clear()
        _pending.clear()

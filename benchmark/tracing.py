"""The traced stretch of a run: ``torch.profiler`` over a few frames or one
step inside the window, its events kept in memory (no trace file), and
the per-layer metric readers that take their numbers from it."""

from __future__ import annotations

import contextlib
import dataclasses
import importlib.util
from pathlib import Path
from typing import Dict, List

import torch
from torch.profiler import ProfilerActivity, profile, record_function

from benchmark.metrics import _busy

STRETCH = "bench.stretch"
METRICS_DIR = Path(__file__).resolve().parent / "metrics"


@dataclasses.dataclass
class Trace:
    """What a reader sees: the device operations (name, start, end) and the
    host operations (name, start, end) of the stretch, in nanoseconds of
    the profiler's clock; the stretch itself (``lo``, ``hi``); how many
    frames or steps it held; and what the run knows beside it (``info``:
    the traffic kind, the integrator, the reference's march work of the
    stretch's frames, the window's peak memory, and ``unit_s``, the mean
    wall time of the window's frames or steps outside the stretch, which
    the profiler did not slow)."""

    device: List[tuple]
    host: List[tuple]
    lo: int
    hi: int
    units: int
    info: Dict

    def idle_share(self) -> float:
        """1 - the busy time a frame or step over its unprofiled wall time
        (``info["unit_s"]``; the stretch's own wall time where the window
        had nothing else)."""
        busy_ns = sum(b - a for a, b in self.busy) / self.units
        wall_ns = self.info.get("unit_s", (self.hi - self.lo) / self.units / 1e9) * 1e9
        return 1.0 - busy_ns / wall_ns

    @property
    def busy(self):
        return _busy.union(((a, b) for _, a, b in self.device), self.lo, self.hi)

    def busy_ns(self, part: str = "") -> int:
        """Device-busy ns of the operations whose name holds ``part``."""
        return _busy.covered(((a, b) for n, a, b in self.device if part in n),
                             self.lo, self.hi)


class Capture:
    """``with capture.stretch(units, info):`` profiles what runs inside;
    :attr:`trace` reads the events afterwards, once the window has closed
    (reading a long trace takes seconds), with what the driver added to
    ``info`` meanwhile.  Needs the CUDA card: a trace of the CPU is no
    device trace."""

    def __init__(self):
        if not torch.cuda.is_available():
            raise RuntimeError("a device trace needs the CUDA card")
        self._prof, self._trace, self.units, self.info = None, None, 0, {}

    @contextlib.contextmanager
    def stretch(self, units: int, info: Dict):
        self.units, self.info = units, dict(info)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            with record_function(STRETCH):
                yield
                torch.cuda.synchronize()
        self._prof = prof

    @property
    def trace(self) -> Trace:
        if self._trace is None:
            if self._prof is None:
                raise RuntimeError("the run traced no stretch")
            self._trace = _read(self._prof, self.units, self.info)
            self._prof = None
        return self._trace


def _read(prof, units: int, info: Dict) -> Trace:
    device, host, lo, hi = [], [], None, None
    for e in prof.profiler.kineto_results.events():
        name, a = e.name(), e.start_ns()
        b = a + e.duration_ns()
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            if not e.is_user_annotation() and not name.startswith("bench."):
                device.append((name, a, b))
        elif name == STRETCH:
            lo, hi = a, b
        else:
            host.append((name, a, b))
    if lo is None:
        raise RuntimeError("the profiler recorded no stretch")
    if not device:
        raise RuntimeError("the profiler recorded no device operation")
    return Trace(device=device, host=host, lo=lo, hi=hi, units=units, info=info)


def reader(name: str, metrics_dir: Path = METRICS_DIR):
    """The ``read`` function of metric ``name`` (``metrics/<name>.py``)."""
    path = metrics_dir / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"benchmark.metrics.{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def device_fields(trace: Trace) -> Dict:
    """``busy_s`` and ``window_s`` of the traced stretch."""
    busy = sum(b - a for a, b in trace.busy)
    return dict(busy_s=busy / 1e9, window_s=(trace.hi - trace.lo) / 1e9)


def breakdown(trace: Trace) -> Dict:
    """The device operations that took most time, and the longest idle
    gaps by what the host was doing."""
    return dict(device_ops=_busy.device_ops(trace.device, trace.lo, trace.hi),
                idle_gaps=_busy.idle_gaps(trace.busy, trace.host, trace.lo, trace.hi))

"""CUDA graphs of the tracer: each shape of ``tracer.trace_rays_record_rows``
captured once and replayed, so that the card runs a trace's hundreds of
launches from one host call instead of the host dispatching them one by
one.

A graph's body is the eager trace itself (``tracer._trace_record_rows``),
captured on a side stream against static inputs: the rays, the active
mask, and a copy of each scene tensor the trace reads besides the meshes
(:func:`leaves`: the black hole's, ``time`` and ``disk_gain``).  A replay
copies the call's live values in on the current stream, replays, and
returns a clone of the graph's output, so that a later replay cannot
overwrite what a caller holds.  The meshes are read in place; the address
of every tensor the mesh kernel reads is part of the key
(``kernels.mesh.graph_key``) and the graph holds those tensors.

Whether a call replays is decided from what it can observe.  It runs
eagerly where :func:`eager_reason` gives a reason: on the host, where
autograd would record, in array texture mode with the disk on (the array
composite's ``nonzero`` waits on the card), or with no rays.  Otherwise
the key (:func:`graph_key`: the device, the shapes and dtypes, whether a
mask is given, ``rounds``, the frozen ``RenderConfig`` and the meshes) is
traced eagerly at its first sighting, which is also the warm-up that a
capture needs (the kernel library's per-device stream and occupancy, the
cached constants); captured at its second, unless a profiler records; and
replayed from then on.  A capture that raises leaves its key eager for the
rest of the process.  At most LIMIT graphs a device are kept, the least
recently used evicted: a sharded render's share changes its ray count from
frame to frame.

A capture records the launch counts its body makes and takes them back (it
launched nothing); each replay adds them (``kernels.add_launch_counts``),
so ``kernels.launch_counts`` stays true.  A replay records no span of the
work inside it.
"""

from __future__ import annotations

import collections
import dataclasses
import threading
import warnings
from typing import Callable, Dict, List, Optional, Tuple

import torch

from bhx_torch import kernels
from bhx_torch.kernels import mesh as mesh_kernel
from bhx_torch.profiling import recording

# Graphs kept a device.
LIMIT = 8
# Keys seen once, remembered for their second sighting.
SEEN_LIMIT = 256

# What :meth:`Graphs.action` decides for a graphable call.
EAGER, CAPTURE, REPLAY = "eager", "capture", "replay"

# The reasons of :func:`eager_reason`.
ON_HOST = "not on a CUDA device"
AUTOGRAD = "autograd records"
HOST_SYNC = "the array composite waits on the card"
NO_RAYS = "no rays"


def leaves(scene) -> List[torch.Tensor]:
    """The scene tensors that a trace reads besides the meshes: the black
    hole's, in field order, then ``time`` and ``disk_gain``."""
    bh = scene.black_hole
    return [getattr(bh, f.name) for f in dataclasses.fields(bh)] + [scene.time,
                                                                     scene.disk_gain]


def eager_reason(origins: torch.Tensor, directions: torch.Tensor, scene,
                 cfg) -> Optional[str]:
    """Why a trace of these inputs runs eagerly, or None where it may run as
    a graph."""
    if cfg.texture_mode == "array" and cfg.show_disk:
        return HOST_SYNC
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (origins, directions, *leaves(scene))):
        return AUTOGRAD
    if origins.device.type != "cuda":
        return ON_HOST
    if origins.shape[0] == 0:
        return NO_RAYS
    return None


def graph_key(origins: torch.Tensor, directions: torch.Tensor, scene, cfg, rounds: int,
              active: Optional[torch.Tensor]) -> Tuple[tuple, list]:
    """(the key of a trace's graph: everything its body branches on or bakes
    in; the tensors that the graph reads in place, which it holds)."""
    if cfg.render_meshes and scene.meshes:
        meshes, keep = mesh_kernel.graph_key(scene.meshes)
    else:
        meshes, keep = (), []
    key = (origins.device, tuple(origins.shape), origins.dtype, tuple(directions.shape),
           directions.dtype, active is not None, rounds, cfg,
           tuple((tuple(t.shape), t.dtype) for t in leaves(scene)), meshes)
    return key, keep


class _Graph:
    """One captured trace: its static inputs, the graph, its output, and the
    launch counts that a replay makes."""

    def __init__(self, body: Callable, origins, directions, scene, cfg, rounds: int,
                 active, keep: list, stream: torch.cuda.Stream):
        static = lambda t: torch.empty_like(t, memory_format=torch.contiguous_format)  # noqa: E731
        self.origins, self.directions = static(origins), static(directions)
        self.active = None if active is None else static(active)
        self.leaves = [static(t) for t in leaves(scene)]
        bh = dataclasses.replace(scene.black_hole, **{
            f.name: t for f, t in zip(dataclasses.fields(scene.black_hole), self.leaves)})
        scene = dataclasses.replace(scene, black_hole=bh, time=self.leaves[-2],
                                    disk_gain=self.leaves[-1])
        self.keep = keep
        # Recorded after each replay's clone: the next replay, on whatever
        # stream, writes the inputs and the output only after it.
        self.done = torch.cuda.Event()
        self.graph = torch.cuda.CUDAGraph()
        current = torch.cuda.current_stream(origins.device)
        stream.wait_stream(current)
        before = kernels.launch_counts()
        try:
            with torch.cuda.stream(stream):
                self.graph.capture_begin()
                try:
                    self.out = body(self.origins, self.directions, scene, cfg, rounds,
                                    self.active)
                finally:
                    self.graph.capture_end()
        finally:
            after = kernels.launch_counts()
            self.launches = {k: after[k] - before[k] for k in after if after[k] != before[k]}
            kernels.add_launch_counts({k: -c for k, c in self.launches.items()})
        current.wait_stream(stream)

    def replay(self, origins, directions, scene, active) -> torch.Tensor:
        stream = torch.cuda.current_stream(origins.device)
        stream.wait_event(self.done)
        torch._foreach_copy_(self.leaves, leaves(scene))
        self.origins.copy_(origins)
        self.directions.copy_(directions)
        if active is not None:
            self.active.copy_(active)
        self.graph.replay()
        kernels.add_launch_counts(self.launches)
        out = self.out.clone()
        self.done.record(stream)
        return out


class Graphs:
    """The graphs of a process's traces, a bounded LRU a device, with the
    keys seen once and those whose capture raised."""

    def __init__(self):
        self._lock = threading.Lock()
        self.clear()

    def clear(self) -> None:
        """Forget every graph and every sighting."""
        self._graphs: Dict[torch.device, collections.OrderedDict] = {}
        self._seen: collections.OrderedDict = collections.OrderedDict()
        self._eager_only: set = set()
        self._streams: Dict[torch.device, torch.cuda.Stream] = {}

    def __len__(self) -> int:
        return sum(len(g) for g in self._graphs.values())

    def action(self, key: tuple, device: torch.device, recording_now: bool) -> str:
        """EAGER, CAPTURE or REPLAY for a graphable call of ``key``: replay a
        kept graph; capture at the second sighting unless the key failed or a
        profiler records; else trace eagerly, noting the sighting."""
        graphs = self._graphs.get(device)
        if graphs is not None and key in graphs:
            graphs.move_to_end(key)
            return REPLAY
        if key in self._eager_only:
            return EAGER
        if key in self._seen and not recording_now:
            return CAPTURE
        self._seen[key] = None
        self._seen.move_to_end(key)
        if len(self._seen) > SEEN_LIMIT:
            self._seen.popitem(last=False)
        return EAGER

    def add(self, key: tuple, device: torch.device, graph) -> None:
        """Keep ``graph`` for ``key``, evicting the least recently used past
        LIMIT on its device."""
        graphs = self._graphs.setdefault(device, collections.OrderedDict())
        graphs[key] = graph
        while len(graphs) > LIMIT:
            graphs.popitem(last=False)
        self._seen.pop(key, None)

    def fail(self, key: tuple) -> None:
        """Trace ``key`` eagerly from now on."""
        self._eager_only.add(key)
        self._seen.pop(key, None)

    def trace(self, body: Callable, origins, directions, scene, cfg, rounds: int,
              active) -> Tuple[torch.Tensor, bool]:
        """``body(origins, directions, scene, cfg, rounds, active)``, the eager
        trace, or its graph's replay on the same inputs; and whether it was a
        replay."""
        if eager_reason(origins, directions, scene, cfg) is None:
            key, keep = graph_key(origins, directions, scene, cfg, rounds, active)
            device = origins.device
            with self._lock:
                act = self.action(key, device, recording())
                if act == CAPTURE:
                    stream = self._streams.get(device)
                    if stream is None:
                        stream = self._streams[device] = torch.cuda.Stream(device)
                    try:
                        self.add(key, device, _Graph(body, origins, directions, scene, cfg,
                                                     rounds, active, keep, stream))
                        act = REPLAY
                    except Exception as e:  # any capture fault: trace this key eagerly
                        self.fail(key)
                        warnings.warn(f"a trace's CUDA graph capture failed, so its "
                                      f"shape is traced eagerly: {e!r}")
                if act == REPLAY:
                    graph = self._graphs[device][key]
                    return graph.replay(origins, directions, scene, active), True
        return body(origins, directions, scene, cfg, rounds, active), False


# The process's graphs: ``tracer.trace_rays_record_rows`` replays through them.
GRAPHS = Graphs()

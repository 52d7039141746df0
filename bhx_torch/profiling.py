"""Spans and lane counters inside the port, on ``torch.profiler``'s clock
(the counterpart of ``bhx/profiling.py``), and an exporter of one
profiled block.

A span is a ``record_function`` range that the program opens at a layer's
boundary: the whole render, each ladder level, the tracer, each kernel
entry, the sky, the post chain's stages, the parts of a train step and
each kernel's backward replay.  The names are the constants below;
readers of a trace match them, so a rename shows there as a missing span.
Spans are recorded only while a profiler records: otherwise :func:`span`
returns one shared no-op context, for the cost of a call and a branch.
A CUDA graph's replay records no span of the work it replays.

The lane counters (:data:`LANES`, :data:`ACTIVE_LANES`) count the lanes
that each call of ``tracer.trace_rays_record_rows`` carries and those of
them that are live, also only while a profiler records.  Live lanes of a
masked call are summed on the device into the next slot of a ring of
int64 sums, allocated once a device, with no host sync (a sum written in
place: the reduction and its cast, no add); :func:`counts` reads the
totals (the only sync) and :func:`reset_counts` zeroes them.  Beside
them :data:`CALLS` and :data:`GRAPH_REPLAYS` count the tracer's calls and
those of them that replayed a CUDA graph (``bhx_torch.graphs``), and
:data:`MARCH_BACKWARDS` and :data:`MARCH_ADJOINTS` the march's backward
passes and those of them that ran the Euler adjoint kernel, also only
while a profiler records.
"""

from __future__ import annotations

import contextlib
import json
import os
from typing import Dict, Optional

import torch
from torch.autograd import profiler as _autograd_profiler
from torch.profiler import record_function

PREFIX = "bhx_torch."

# The entry: ``pipeline.render``, the whole call.
RENDER = "bhx_torch.render"
# The ladder: level k of ``pipeline.ladder_trace_rows`` is LADDER + ".L<k>"
# (:func:`ladder_level`): level 0's dense trace; for k >= 1 the level's
# rays, its refine masks (two LADDER_MASKS spans inside the level's), its
# masked re-trace and the merge.
LADDER = "bhx_torch.ladder"
LADDER_MASKS = "bhx_torch.ladder.masks"
# The tracer: ``tracer.trace_rays_record_rows``, the whole call, and in it
# each straight phase, each march phase (its kernel launch and the fold of
# its output into the state, with the merge of its crossing slots, a
# TRACE_MERGE span a slot) and the deferred shade with the classification.
# Under exact Kerr geodesics each straight phase holds a TRACE_KERR_MOMENTUM
# span: the null momentum at the sphere boundary and its selects.
# These phases, and the ladder's masks, name the host's time between
# operations in a trace's breakdown, which looks a few hundred operations
# back for the range around a gap.
TRACE = "bhx_torch.trace"
TRACE_STRAIGHT = "bhx_torch.trace.straight_phase"
TRACE_KERR_MOMENTUM = "bhx_torch.trace.kerr_momentum"
TRACE_MARCH = "bhx_torch.trace.march_phase"
TRACE_MERGE = "bhx_torch.trace.merge"
TRACE_SHADE = "bhx_torch.trace.shade"
# Each kernel entry's forward call (argument checks, scratch allocation,
# launch; the plain version on the CPU).  The array-texture composite and
# sky, plain torch, take the composite's and the sky's names.
KERNEL_MARCH = "bhx_torch.kernel.march"
KERNEL_COMPOSITE = "bhx_torch.kernel.composite"
KERNEL_MESH = "bhx_torch.kernel.mesh"
KERNEL_SKY = "bhx_torch.kernel.sky"
# The sky pass: ``tracer.finalize_image_rows`` / ``finalize_image``.
SKY = "bhx_torch.sky"
# The post chain (``pipeline._post``): bloom; mix + ACES; FXAA.
POST_BLOOM = "bhx_torch.post.bloom"
POST_TONEMAP = "bhx_torch.post.tonemap"
POST_FXAA = "bhx_torch.post.fxaa"
# ``parallel.train_step``'s parts; the all-reduce only over more than one rank.
STEP_FORWARD = "bhx_torch.step.forward"
STEP_BACKWARD = "bhx_torch.step.backward"
STEP_ALL_REDUCE = "bhx_torch.step.all_reduce"
STEP_OPTIMIZER = "bhx_torch.step.optimizer"
# Each kernel's backward replay, the body of its ``*_replay`` function.
REPLAY_MARCH = "bhx_torch.replay.march"
REPLAY_COMPOSITE = "bhx_torch.replay.composite"
REPLAY_INGREDIENTS = "bhx_torch.replay.ingredients"
REPLAY_SKY = "bhx_torch.replay.sky"
REPLAY_SKY_FINALIZE = "bhx_torch.replay.sky_finalize"

# The lane counters' names in :func:`counts`.
LANES = "trace.lanes"
ACTIVE_LANES = "trace.active_lanes"
# The tracer's calls, and those that replayed a CUDA graph.
CALLS = "trace.calls"
GRAPH_REPLAYS = "trace.graph_replays"
# The march's backward passes (``kernels.march``: ``march_replay`` or
# ``euler_adjoint``), and those that ran the adjoint kernel.
MARCH_BACKWARDS = "replay.march_calls"
MARCH_ADJOINTS = "replay.march_adjoints"

_OFF = contextlib.nullcontext()
_LEVELS = tuple(f"{LADDER}.L{k}" for k in range(8))


def recording() -> bool:
    """Whether a profiler records (in this process, on any thread)."""
    return _autograd_profiler._is_profiler_enabled


def span(name: str):
    """A ``record_function(name)`` range while a profiler records, the
    shared no-op context otherwise."""
    if _autograd_profiler._is_profiler_enabled:
        return record_function(name)
    return _OFF


def ladder_level(k: int) -> str:
    """The span name of ladder level ``k``."""
    return _LEVELS[k] if k < len(_LEVELS) else f"{LADDER}.L{k}"


# Masked calls' sums kept apart before they are folded into slot 0.
RING_SLOTS = 1024

_lanes = 0
_active_host = 0
_calls = 0
_graph_replays = 0
_march_backwards = 0
_march_adjoints = 0
# device -> [ring of int64 sums, next slot]
_active_device: Dict[torch.device, list] = {}


def count_lanes(n: int, active: Optional[torch.Tensor]) -> None:
    """Count a trace of ``n`` lanes, all live or those set in ``active``
    (bool (n,)), while a profiler records."""
    global _lanes, _active_host
    if not _autograd_profiler._is_profiler_enabled:
        return
    _lanes += n
    if active is None:
        _active_host += n
        return
    entry = _active_device.get(active.device)
    if entry is None:
        entry = _active_device[active.device] = [
            torch.zeros(RING_SLOTS, dtype=torch.int64, device=active.device), 0]
    ring, slot = entry
    if slot == RING_SLOTS:
        ring[0] = ring.sum()
        ring[1:].zero_()
        slot = 1
    torch.sum(active, 0, out=ring[slot])
    entry[1] = slot + 1


def count_call(replayed: bool) -> None:
    """Count a call of the tracer, and whether it replayed a CUDA graph, while
    a profiler records."""
    global _calls, _graph_replays
    if _autograd_profiler._is_profiler_enabled:
        _calls += 1
        _graph_replays += replayed


def count_march_backward(adjoint: bool) -> None:
    """Count a backward pass of the march, and whether it ran the adjoint
    kernel, while a profiler records."""
    global _march_backwards, _march_adjoints
    if _autograd_profiler._is_profiler_enabled:
        _march_backwards += 1
        _march_adjoints += adjoint


def counts() -> Dict[str, int]:
    """The counters' totals since the last :func:`reset_counts`."""
    live = _active_host + sum(int(ring.sum()) for ring, _ in _active_device.values())
    return {LANES: _lanes, ACTIVE_LANES: live, CALLS: _calls, GRAPH_REPLAYS: _graph_replays,
            MARCH_BACKWARDS: _march_backwards, MARCH_ADJOINTS: _march_adjoints}


def reset_counts() -> None:
    """Zero the counters."""
    global _lanes, _active_host, _calls, _graph_replays, _march_backwards, _march_adjoints
    _lanes = _active_host = _calls = _graph_replays = _march_backwards = _march_adjoints = 0
    for entry in _active_device.values():
        entry[0].zero_()
        entry[1] = 0


@contextlib.contextmanager
def profile_trace(logdir: Optional[str]):
    """``torch.profiler`` over the block (the card's kernels too, where there
    is one), written as a Chrome trace to ``logdir/trace.json``, with the
    block's counters in ``logdir/counts.json``; nothing when
    ``logdir`` is empty."""
    if not logdir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    reset_counts()
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
    with open(os.path.join(logdir, "counts.json"), "w") as f:
        json.dump(counts(), f)

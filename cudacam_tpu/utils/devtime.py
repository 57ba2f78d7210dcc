"""Device busy time from a profiler trace.

The host clock around ``block_until_ready`` measures what a caller waits
for, dispatch and synchronisation included. The device's own timeline says
how long the card computed. ``device_time_ms_per_call`` runs a callable
under ``jax.profiler.trace`` and reduces the trace to device busy time per
call.

The reduction (``device_busy_ns``) reads the XSpace planes named
``/device:GPU:<n>``. On each, kernel and copy intervals are the events of
the CUDA stream lines (``Stream #...``); the derived ``XLA Modules`` /
``XLA Ops`` lines repeat the same time at coarser grain and are not counted.
Busy time is the union of a plane's stream intervals (overlapping kernels
on two streams count once), summed over planes. On the CPU there is no
device lane and the result is None; on a GPU, a trace without a device
plane is an error, never a silent fallback to the host clock.
"""
from __future__ import annotations

import glob
import os
import tempfile
from typing import Callable, Iterable, List, Optional, Tuple

import jax

DEVICE_PLANE_PREFIX = "/device:GPU:"
STREAM_LINE_PREFIX = "Stream #"


def union_ns(intervals: Iterable[Tuple[float, float]]) -> float:
    """Total length of the union of (start, end) intervals."""
    total = 0.0
    cur_start = cur_end = None
    for start, end in sorted(intervals):
        if cur_end is None or start > cur_end:
            if cur_end is not None:
                total += cur_end - cur_start
            cur_start, cur_end = start, end
        else:
            cur_end = max(cur_end, end)
    if cur_end is not None:
        total += cur_end - cur_start
    return total


def stream_intervals(plane) -> List[Tuple[float, float]]:
    """(start_ns, end_ns) of every event on a device plane's stream lines."""
    return [
        (e.start_ns, e.start_ns + e.duration_ns)
        for line in plane.lines
        if line.name.startswith(STREAM_LINE_PREFIX)
        for e in line.events
    ]


def device_busy_ns(planes, platform: str) -> Optional[float]:
    """Device busy nanoseconds in a trace (see the module docstring).
    ``planes`` is ``jax.profiler.ProfileData(...).planes``; ``platform`` is
    ``jax.devices()[0].platform`` of the traced process."""
    if platform == "cpu":
        return None
    devs = [p for p in planes if p.name.startswith(DEVICE_PLANE_PREFIX)]
    if not devs:
        raise RuntimeError(
            f"profiler trace on platform {platform!r} has no "
            f"{DEVICE_PLANE_PREFIX}* plane"
        )
    return sum(union_ns(stream_intervals(p)) for p in devs)


def read_trace(logdir: str):
    """ProfileData of the newest ``.xplane.pb`` under ``logdir``."""
    from jax.profiler import ProfileData

    files = glob.glob(os.path.join(logdir, "**", "*.xplane.pb"), recursive=True)
    if not files:
        raise RuntimeError(f"no .xplane.pb trace under {logdir}")
    return ProfileData.from_file(max(files, key=os.path.getmtime))


def device_time_ms_per_call(
    fn: Callable[[], object], calls: int = 4
) -> Optional[float]:
    """Device busy ms per invocation of ``fn`` (which must be warm: already
    compiled, every input already dispatched once), summed over every
    executable the call runs. None on the CPU."""
    platform = jax.devices()[0].platform
    if platform == "cpu":
        return None
    jax.block_until_ready(fn())
    with tempfile.TemporaryDirectory() as logdir:
        with jax.profiler.trace(logdir):
            for _ in range(calls):
                jax.block_until_ready(fn())
        busy = device_busy_ns(read_trace(logdir).planes, platform)
    return busy / calls / 1e6

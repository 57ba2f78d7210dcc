"""Capture a profiler trace of the 1080p engine stream (run on the GPU).

Usage: python tools/trace_capture.py LOGDIR

Streams 8 distinct device-resident frames 4 times under
``jax.profiler.trace`` and prints the traced wall time plus the device
busy time the trace reduces to (utils/devtime.py). Open LOGDIR in
TensorBoard/XProf or read it with ``jax.profiler.ProfileData``.
"""
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

from cudacam_tpu import CannyConfig
from cudacam_tpu.engine import CannyEngine
from cudacam_tpu.io.sources import make_scene
from cudacam_tpu.utils.devtime import device_busy_ns, read_trace

logdir = sys.argv[1]
h, w = 1080, 1920
cfg = CannyConfig(height=h, width=w)
eng = CannyEngine(cfg)
eng.warmup()
frames = [jax.device_put(make_scene(h, w, seed=s)) for s in range(8)]
for f in frames:
    out = eng.process(f)
jax.block_until_ready(out)

t0 = time.perf_counter()
with eng.trace(logdir):
    for _ in range(4):
        for f in frames:
            out = eng.process(f)
    jax.block_until_ready(out)
dt = time.perf_counter() - t0
busy_ns = device_busy_ns(read_trace(logdir).planes, jax.devices()[0].platform)
print(json.dumps({
    "traced_s": dt,
    "per_frame_ms": dt * 1e3 / 32,
    "device_busy_ms_per_frame": None if busy_ns is None else busy_ns / 32e6,
}))

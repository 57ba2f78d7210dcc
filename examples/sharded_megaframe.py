"""Shard a mega-frame over a device mesh with halo exchange.

Works on several GPUs or on virtual CPU devices:

    JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
        python examples/sharded_megaframe.py
"""
import os
import sys

# Make the example runnable from a source checkout (no-op when the
# package is installed).
sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np

import jax
import jax.numpy as jnp

from cudacam_tpu import CannyConfig
from cudacam_tpu.io.sources import make_scene
from cudacam_tpu.parallel import build_sharded_pipeline, make_mesh
from cudacam_tpu.parallel.sharded import shard_frame

devices = jax.devices()
n = len(devices)
print(f"{n} devices on {devices[0].platform}")

# All devices on the row axis: each shard exchanges halos with two neighbours.
mesh = make_mesh(batch=1, rows=n, cols=1)
h, w = 64 * n, 1920
cfg = CannyConfig(height=h, width=w)

run = build_sharded_pipeline(cfg, mesh)

frames = np.stack([make_scene(h, w, seed=s) for s in range(2)])
sharded = shard_frame(jnp.asarray(frames), mesh)
out = run(sharded, jnp.int32(10), jnp.int32(40))
jax.block_until_ready(out)
print("sharded edge maps:", out.shape, "sharding:", out.sharding)

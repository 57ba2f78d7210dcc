"""Worker process for tests/test_distributed.py — one of N jax.distributed
processes on CPU, each owning 4 virtual devices of a shared 2x4=8-device
pod. Runs the sharded pipeline on a (b, y, x) pod mesh and verifies its
addressable output shards against the NumPy oracle. Exits 0 on success.

Usage: python distributed_worker.py PORT PROCESS_ID NUM_PROCESSES [COLS]
"""
import os
import sys

port, pid, nprocs = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
cols = int(sys.argv[4]) if len(sys.argv) > 4 else 1
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
os.environ["JAX_PLATFORMS"] = "cpu"

import jax
import jax.numpy as jnp
import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from cudacam_tpu import CannyConfig
from cudacam_tpu.ops import numpy_oracle as oracle
from cudacam_tpu.parallel import distributed
from cudacam_tpu.parallel.sharded import build_sharded_pipeline, shard_frame

distributed.initialize(
    coordinator_address=f"127.0.0.1:{port}",
    num_processes=nprocs,
    process_id=pid,
)
assert jax.process_count() == nprocs, jax.process_count()
assert jax.local_device_count() == 4
assert jax.device_count() == 4 * nprocs
assert distributed.is_coordinator() == (pid == 0)

# cols=1: (b=1, y=4*nprocs, x=1) — row halos cross processes.
# cols=8 with 4 processes: (b=1, y=2, x=8) — local devices pack the x axis
# first, so BOTH the y boundary (process 0|1 vs 2|3) and the x boundary
# (process 0 vs 1, 2 vs 3) are cross-process halo exchanges.
mesh = distributed.pod_mesh(batch=1, cols=cols)

# Deterministic frame: cross-shard snakes. Each dim (85) line yields
# candidate flank chains (a line's NMS survivors are its two flanks at
# about half its value); only the short bright (255) lead segment clears
# high=90, so reaching the far end REQUIRES hysteresis promotion across
# every shard boundary on that axis — including the cross-process ones
# (y at row 32 for 2 procs and for cols=8; x at col 48 for cols=8). The
# lines don't intersect (horizontal stops at col 85; vertical at col 90).
h, w = 64, 96
frame = np.zeros((h, w), np.uint8)
frame[:, 90] = 85
frame[:10, 90] = 255
frame[40, :86] = 85
frame[40, :10] = 255
cfg = CannyConfig(height=h, width=w, channels=1)
run = build_sharded_pipeline(cfg, mesh)

from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P

garr = jax.make_array_from_callback(
    (1, h, w),
    NamedSharding(mesh, P("b", "y", "x")),
    lambda idx: frame[None][idx],
)
out = run(garr, jnp.int32(5), jnp.int32(90))
jax.block_until_ready(out)

exp = oracle.canny_pipeline(frame, low=5, high=90)["hyster"][None]
checked = 0
for shard in out.addressable_shards:
    got = np.asarray(shard.data)
    want = exp[shard.index]
    assert (got == want).all(), f"shard {shard.index} mismatch"
    checked += 1
assert checked == 4, checked
# The promotion really crossed shards on BOTH axes: the dim flank chains
# reached far past every boundary (only the first ~10 rows/cols seed >90).
assert exp[0, 60, 88] == 255 or exp[0, 60, 92] == 255  # vertical, past y=32
assert exp[0, 38, 80] == 255 or exp[0, 42, 80] == 255  # horizontal, past x=48
print(f"OK process={pid} shards_checked={checked}")

"""Device-mesh construction helpers.

The reference is single-process single-GPU (SURVEY.md §2.4); this module is
the scaling substrate it never had: a named 3-axis mesh (batch 'b' = camera
streams, 'y' = frame rows, 'x' = frame cols) over which frames are
tile-partitioned with halo exchange between neighbouring devices. The mesh
is a plain reshape of the device list: the cards of one host are joined all
to all, so no device order is better than another.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import jax
import numpy as np
from jax.sharding import Mesh

BATCH_AXIS = "b"
ROW_AXIS = "y"
COL_AXIS = "x"
AXES = (BATCH_AXIS, ROW_AXIS, COL_AXIS)


def make_mesh(
    batch: int = 1,
    rows: Optional[int] = None,
    cols: int = 1,
    devices: Optional[Sequence[jax.Device]] = None,
) -> Mesh:
    """Build a (b, y, x) mesh. By default all devices go to the row axis
    (row-sharding a mega-frame keeps halo exchange to two neighbors)."""
    devices = list(devices if devices is not None else jax.devices())
    n = len(devices)
    if rows is None:
        if n % (batch * cols) != 0:
            raise ValueError(f"{n} devices not divisible by batch*cols={batch * cols}")
        rows = n // (batch * cols)
    if batch * rows * cols != n:
        raise ValueError(
            f"mesh {batch}x{rows}x{cols} needs {batch * rows * cols} devices, have {n}"
        )
    arr = np.asarray(devices).reshape(batch, rows, cols)
    return Mesh(arr, AXES)


def single_device_mesh() -> Mesh:
    return make_mesh(batch=1, rows=1, cols=1, devices=jax.devices()[:1])

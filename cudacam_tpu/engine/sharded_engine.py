"""ShardedCannyEngine — the CannyEngine API over a device mesh.

Gives multi-chip/multi-host deployments the same surface as the single-chip
engine (spec-locked process(), clamped runtime thresholds, run-to-stage-k)
on top of the shard_map pipeline (cudacam_tpu/parallel/sharded.py): frames
are tile-partitioned over a (batch, rows, cols) mesh with halo exchange
between neighbouring devices and psum-converged hysteresis.

Usage::

    mesh = make_mesh(batch=1, rows=4, cols=1)     # or pod_mesh() multi-host
    eng = ShardedCannyEngine(CannyConfig(height=4320, width=7680), mesh)
    edges = eng.process(frames)                    # (B, H, W) on the mesh
"""
from __future__ import annotations

from typing import Dict, Optional, Union

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh

from cudacam_tpu.config import CannyConfig
from cudacam_tpu.engine.engine import ThresholdControls
from cudacam_tpu.parallel.mesh import BATCH_AXIS, make_mesh
from cudacam_tpu.parallel.sharded import build_sharded_pipeline, shard_frame
from cudacam_tpu.stages import CannyStage
from cudacam_tpu.utils.logging import get_logger

log = get_logger("sharded_engine")

ArrayLike = Union[np.ndarray, jax.Array]


class ShardedCannyEngine(ThresholdControls):
    def __init__(
        self,
        config: CannyConfig,
        mesh: Optional[Mesh] = None,
    ) -> None:
        self._cfg = config
        self._mesh = mesh if mesh is not None else make_mesh()
        self._init_thresholds(config)
        self._fns: Dict[CannyStage, object] = {}
        log.info(
            "sharded engine: mesh=%s frame=%dx%d",
            dict(self._mesh.shape), config.height, config.width,
        )

    # -- reference accessors (cannyEdgeH.hpp:17-32 analog) -----------------

    @property
    def config(self) -> CannyConfig:
        return self._cfg

    @property
    def mesh(self) -> Mesh:
        return self._mesh

    # -- execution ----------------------------------------------------------

    def _get_fn(self, stage: CannyStage):
        fn = self._fns.get(stage)
        if fn is None:
            fn = build_sharded_pipeline(self._cfg, self._mesh, final_stage=stage)
            self._fns[stage] = fn
        return fn

    def shard(self, frames: ArrayLike) -> jax.Array:
        """Place a host (B, H, W[, C]) batch onto the mesh with the
        pipeline's input sharding."""
        return shard_frame(jnp.asarray(frames), self._mesh)

    def process(
        self,
        frames: ArrayLike,
        final_stage: CannyStage = CannyStage.HYSTER,
    ) -> jax.Array:
        """Run stages 0..final_stage on a (B, H, W[, C]) uint8 batch; B must
        be a multiple of the mesh batch axis. Returns the (B, H, W) uint8
        display buffer, sharded over the mesh."""
        arr = jnp.asarray(frames)
        c = self._cfg.channels
        expected = (self._cfg.height, self._cfg.width) + ((c,) if c == 3 else ())
        if arr.dtype != jnp.uint8 or arr.ndim != len(expected) + 1 or arr.shape[1:] != expected:
            raise ValueError(
                f"expected uint8 (B,)+{expected}, got {arr.dtype} {arr.shape}"
            )
        nb = self._mesh.shape[BATCH_AXIS]
        if arr.shape[0] % nb:
            raise ValueError(f"batch {arr.shape[0]} not divisible by mesh batch {nb}")
        if not hasattr(arr, "sharding") or arr.sharding.is_fully_replicated:
            arr = self.shard(arr)
        lo, hi = self._thresholds()
        return self._get_fn(CannyStage(final_stage))(arr, lo, hi)

    def warmup(self, final_stage: CannyStage = CannyStage.HYSTER, batch: Optional[int] = None) -> None:
        b = batch or self._mesh.shape[BATCH_AXIS]
        c = self._cfg.channels
        shape = (b, self._cfg.height, self._cfg.width) + ((c,) if c == 3 else ())
        jax.block_until_ready(
            self.process(np.zeros(shape, np.uint8), final_stage)
        )

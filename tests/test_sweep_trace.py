"""Tests for threshold sweeps, profiler tracing, and the distributed-mesh
helpers added on top of the core engine."""
from __future__ import annotations

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cudacam_tpu import CannyConfig
from cudacam_tpu.engine import CannyEngine
from cudacam_tpu.io.sources import make_scene
from cudacam_tpu.ops import xla_ops
from cudacam_tpu.ops import numpy_oracle as oracle


class TestThresholdSweep:
    @pytest.mark.slow
    def test_matches_per_pair_oracle(self):
        frame = make_scene(48, 64, seed=5)
        eng = CannyEngine(CannyConfig(height=48, width=64))
        lows = [5, 10, 40]
        highs = [20, 40, 120]
        maps, counts = eng.threshold_sweep(frame, lows, highs)
        maps = np.asarray(maps)
        counts = np.asarray(counts)
        assert maps.shape == (3, 48, 64)
        for i, (lo, hi) in enumerate(zip(lows, highs)):
            ref = oracle.canny_pipeline(frame, lo, hi)["hyster"]
            np.testing.assert_array_equal(maps[i], ref)
            assert counts[i] == (ref == 255).sum()

    @pytest.mark.slow
    def test_monotone_in_thresholds(self):
        # Higher thresholds can only reduce the edge count.
        frame = make_scene(40, 56, seed=6)
        eng = CannyEngine(CannyConfig(height=40, width=56))
        _, counts = eng.threshold_sweep(frame, [5, 20, 60], [20, 60, 150])
        c = np.asarray(counts)
        assert c[0] >= c[1] >= c[2]

    def test_validation(self):
        eng = CannyEngine(CannyConfig(height=16, width=16))
        f = np.zeros((16, 16, 3), np.uint8)
        with pytest.raises(ValueError):
            eng.threshold_sweep(f, [1, 2], [3])
        with pytest.raises(ValueError):
            eng.threshold_sweep(np.zeros((2, 16, 16, 3), np.uint8), [1], [2])


class TestTrace:
    @pytest.mark.slow
    def test_trace_writes_profile(self, tmp_path):
        eng = CannyEngine(CannyConfig(height=16, width=16))
        f = np.zeros((16, 16, 3), np.uint8)
        d = str(tmp_path / "prof")
        with eng.trace(d):
            import jax

            jax.block_until_ready(eng.process(f))
        # XProf writes plugins/profile/<run>/...
        found = []
        for root, _, files in os.walk(d):
            found += files
        assert found, "no profile artifacts written"


class TestCliSweep:
    @pytest.mark.slow
    def test_cli_sweep_json(self, capsys):
        from cudacam_tpu.cli import main as cli_main

        rc = cli_main(
            ["sweep", "--source", "synthetic:32x48",
             "--lows", "5,40", "--highs", "20,120"]
        )
        assert rc == 0
        rep = json.loads(capsys.readouterr().out)
        # cross product keeps lo<=hi pairs: (5,20),(5,120),(40,120)
        assert len(rep["sweep"]) == 3
        assert all("edge_px" in r for r in rep["sweep"])


class TestDistributedHelpers:
    def test_pod_mesh_on_virtual_devices(self):
        from cudacam_tpu.parallel.distributed import is_coordinator, pod_mesh

        mesh = pod_mesh(batch=1)
        assert mesh.shape["y"] == len(__import__("jax").devices())
        assert is_coordinator()

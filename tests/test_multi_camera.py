"""Tests for multi-camera batching (BatchSource + montage display)."""
from __future__ import annotations

import numpy as np
import pytest

from cudacam_tpu.app import CannyApp
from cudacam_tpu.config import CannyConfig
from cudacam_tpu.io import SyntheticSource, open_source
from cudacam_tpu.io.compose import compose, montage
from cudacam_tpu.io.multi import BatchSource
from cudacam_tpu.ops import numpy_oracle as oracle


def _children(n=4, h=32, w=48, frames=20):
    return [SyntheticSource(height=h, width=w, seed=s, n_frames=frames)
            for s in range(n)]


class TestBatchSource:
    def test_stacked_frames_and_per_frame_spec(self):
        with BatchSource(_children(3)) as src:
            assert src.spec == (32, 48, 3)
            assert src.batch == 3
            f = src.read()
            assert f.shape == (3, 32, 48, 3) and f.dtype == np.uint8
            # Distinct seeds -> distinct camera content.
            assert (f[0] != f[1]).any()

    def test_spec_mismatch_rejected(self):
        bad = BatchSource([
            SyntheticSource(height=32, width=48, n_frames=2),
            SyntheticSource(height=16, width=48, n_frames=2),
        ])
        with pytest.raises(ValueError):
            bad.start()

    def test_any_child_eof_ends_stream(self):
        kids = [SyntheticSource(height=16, width=16, n_frames=n) for n in (5, 2)]
        with BatchSource(kids) as src:
            got = list(src)
        assert len(got) == 2

    def test_open_source_multi_forms(self):
        s = open_source("multi:4*synthetic:24x32")
        assert isinstance(s, BatchSource) and s.batch == 4
        s2 = open_source("multi:synthetic:24x32,synthetic:24x32")
        assert s2.batch == 2


class TestMontage:
    def test_grid_shape(self):
        tiles = [np.full((10, 12, 3), i, np.uint8) for i in range(4)]
        g = montage(tiles)
        assert g.shape == (22, 26, 3)  # 2x2 grid + 2px separators
        assert (g[0, 0] == 0).all() and (g[12, 14] == 3).all()

    def test_compose_batched_overlay(self):
        raw = np.zeros((4, 10, 12, 3), np.uint8)
        proc = np.zeros((4, 10, 12), np.uint8)
        proc[:, 5, 6] = 255
        out = compose(raw, proc, "overlay")
        assert out.shape == (22, 26, 3)
        assert tuple(out[5, 6]) == (0, 0, 255)  # tile 0's red edge


class TestMultiCameraApp:
    def test_app_processes_batch_and_matches_oracle(self):
        src = BatchSource(_children(2, frames=10))
        with CannyApp(src) as app:
            app.step()
            out = app.ring.latest_np()
            assert out.shape == (2, 32, 48)
            # Each camera's map equals the single-frame oracle.
            raw = app._last_input
            for i in range(2):
                ref = oracle.canny_pipeline(raw[i], 10, 40)["hyster"]
                np.testing.assert_array_equal(out[i], ref)

    def test_montage_preview(self):
        src = BatchSource(_children(4, frames=10))
        with CannyApp(src) as app:
            app.step()
            p = app.preview(width=40, color=False, mode="split")
            assert len(p) > 0

    @pytest.mark.slow
    def test_cli_multi_run(self, capsys, tmp_path):
        from cudacam_tpu.cli import main as cli_main

        rc = cli_main(["run", "--source", "multi:2*synthetic:24x32",
                       "--frames", "3",
                       "--save", str(tmp_path / "wall.png")])
        assert rc == 0
        import cv2

        img = cv2.imread(str(tmp_path / "wall.png"))
        assert img is not None and img.shape[0] >= 24

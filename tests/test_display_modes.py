"""Tests for display composition (edges/raw/split/overlay) and video
recording — the analog of the reference's dual raw/processed textures."""
from __future__ import annotations

import os

import numpy as np
import pytest

from cudacam_tpu.app import CannyApp
from cudacam_tpu.config import CannyConfig
from cudacam_tpu.io import SyntheticSource
from cudacam_tpu.io.compose import MODES, compose


class TestCompose:
    def setup_method(self):
        self.raw = np.zeros((8, 10, 3), np.uint8)
        self.raw[..., 0] = 50
        self.edges = np.zeros((8, 10), np.uint8)
        self.edges[2, 3] = 255
        self.edges[4, 4] = 100  # below the overlay threshold

    def test_edges_mode_is_gray_bgr(self):
        out = compose(self.raw, self.edges, "edges")
        assert out.shape == (8, 10, 3)
        assert (out[2, 3] == 255).all() and (out[0, 0] == 0).all()

    def test_raw_mode(self):
        np.testing.assert_array_equal(compose(self.raw, self.edges, "raw"), self.raw)

    def test_split_mode(self):
        out = compose(self.raw, self.edges, "split")
        assert out.shape == (8, 20, 3)
        np.testing.assert_array_equal(out[:, :10], self.raw)
        assert (out[2, 13] == 255).all()

    def test_overlay_mode(self):
        out = compose(self.raw, self.edges, "overlay")
        assert tuple(out[2, 3]) == (0, 0, 255)  # red edge
        assert tuple(out[4, 4]) == (50, 0, 0)   # weak pixel untouched
        assert tuple(out[0, 0]) == (50, 0, 0)

    def test_missing_raw_falls_back(self):
        out = compose(None, self.edges, "overlay")
        assert out.shape == (8, 10, 3)

    def test_bad_mode(self):
        with pytest.raises(ValueError):
            compose(self.raw, self.edges, "nope")

    def test_all_modes_listed(self):
        assert set(MODES) == {"edges", "raw", "split", "overlay"}


class TestAppDisplay:
    def _app(self):
        src = SyntheticSource(height=32, width=48, n_frames=40)
        return CannyApp(src, CannyConfig(height=32, width=48))

    def test_published_composed(self):
        with self._app() as app:
            app.enable_publishing(every=1)
            app.step()
            edges = app.published_np("edges")
            split = app.published_np("split")
            overlay = app.published_np("overlay")
            assert edges.shape == (32, 48, 3)
            assert split.shape == (32, 96, 3)
            assert overlay.shape == (32, 48, 3)

    def test_save_frame_mode(self, tmp_path):
        with self._app() as app:
            app.step()
            p = app.save_frame(str(tmp_path / "s.png"), mode="split")
            import cv2

            img = cv2.imread(p)
            assert img.shape == (32, 96, 3)

    def test_record_video(self, tmp_path):
        import cv2

        with self._app() as app:
            app.display_mode = "overlay"
            p = app.record(5, str(tmp_path / "out.mp4"))
            assert os.path.exists(p)
            cap = cv2.VideoCapture(p)
            n = 0
            while cap.read()[0]:
                n += 1
            cap.release()
            assert n == 5

    def test_cli_video_record(self, tmp_path, capsys):
        from cudacam_tpu.cli import main as cli_main

        out = str(tmp_path / "e.avi")
        rc = cli_main(["run", "--source", "synthetic:32x48", "--frames", "3",
                       "--display", "split",
                       "--record", out])
        assert rc == 0 and os.path.exists(out)

"""Tests for the IO layer (sources, ring, metrics, preview) and the
headless app/CLI — the analog of the reference's io::webcam + ImguiApp
surface (src/io/webcam.cpp, src/imgui/imguiApp.cpp)."""
from __future__ import annotations

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from cudacam_tpu import CannyConfig, CannyStage
from cudacam_tpu.app import CannyApp
from cudacam_tpu.cli import build_parser, main as cli_main
from cudacam_tpu.io import (
    DeviceRingBuffer,
    FpsMeter,
    SequenceSource,
    SyntheticSource,
    ascii_preview,
    make_scene,
    open_source,
)


class TestSources:
    def test_synthetic_spec_lock_and_iteration(self):
        src = SyntheticSource(height=48, width=64, n_frames=5)
        with src:
            assert src.spec == (48, 64, 3)
            frames = list(src)
            assert len(frames) == 5
            assert all(f.shape == (48, 64, 3) and f.dtype == np.uint8 for f in frames)

    def test_synthetic_grayscale(self):
        # channels=1 = the reference's 8UC1 input config (cvPipeline.cpp:32),
        # reachable from the CLI as synthetic:HxWx1.
        from cudacam_tpu.io.sources import open_source

        src = open_source("synthetic:48x64x1", n_frames=3)
        with src:
            assert src.spec == (48, 64, 1)
            frames = list(src)
            assert all(f.shape == (48, 64) and f.dtype == np.uint8
                       for f in frames)
        with pytest.raises(ValueError):
            SyntheticSource(height=8, width=8, channels=2)
        with pytest.raises(ValueError):
            open_source("synthetic:8x8x1x9")

    def test_read_eof(self):
        src = SyntheticSource(height=16, width=16, n_frames=1)
        src.start()
        src.read()
        with pytest.raises(EOFError):
            src.read()
        src.stop()
        assert not src.is_running()

    def test_read_before_start_raises(self):
        with pytest.raises(RuntimeError):
            SyntheticSource(height=16, width=16).read()

    def test_sequence_npy_roundtrip(self, tmp_path):
        frames = np.stack([make_scene(24, 32, seed=s) for s in range(3)])
        p = str(tmp_path / "seq.npy")
        np.save(p, frames)
        with SequenceSource(p) as src:
            assert src.spec == (24, 32, 3)
            out = list(src)
        assert len(out) == 3
        np.testing.assert_array_equal(out[1], frames[1])

    def test_sequence_loop(self, tmp_path):
        frames = np.stack([make_scene(16, 16, seed=s) for s in range(2)])
        p = str(tmp_path / "seq.npy")
        np.save(p, frames)
        with SequenceSource(p, loop=True) as src:
            got = [src.read() for _ in range(5)]
        assert len(got) == 5
        np.testing.assert_array_equal(got[4], frames[0])

    def test_sequence_rejects_bad_dtype(self, tmp_path):
        p = str(tmp_path / "bad.npy")
        np.save(p, np.zeros((2, 8, 8), np.float32))
        src = SequenceSource(p)
        with pytest.raises(ValueError):
            src.start()

    def test_open_source_spec_parsing(self, tmp_path):
        assert isinstance(open_source("synthetic"), SyntheticSource)
        s = open_source("synthetic:32x48")
        with s:
            assert s.spec == (32, 48, 3)
        p = str(tmp_path / "x.npy")
        np.save(p, np.zeros((1, 8, 8), np.uint8))
        assert isinstance(open_source(f"seq:{p}"), SequenceSource)
        assert isinstance(open_source(p), SequenceSource)

    def test_animated_scene_changes(self):
        a = make_scene(32, 32, seed=0, t=0.0)
        b = make_scene(32, 32, seed=0, t=1.0)
        assert (a != b).any()
        # Deterministic for identical params.
        np.testing.assert_array_equal(a, make_scene(32, 32, seed=0, t=0.0))


class TestRing:
    def test_push_and_history_order(self):
        r = DeviceRingBuffer(3)
        assert r.latest() is None
        for i in range(5):
            r.push(np.full((2, 2), i, np.uint8))
        assert len(r) == 3 and r.total_pushed == 5
        assert r.latest()[0, 0] == 4
        hist = r.history()
        assert [int(h[0, 0]) for h in hist] == [4, 3, 2]
        assert int(r.get(2)[0, 0]) == 2
        with pytest.raises(IndexError):
            r.get(3)

    def test_latest_np_readback(self):
        import jax.numpy as jnp

        r = DeviceRingBuffer(2)
        r.push(jnp.ones((4, 4), jnp.uint8))
        out = r.latest_np()
        assert isinstance(out, np.ndarray) and out.sum() == 16

    def test_clear(self):
        r = DeviceRingBuffer(2)
        r.push(np.zeros(1))
        r.clear()
        assert len(r) == 0 and r.latest() is None

    def test_bad_capacity(self):
        with pytest.raises(ValueError):
            DeviceRingBuffer(0)


class TestFpsMeter:
    def test_fps_from_synthetic_clock(self):
        m = FpsMeter(window_s=10.0)
        for i in range(11):
            m.tick(now=i * 0.1)  # 10 fps
        assert abs(m.fps - 10.0) < 0.5
        assert abs(m.ms_per_frame - 100.0) < 5.0
        assert m.total_frames == 11

    def test_rolling_reset(self):
        m = FpsMeter(window_s=1.0)
        m.tick(now=0.0)
        m.tick(now=0.5)
        m.tick(now=2.0)  # past the window: resets
        m.tick(now=2.1)
        assert abs(m.fps - 10.0) < 1.0


class TestPreview:
    def test_ascii_modes(self):
        f = make_scene(32, 48, seed=3)
        plain = ascii_preview(f, width=24, color=False)
        assert len(plain.splitlines()) > 0
        assert set(plain) <= set(" .:-=+*#%@\n")
        ansi = ascii_preview(f, width=24, color=True)
        assert "\x1b[" in ansi and "▀" in ansi

    def test_save_png(self, tmp_path):
        from cudacam_tpu.io import save_png

        p = str(tmp_path / "sub" / "x.png")
        save_png(p, np.zeros((8, 8), np.uint8))
        assert os.path.exists(p)


class TestApp:
    def _app(self, **kw):
        src = SyntheticSource(height=40, width=64, n_frames=100)
        return CannyApp(src, **kw)

    @pytest.mark.slow
    def test_run_loop_and_ring(self):
        with self._app(ring_capacity=4) as app:
            n = app.run(6)
            assert n == 6
            assert len(app.ring) == 4 and app.ring.total_pushed == 6
            out = app.ring.latest_np()
            assert out.shape == (40, 64) and out.dtype == np.uint8
            assert app.fps > 0

    def test_stage_controls(self):
        with self._app() as app:
            assert app.stage == CannyStage.HYSTER
            app.set_stage(CannyStage.MONO)
            app.step()
            assert app.ring.latest_np().shape == (40, 64)
            assert app.cycle_stage() == CannyStage.GAUSSIAN
            # Wraps around the 6 stages.
            for _ in range(5):
                app.cycle_stage()
            assert app.stage == CannyStage.MONO

    def test_threshold_clamping_via_app(self):
        with self._app() as app:
            app.set_thresholds(low=200)  # clamped to high (40)
            assert app.engine.get_low_threshold() == 40
            app.set_thresholds(high=300)
            assert app.engine.get_high_threshold() == 255

    def test_pause_reuses_last_frame(self):
        with self._app() as app:
            app.step()
            app.pause()
            assert app.paused
            f1 = app._last_input
            app.step()
            assert app._last_input is f1  # no new read while paused
            app.resume()
            app.step()
            assert app._last_input is not f1

    def test_toggle_pipeline_passthrough(self):
        with self._app() as app:
            assert not app.toggle_pipeline()  # now disabled
            app.step()
            out = app.ring.latest_np()
            assert out.shape == (40, 64, 3)  # raw BGR passthrough
            assert app.toggle_pipeline()

    def test_spec_mismatch_rejected(self):
        src = SyntheticSource(height=40, width=64, n_frames=2)
        with pytest.raises(ValueError):
            CannyApp(src, config=CannyConfig(height=32, width=32))

    def test_record(self, tmp_path):
        with self._app() as app:
            p = app.record(3, str(tmp_path / "out.npy"))
            arr = np.load(p)
            assert arr.shape == (3, 40, 64) and arr.dtype == np.uint8

    def test_preview_and_save(self, tmp_path):
        with self._app() as app:
            app.step()
            assert len(app.preview(width=32, color=False)) > 0
            p = app.save_frame(str(tmp_path / "f.png"))
            assert p and os.path.exists(p)

    @pytest.mark.slow
    def test_profiling_table(self):
        with self._app(profiling=True) as app:
            app.step()
            table = app.profiling_table()
            assert "6/6 Hysteresis" in table


class TestCli:
    def test_parser_covers_surface(self):
        p = build_parser()
        args = p.parse_args(
            ["run", "--source", "synthetic:32x32", "--frames", "2",
             "--stage", "nms", "--low", "5", "--high", "50",
             "--kernel-size", "3", "--norm", "l1"]
        )
        assert args.stage == "nms" and args.kernel_size == 3

    def test_cli_run_end_to_end(self, capsys, tmp_path):
        rc = cli_main(
            ["run", "--source", "synthetic:32x48", "--frames", "3",
             "--save", str(tmp_path / "o.png")]
        )
        assert rc == 0
        out = capsys.readouterr().out
        assert "3 frames in" in out and "platform=cpu" in out
        assert os.path.exists(tmp_path / "o.png")

    def test_cli_info(self, capsys):
        assert cli_main(["info"]) == 0
        info = json.loads(capsys.readouterr().out)
        assert info["stages"][-1] == "HYSTER"
        assert sorted(info["kernel_sizes"]) == [3, 5, 7]

    def test_cli_platform_cpu(self, capsys):
        """--platform cpu pins the host platform via jax.config and the
        pipeline still runs end-to-end."""
        rc = cli_main(
            ["--platform", "cpu",
             "run", "--source", "synthetic:32x48", "--frames", "2"]
        )
        assert rc == 0
        import jax

        assert jax.config.jax_platforms == "cpu"
        assert "2 frames in" in capsys.readouterr().out


class TestPacing:
    def test_max_fps_caps_loop_rate(self):
        import time as _time

        src = SyntheticSource(height=16, width=16, n_frames=100)
        with CannyApp(src) as app:
            app.warmup()
            app.max_fps = 50.0
            t0 = _time.perf_counter()
            app.run(10)
            dt = _time.perf_counter() - t0
            # 10 frames at <=50 fps takes >= ~0.18 s (first frame unpaced).
            assert dt >= 0.15
            assert app.status()["max_fps"] == 50.0

    def test_unpaced_by_default(self):
        src = SyntheticSource(height=16, width=16, n_frames=10)
        with CannyApp(src) as app:
            assert app.max_fps is None
            assert app.status()["profiling"] is None


class TestDeviceLoop:
    """Device-loop streaming: with the device loop preloaded, step() never
    touches the source or the host->device upload path again, so the
    upload count is bounded by the preload count."""

    def test_source_read_count_is_bounded(self):
        src = SyntheticSource(height=24, width=32, n_frames=1000)
        reads = [0]
        orig = src.read

        def counted():
            reads[0] += 1
            return orig()

        src.read = counted
        with CannyApp(src) as app:
            n = app.preload_device_loop(4)
            assert n == 4
            before = reads[0]
            for _ in range(50):
                app.step()
            assert reads[0] == before  # zero further source reads/uploads
            assert app.status()["frames"] >= 50

    def test_outputs_cycle_and_match_single(self):
        import jax.numpy as jnp

        src = SyntheticSource(height=24, width=32, n_frames=100)
        with CannyApp(src) as app:
            app.preload_device_loop(3)
            outs = [np.asarray(app.step()) for _ in range(6)]
        # frame cycle period 3: step i and i+3 see identical inputs
        np.testing.assert_array_equal(outs[0], outs[3])
        np.testing.assert_array_equal(outs[1], outs[4])

    def test_publishing_uses_host_raw(self):
        src = SyntheticSource(height=24, width=32, n_frames=100)
        with CannyApp(src) as app:
            app.enable_publishing(every=1)
            app.warmup()
            app.preload_device_loop(2)
            app.step()
            pair = app._published_pair
            assert isinstance(pair[0], np.ndarray)  # host raw, not device

    def test_cli_device_loop(self):
        from cudacam_tpu.cli import main as cli_main

        rc = cli_main(["run", "--source", "synthetic:24x32", "--frames", "12",
                       "--device-loop", "3"])
        assert rc == 0


class TestKeyControls:
    """Terminal key bindings (imguiApp.cpp:180-194 analog): the dispatch
    logic is pure and routes through apply_controls."""

    def _app(self):
        return CannyApp(SyntheticSource(height=24, width=32, n_frames=100))

    def test_bindings(self):
        from cudacam_tpu.io.keys import dispatch_key
        from cudacam_tpu.stages import CannyStage

        with self._app() as app:
            assert dispatch_key(app, " ")["paused"] is True
            assert dispatch_key(app, " ")["paused"] is False
            s0 = app.stage
            st = dispatch_key(app, "s")
            assert st["stage"] == CannyStage((s0 + 1) % len(CannyStage)).name
            assert dispatch_key(app, "p")["pipeline_enabled"] is False
            assert dispatch_key(app, "p")["pipeline_enabled"] is True
            lo0 = app.engine.get_low_threshold()
            assert dispatch_key(app, "]")["low"] == lo0 + 5
            assert dispatch_key(app, "[")["low"] == lo0
            hi0 = app.engine.get_high_threshold()
            assert dispatch_key(app, "}")["high"] == hi0 + 5
            assert dispatch_key(app, "{")["high"] == hi0
            m0 = app.display_mode
            m1 = dispatch_key(app, "m")["display_mode"]
            assert m1 != m0
            assert dispatch_key(app, "t")["profiling"] is not None
            assert dispatch_key(app, "x") is None  # unbound

    def test_controller_noop_without_tty(self):
        from cudacam_tpu.io.keys import KeyController

        with self._app() as app:
            kc = KeyController(app)
            assert kc.start() is False  # pytest stdin is not a tty
            kc.stop()


class TestSpiralFrame:
    """make_spiral_frame (r5): a real adversarial IMAGE — its threshold
    map at the default (10, 40) must be a long candidate chain with few
    seeds that the engine's hysteresis crawls for cap-class round counts
    (the engine-path worst-case bench rows depend on this property)."""

    def test_adversarial_through_pipeline(self):
        import jax.numpy as jnp

        from cudacam_tpu.io.sources import make_spiral_frame
        from cudacam_tpu.ops import numpy_oracle as O
        from cudacam_tpu.ops.bitpack import hysteresis_packed

        h, w = 256, 512
        frame = make_spiral_frame(h, w)
        assert frame.shape == (h, w, 3) and frame.dtype == np.uint8
        mono = O.rgb2mono(frame)
        blur = O.gaussian_blur(mono, 5)
        sx, sy = O.sobel_sums(blur)
        keep = O.nms_keep_mask(sx, sy)
        nms = np.where(keep, O.nms_magnitude_u8(sx, sy), 0).astype(np.uint8)
        t = O.double_threshold(nms, 10, 40)
        n_f, n_c = int((t == 255).sum()), int((t == 128).sum())
        assert n_f < 200, n_f  # seeds only near the blob
        assert n_c > 10_000, n_c  # the chain dominates
        out, iters = hysteresis_packed(
            jnp.asarray(t), max_iters=2000, dilate_steps=16,
            scan_after=64, return_iters=True,
        )
        # Reachable: the chain connects to the seed and is crawled.
        assert int((np.asarray(out) == 255).sum()) > n_c // 2
        assert int(iters) > 40  # cap-class at this size; deeper at 1080p

    def test_spiral_source_spec(self):
        from cudacam_tpu.io.sources import open_source

        with open_source("spiral:64x128", n_frames=3) as src:
            assert src.spec == (64, 128, 3)
            frames = [f for _, f in zip(range(3), src)]
        assert len(frames) == 3
        assert (frames[0] == frames[1]).all()
        assert frames[0].max() == 255  # the seed blob

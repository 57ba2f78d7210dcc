"""Sharded pipeline == single-device pipeline, bit-exact, on an 8-device
virtual CPU mesh (the driver separately dry-runs the same path)."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

from cudacam_tpu import CannyConfig, CannyStage
from cudacam_tpu.ops import numpy_oracle as oracle
from cudacam_tpu.ops import xla_ops
from cudacam_tpu.parallel import build_sharded_pipeline, make_mesh
from cudacam_tpu.parallel.sharded import shard_frame

from conftest import make_bgr_frame, make_noise_frame

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs 8 virtual devices"
)


def _expected(frames, low=10, high=40, **kw):
    return np.stack([oracle.canny_pipeline(f, low=low, high=high, **kw)["hyster"] for f in frames])


@pytest.fixture(scope="module")
def frames():
    rng = np.random.default_rng(99)
    return np.stack(
        [make_bgr_frame(rng, 64, 96), make_noise_frame(rng, 64, 96), 255 - make_bgr_frame(rng, 64, 96)]
    )[:2]


class TestRowSharded:
    def test_rows8(self, frames):
        cfg = CannyConfig(height=64, width=96)
        mesh = make_mesh(batch=1, rows=8, cols=1)
        run = build_sharded_pipeline(cfg, mesh)
        out = np.asarray(run(shard_frame(jnp.asarray(frames), mesh), jnp.int32(10), jnp.int32(40)))
        np.testing.assert_array_equal(out, _expected(frames))

    def test_partial_stage(self, frames):
        cfg = CannyConfig(height=64, width=96)
        mesh = make_mesh(batch=1, rows=8, cols=1)
        for stage, key in [
            (CannyStage.GAUSSIAN, "gaussian"),
            (CannyStage.NMS, "nms"),
            (CannyStage.THRESH, "thresh"),
            (CannyStage.GRADIENT, "gradient_display"),
        ]:
            run = build_sharded_pipeline(cfg, mesh, final_stage=stage)
            out = np.asarray(run(jnp.asarray(frames), jnp.int32(10), jnp.int32(40)))
            exp = np.stack([oracle.canny_pipeline(f)[key] for f in frames])
            np.testing.assert_array_equal(out, exp, err_msg=f"stage {stage}")


class TestGridSharded:
    def test_2d_tiles(self, frames):
        # 2x4 tile grid: exercises corner halos.
        cfg = CannyConfig(height=64, width=96)
        mesh = make_mesh(batch=1, rows=2, cols=4)
        run = build_sharded_pipeline(cfg, mesh)
        out = np.asarray(run(jnp.asarray(frames), jnp.int32(10), jnp.int32(40)))
        np.testing.assert_array_equal(out, _expected(frames))

    def test_batch_and_grid(self, frames):
        # b=2, y=2, x=2: all three axes active.
        cfg = CannyConfig(height=64, width=96)
        mesh = make_mesh(batch=2, rows=2, cols=2)
        run = build_sharded_pipeline(cfg, mesh)
        out = np.asarray(run(jnp.asarray(frames), jnp.int32(10), jnp.int32(40)))
        np.testing.assert_array_equal(out, _expected(frames))


class TestCrossShardHysteresis:
    def test_edge_snakes_across_shards(self):
        # One strong seed in the top shard; a candidate line snaking through
        # every shard. The psum convergence loop must propagate it globally.
        h, w = 64, 96
        frame = np.zeros((h, w), np.uint8)
        cfg = CannyConfig(height=h, width=w, channels=1)
        mesh = make_mesh(batch=1, rows=8, cols=1)

        # A vertical line whose intensity ramps from strong to weak: finals
        # only in the top rows, an unbroken candidate chain all the way down
        # (verified against the oracle: promotion spans all 64 rows).
        frame[:, 48] = np.linspace(255, 80, h).astype(np.uint8)
        run = build_sharded_pipeline(cfg, mesh)
        out = np.asarray(run(jnp.asarray(frame)[None], jnp.int32(5), jnp.int32(90)))[0]
        exp = oracle.canny_pipeline(frame, low=5, high=90)["hyster"]
        np.testing.assert_array_equal(out, exp)
        # The weak line must actually have been promoted across shards
        # (edges run along the line's flanks, cols 46 and 50).
        assert (out[60] == 255).any()

    def test_no_seed_no_promotion(self):
        h, w = 64, 96
        frame = np.zeros((h, w), np.uint8)
        frame[:, 48] = 60  # only candidates
        cfg = CannyConfig(height=h, width=w, channels=1)
        mesh = make_mesh(batch=1, rows=8, cols=1)
        run = build_sharded_pipeline(cfg, mesh)
        out = np.asarray(run(jnp.asarray(frame)[None], jnp.int32(5), jnp.int32(90)))[0]
        exp = oracle.canny_pipeline(frame, low=5, high=90)["hyster"]
        np.testing.assert_array_equal(out, exp)


class TestKernelVariants:
    @pytest.mark.parametrize("ks", [3, 7])
    def test_kernel_sizes(self, frames, ks):
        cfg = CannyConfig(height=64, width=96, kernel_size=ks)
        mesh = make_mesh(batch=1, rows=4, cols=2)
        run = build_sharded_pipeline(cfg, mesh)
        out = np.asarray(run(jnp.asarray(frames), jnp.int32(10), jnp.int32(40)))
        np.testing.assert_array_equal(out, _expected(frames, kernel_size=ks))

    def test_opencv_parity_domain(self, frames):
        cfg = CannyConfig(height=64, width=96, parity="opencv")
        mesh = make_mesh(batch=1, rows=4, cols=2)
        run = build_sharded_pipeline(cfg, mesh)
        out = np.asarray(run(jnp.asarray(frames), jnp.int32(30), jnp.int32(120)))
        np.testing.assert_array_equal(
            out, _expected(frames, low=30, high=120, parity="opencv")
        )

    def test_l1_norm(self, frames):
        cfg = CannyConfig(height=64, width=96, norm="l1")
        mesh = make_mesh(batch=1, rows=2, cols=2, devices=jax.devices()[:4])
        run = build_sharded_pipeline(cfg, mesh)
        out = np.asarray(run(jnp.asarray(frames), jnp.int32(10), jnp.int32(40)))
        np.testing.assert_array_equal(out, _expected(frames, norm="l1"))


class TestInjectableSaturate:
    """The packed hysteresis round loop (strip exchange -> saturate ->
    psum; parallel/packed_halo.py) is one composition with an injectable
    local operator ``(f, p) -> (f, growing)``; these tests run that SAME
    composition multi-shard with different operators, so the loop logic
    that executes on a real pod is verified on the 8-device virtual
    mesh."""

    def _snake_frame(self):
        h, w = 64, 96
        frame = np.zeros((h, w), np.uint8)
        frame[:, 48] = np.linspace(255, 80, h).astype(np.uint8)
        return frame

    def _run_with(self, saturate_builder, rows=4, cols=2):
        frame = self._snake_frame()
        cfg = CannyConfig(height=64, width=96, channels=1)
        mesh = make_mesh(batch=1, rows=rows, cols=cols)
        run = build_sharded_pipeline(
            cfg, mesh, local_saturate=saturate_builder(cfg, mesh),
        )
        out = np.asarray(
            run(jnp.asarray(frame)[None], jnp.int32(5), jnp.int32(90))
        )[0]
        exp = oracle.canny_pipeline(frame, low=5, high=90)["hyster"]
        np.testing.assert_array_equal(out, exp)
        assert (out[60] == 255).any()  # cross-shard promotion happened

    @staticmethod
    def _geo(cfg, mesh):
        from cudacam_tpu.parallel.packed_halo import make_geo

        ny, nx = mesh.shape["y"], mesh.shape["x"]
        return make_geo(cfg.height // ny, cfg.width // nx, ny=ny, nx=nx)

    def test_default_packed_operator(self):
        from cudacam_tpu.parallel.sharded import xla_packed_saturate

        self._run_with(
            lambda cfg, mesh: xla_packed_saturate(cfg, self._geo(cfg, mesh))
        )

    def test_weak_operator_still_converges(self):
        # A deliberately weak operator (ONE bit-parallel dilation per
        # round): the round loop itself must carry convergence via
        # repeated exchange + psum, with the growing flag reported from
        # the state delta.
        from cudacam_tpu.ops.bitpack import _make_ops

        def weak(cfg, mesh):
            geo = self._geo(cfg, mesh)
            dilates, _ = _make_ops(geo.ext_h, geo.ext_w, 1)

            def saturate(f, p):
                nf = dilates(f, p)
                return nf, jnp.any(nf != f)

            return saturate

        self._run_with(weak)

    def test_full_local_operator(self):
        # Full two-phase local convergence per round (the production
        # default, spelled explicitly via converge_packed).
        from cudacam_tpu.ops.bitpack import converge_packed

        def full_local(cfg, mesh):
            geo = self._geo(cfg, mesh)

            def saturate(f, p):
                nf, _, growing = converge_packed(
                    f, p, geo.ext_h, geo.ext_w,
                    max_iters=cfg.max_hysteresis_iters,
                )
                return nf, growing

            return saturate

        self._run_with(full_local)

    def test_row_only_mesh(self):
        from cudacam_tpu.parallel.sharded import xla_packed_saturate

        self._run_with(
            lambda cfg, mesh: xla_packed_saturate(cfg, self._geo(cfg, mesh)),
            rows=8, cols=1,
        )


class TestPackedGeo:
    """make_geo invariants: slot clamping for small tiles, zero slots on
    single-shard axes."""

    def test_slots_clamped_to_tile(self):
        from cudacam_tpu.parallel.packed_halo import make_geo

        g = make_geo(8, 12)
        assert g.e_top == 8 and g.e_left == 12  # a shard exports what it owns

    def test_single_shard_axes_have_no_slots(self):
        from cudacam_tpu.parallel.packed_halo import make_geo

        g = make_geo(1080, 1920, ny=1, nx=1)
        assert (g.e_top, g.e_bot, g.e_left, g.e_right) == (0, 0, 0, 0)
        assert (g.ext_h, g.ext_w) == (1080, 1920)  # degenerate = raw tile
        g2 = make_geo(540, 1920, ny=2, nx=1)
        assert g2.e_top > 0 and g2.e_left == 0  # row-only mesh


class TestPackedHaloUnits:
    """Unit coverage of the bit-strip juggling in packed_halo: extraction
    and OR-placement at arbitrary (misaligned, negative, capped) bit
    offsets — the part of the sharded rewrite that is easiest to get
    subtly wrong."""

    def _plane(self, rows, lanes, bits):
        x = np.zeros((rows, lanes), np.uint32)
        for r, c in bits:
            x[r // 32, c] |= np.uint32(1) << np.uint32(r % 32)
        return jnp.asarray(x)

    def test_extract32_offsets(self):
        from cudacam_tpu.parallel.packed_halo import _extract32

        x = self._plane(4, 8, [(0, 1), (33, 2), (37, 3), (95, 4)])
        xn = np.asarray(x)
        for b in (0, 1, 5, 32, 33, 63, -3, -31):
            got = np.asarray(_extract32(x, b))[0]
            for c in range(8):
                for j in range(32):
                    row = b + j
                    want = (
                        (int(xn[row // 32, c]) >> (row % 32)) & 1
                        if 0 <= row < 128
                        else 0
                    )
                    assert (int(got[c]) >> j) & 1 == want, (b, c, j)

    def test_or_place_roundtrip(self):
        from cudacam_tpu.parallel.packed_halo import _extract32, _or_place32

        rng = np.random.default_rng(7)
        strip = jnp.asarray(
            rng.integers(0, 2**32, size=(1, 8), dtype=np.uint64).astype(
                np.uint32
            )
        )
        for b in (0, 3, 32, 45, -5):
            x = jnp.zeros((4, 8), jnp.uint32)
            x2, new = _or_place32(x, strip, b, 128)
            assert bool(new)
            back = np.asarray(_extract32(x2, max(b, 0)))[0]
            shift = max(b, 0) - b
            want = np.asarray(strip)[0]
            if shift:
                want = want >> np.uint32(shift)
            lost = max(0, b + 32 - 128)  # bits past the plane cap drop
            if lost:
                want = want & np.uint32((1 << (32 - lost)) - 1)
            np.testing.assert_array_equal(back, want)
            # placing the same strip again brings nothing new
            _, new2 = _or_place32(x2, strip, b, 128)
            assert not bool(new2)

    def test_or_place_cap(self):
        from cudacam_tpu.parallel.packed_halo import _or_place32

        strip = jnp.full((1, 4), 0xFFFFFFFF, jnp.uint32)
        x, _ = _or_place32(jnp.zeros((4, 4), jnp.uint32), strip, 100, 110)
        got = np.asarray(x)
        # bits 100..109 set, nothing else; word 3 holds bits 96..127
        assert (got[:3] == 0).all()
        assert (got[3] == (((1 << 10) - 1) << 4)).all()

"""Bit-packed hysteresis (ops/bitpack.py): packing, propagation, cap
semantics — all vs the NumPy oracle's exact BFS fixed point."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from cudacam_tpu.ops import numpy_oracle as oracle
from cudacam_tpu.ops import xla_ops
from cudacam_tpu.ops.bitpack import (
    hysteresis_packed,
    pack_mask,
    unpack_mask,
    _shift_px,
    _shift_cols,
)


from cudacam_tpu.io.sources import make_spiral_thresh as make_spiral

# One shared jit object for the whole file: eager execution of the packed
# loop is hundreds of per-op dispatches on CPU, dominating suite time.
hysteresis_packed = jax.jit(
    hysteresis_packed,
    static_argnames=(
        "max_iters", "remove_candidates", "return_iters",
        "dilate_steps", "scan_after",
    ),
)


def _pack_ref(m: np.ndarray) -> np.ndarray:
    """Independent NumPy reference of the row-packed layout: bit j of word
    [k, c] = pixel [32k + j, c]."""
    h, w = m.shape
    hw = -(-h // 32)
    padded = np.zeros((hw * 32, w), bool)
    padded[:h] = m
    return (
        padded.reshape(hw, 32, w).astype(np.uint32)
        << np.arange(32, dtype=np.uint32)[None, :, None]
    ).sum(axis=1, dtype=np.uint32)


class TestPacking:
    @pytest.mark.parametrize("h", [1, 7, 32, 33, 100, 640])
    def test_roundtrip(self, h):
        rng = np.random.default_rng(h)
        m = rng.random((h, 13)) < 0.3
        rt = np.asarray(unpack_mask(pack_mask(jnp.asarray(m)), h))
        assert (rt == m).all()

    @pytest.mark.parametrize("h", [32, 96, 131])
    def test_word_values_lsb_first(self, h):
        """Pin the word-level layout (bit j of word [k, c] = image row
        32k+j of column c), not just roundtrip consistency: every shift
        primitive's sub-word direction depends on it."""
        rng = np.random.default_rng(h)
        m = rng.random((h, 5)) < 0.5
        got = np.asarray(pack_mask(jnp.asarray(m)))
        np.testing.assert_array_equal(got, _pack_ref(m))

    def test_chunked_path_matches_unchunked(self):
        """Mega-frame masks take the word-row-chunked pack/unpack path (the
        u32 expansion must stay on-chip, bitpack._PACK_ONCHIP_BYTES); its
        output must be bit-identical to the single-pass form, including at
        a height that does NOT divide the chunk grid (exercises the
        zero-pad + slice-back)."""
        from cudacam_tpu.ops import bitpack

        h, w = 601, 7680  # 19 word-rows x 983 KB -> chunked past the budget
        assert (-(-h // 32)) * 32 * w * 4 > bitpack._PACK_ONCHIP_BYTES
        rng = np.random.default_rng(0)
        m = rng.random((h, w)) < 0.4
        got = np.asarray(pack_mask(jnp.asarray(m)))
        np.testing.assert_array_equal(got, _pack_ref(m))
        rt = np.asarray(unpack_mask(jnp.asarray(got), h))
        assert (rt == m).all()

    def test_chunk_count_power_of_two(self):
        """Chunk word-row counts must be powers of two (measured distinctly
        faster on hardware than same-size non-powers) and shrink as
        word-rows get wider."""
        from cudacam_tpu.ops.bitpack import _chunk_count, _PACK_CHUNK_TARGET

        prev = None
        for row_bytes in (1024, 30720, 61440, 10**6, 10**8):
            rows = _chunk_count(row_bytes)
            assert rows >= 1 and (rows & (rows - 1)) == 0
            if rows > 1:  # above the floor, chunks stay near the target
                assert rows * row_bytes <= 2 * _PACK_CHUNK_TARGET
            if prev is not None:
                assert rows <= prev
            prev = rows

    @pytest.mark.parametrize("h,w", [(100, 13), (601, 7680)])
    def test_pack_pair_matches_pack_mask(self, h, w):
        """The fused one-read pair pack (small = single pass, large =
        chunked) must equal two independent pack_mask calls."""
        from cudacam_tpu.ops.bitpack import pack_pair
        from cudacam_tpu.stages import CANDIDATE_EDGE, FINAL_EDGE

        rng = np.random.default_rng(h)
        t = rng.choice(
            np.array([0, CANDIDATE_EDGE, FINAL_EDGE], np.uint8), size=(h, w)
        )
        f, p = pack_pair(jnp.asarray(t))
        np.testing.assert_array_equal(
            np.asarray(f), np.asarray(pack_mask(jnp.asarray(t == FINAL_EDGE)))
        )
        np.testing.assert_array_equal(
            np.asarray(p),
            np.asarray(pack_mask(jnp.asarray(t == CANDIDATE_EDGE))),
        )

    @pytest.mark.parametrize("s", [1, 2, 5, 31, 32, 33, 64, 100])
    @pytest.mark.parametrize("sign", [1, -1])
    def test_shift_px(self, s, sign):
        """_shift_px moves the packed bit stream along the image ROW axis."""
        rng = np.random.default_rng(s)
        m = rng.random((200, 5)) < 0.4
        shifted = np.asarray(
            unpack_mask(_shift_px(pack_mask(jnp.asarray(m)), sign * s), 200)
        )
        want = np.zeros_like(m)
        if sign > 0:
            want[s:] = m[:-s]
        else:
            want[:-s] = m[s:]
        # Bits beyond height live in the pad word; unpack re-slices them off.
        assert (shifted == want).all()

    @pytest.mark.parametrize("s", [1, 3, -1, -4])
    def test_shift_cols(self, s):
        rng = np.random.default_rng(abs(s))
        m = rng.random((64, 11)) < 0.4
        shifted = np.asarray(
            unpack_mask(_shift_cols(pack_mask(jnp.asarray(m)), s), 64)
        )
        want = np.zeros_like(m)
        if s > 0:
            want[:, s:] = m[:, :-s]
        else:
            want[:, :s] = m[:, -s:]
        assert (shifted == want).all()


class TestHysteresisPacked:
    @pytest.mark.parametrize("trial", range(10))
    def test_random_vs_oracle(self, trial):
        rng = np.random.default_rng(trial)
        h, w = rng.integers(4, 70, 2)
        t = rng.choice(
            [0, 128, 255], size=(h, w), p=[0.55, 0.35, 0.10]
        ).astype(np.uint8)
        want = oracle.hysteresis(t)
        got = np.asarray(hysteresis_packed(jnp.asarray(t)))
        np.testing.assert_array_equal(want, got)

    def test_snake(self):
        h, w = 64, 96
        t = np.zeros((h, w), np.uint8)
        for r in range(0, h, 4):
            t[r, 1 : w - 1] = 128
            if (r // 4) % 2 == 0 and r + 4 < h:
                t[r : r + 5, w - 2] = 128
            elif r + 4 < h:
                t[r : r + 5, 1] = 128
        t[0, 1] = 255
        want = oracle.hysteresis(t)
        got = np.asarray(hysteresis_packed(jnp.asarray(t)))
        np.testing.assert_array_equal(want, got)
        assert (want == 255).sum() > 500

    def test_diagonal_staircase(self):
        t = np.zeros((40, 40), np.uint8)
        for i in range(39):
            t[i, i] = 128
        t[0, 0] = 255
        got = np.asarray(hysteresis_packed(jnp.asarray(t)))
        np.testing.assert_array_equal(got, oracle.hysteresis(t))
        assert (got == 255).sum() == 39

    def test_long_straight_runs_escalate_to_scans(self):
        # A run far longer than scan_after*dilate_steps pixels must still
        # converge exactly (phase 2's carry-lookahead scans).
        t = np.zeros((8, 4096), np.uint8)
        t[4, 1:4090] = 128
        t[4, 1] = 255
        got, iters = hysteresis_packed(
            jnp.asarray(t), dilate_steps=4, scan_after=2, return_iters=True
        )
        np.testing.assert_array_equal(np.asarray(got), oracle.hysteresis(t))
        assert int(iters) < 8  # not ~1000 dilate rounds

    def test_spiral_converges_exactly(self):
        t = make_spiral(41, 57)
        want = oracle.hysteresis(t)
        got = np.asarray(hysteresis_packed(jnp.asarray(t), max_iters=200))
        np.testing.assert_array_equal(want, got)
        assert (want == 255).sum() > 500

    def test_cap_semantics(self):
        """At the cap, the output is a monotone under-approximation of the
        fixed point, and — because every executor calls this one function
        with config-driven arguments — identical across executors by
        construction (docs/parity.md)."""
        t = make_spiral(41, 57)
        full = np.asarray(hysteresis_packed(jnp.asarray(t), max_iters=500))
        capped = np.asarray(
            hysteresis_packed(
                jnp.asarray(t), max_iters=3, remove_candidates=False
            )
        )
        # Capped finals are a subset of converged finals, superset of seeds.
        assert ((capped == 255) & ~(full == 255)).sum() == 0
        assert capped[0, 0] == 255
        # Truncation really happened (the spiral needs > 3 rounds).
        assert (capped == 255).sum() < (full == 255).sum()
        # The engine-facing wrapper is literally the same computation.
        via_xla_ops = np.asarray(
            xla_ops.hysteresis(
                jnp.asarray(t), max_iters=3, remove_candidates=False
            )
        )
        np.testing.assert_array_equal(
            via_xla_ops,
            np.asarray(
                hysteresis_packed(
                    jnp.asarray(t), max_iters=3, remove_candidates=False
                )
            ),
        )

    def test_word_boundary_runs_with_carry_cadence(self):
        """The carry-free (exact=False) intermediate dilations drop the
        cross-word VERTICAL carry; a front sitting exactly at a 32-row word
        boundary must still converge to the oracle fixed point because every
        carry_every-th and last step is exact. Seeds at rows 31/32 and
        63/64 with long vertical candidate runs are the adversarial case."""
        t = np.zeros((160, 9), np.uint8)
        t[1:150, 1] = 128; t[31, 1] = 255   # seed at the last bit of word 0
        t[1:150, 3] = 128; t[32, 3] = 255   # seed at the first bit of word 1
        t[1:150, 5] = 128; t[63, 5] = 255
        t[1:150, 7] = 128; t[64, 7] = 255
        want = oracle.hysteresis(t)
        for ds in (4, 16):
            got = np.asarray(
                hysteresis_packed(jnp.asarray(t), dilate_steps=ds)
            )
            np.testing.assert_array_equal(want, got)

    def test_carry_cadence_converges_identical_to_all_exact(self):
        """A mixed exact/inexact schedule (carry_every=4 default) must reach
        the bit-identical fixed point as an all-exact schedule: both are
        monotone and dominated by the fixed point, and every round ends
        exact so the no-growth exit implies true convergence."""
        from cudacam_tpu.ops.bitpack import _make_ops, pack_pair, unpack_mask

        rng = np.random.default_rng(21)
        t = rng.choice(
            [0, 128, 255], size=(200, 48), p=[0.45, 0.45, 0.10]
        ).astype(np.uint8)
        t[1:199, 10] = 128
        t[33, 10] = 255  # long run + word-boundary seed in the same frame

        def converge(carry_every):
            f, p = pack_pair(jnp.asarray(t))
            dilates, _ = _make_ops(200, 48, 16, carry_every=carry_every)
            prev = None
            for _ in range(40):
                f = dilates(f, p)
                cur = np.asarray(unpack_mask(f, 200))
                if prev is not None and (cur == prev).all():
                    break
                prev = cur
            return cur

        all_exact = converge(carry_every=1)
        mixed = converge(carry_every=4)
        np.testing.assert_array_equal(all_exact, mixed)
        np.testing.assert_array_equal(
            all_exact, oracle.hysteresis(t) == 255
        )

    def test_remove_candidates_false(self):
        rng = np.random.default_rng(7)
        t = rng.choice(
            [0, 128, 255], size=(33, 51), p=[0.5, 0.4, 0.1]
        ).astype(np.uint8)
        want = oracle.hysteresis(t, remove_candidates=False)
        got = np.asarray(
            hysteresis_packed(jnp.asarray(t), remove_candidates=False)
        )
        np.testing.assert_array_equal(want, got)

    def test_vmap(self):
        rng = np.random.default_rng(3)
        b = np.stack(
            [
                rng.choice(
                    [0, 128, 255], size=(32, 64), p=[0.5, 0.4, 0.1]
                ).astype(np.uint8)
                for _ in range(4)
            ]
        )
        got = np.asarray(
            jax.vmap(lambda x: hysteresis_packed(x))(jnp.asarray(b))
        )
        for i in range(4):
            np.testing.assert_array_equal(got[i], oracle.hysteresis(b[i]))

    def test_legacy_dilate_loop_agrees(self):
        """The pre-bitpack dilate-loop implementation is kept as an
        independently derived differential check."""
        rng = np.random.default_rng(11)
        t = rng.choice(
            [0, 128, 255], size=(48, 80), p=[0.5, 0.4, 0.1]
        ).astype(np.uint8)
        a = np.asarray(hysteresis_packed(jnp.asarray(t)))
        b = np.asarray(xla_ops.hysteresis_dilate_loop(jnp.asarray(t)))
        np.testing.assert_array_equal(a, b)

"""Bit-packed hysteresis: 32 pixels per lane, log-step run propagation.

The reference's hysteresis promotes candidates (128) 8-adjacent to a FINAL
edge (255) until a global fixed point, via per-block shared-memory iteration
plus a host relaunch loop (cannyEdgeD.cu:295-377; cannyEdgeH.cu:297-338).
Any dilate-by-one formulation pays one full-frame pass per pixel step of
propagation, and real edge chains are hundreds of pixels long.

This module is the framework's hysteresis:

* **Bit packing.** The FINAL and CANDIDATE masks are packed 32 pixels per
  uint32 lane, VERTICALLY: word [k, c] holds rows 32k..32k+31 of image
  column c ((ceil(H/32), W) words). Every vector op then processes 32x the
  pixels, and a full 1080p state is ~260 KB. Packing along ROWS keeps the
  image-column axis minor, so pack/unpack are reshapes along the major
  axis with no cross-lane gathers.
* **Carry-lookahead run propagation.** Promotion along a scan direction is
  exactly the carry recurrence of an adder: carry_i = g_i | (p_i & carry_-),
  with g = FINAL and p = CANDIDATE. Each of the 8 directions is resolved by
  a Hillis-Steele doubling scan over (g, p) transfer pairs — log2(extent)
  shifted OR/AND steps promote an entire candidate run in ONE scan, instead
  of one pixel per dilation. A "round" chains all 8 directional scans, so
  each round extends edges through every monotone segment of a chain;
  convergence needs one round per direction *change* in the longest chain
  (plus one to observe no growth), not one pass per pixel.

Promotion is monotone toward the unique global fixed point (the same one
the oracle's BFS computes, numpy_oracle.hysteresis), so scan order affects
only speed, never the result. ``max_iters`` caps rounds (the analog of the
reference's 100-relaunch safety belt, cannyEdgeH.cu:313); every executor
(single frame, vmapped batch, sharded round loop) runs this same round
schedule, and numpy_oracle.hysteresis_capped writes it out on unpacked
planes, so capped outputs are checked bit-for-bit (docs/parity.md).

Everything here is plain jax.numpy on integer types: it runs unchanged on
CPU (tests), under vmap (batched cameras), and inside shard_map (the
sharded engine's local step).
"""
from __future__ import annotations

from typing import Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from cudacam_tpu.stages import CANDIDATE_EDGE, FINAL_EDGE, NO_EDGE

# NOTE: only numpy scalars appear in this module (never jnp.uint32(1) at
# module level): a module-level jax scalar is a concrete device array that
# gets embedded in every trace as a closure constant, and jax 0.9 hoists it
# into an executable *parameter* inconsistently across otherwise-identical
# traces (the "supplied 3 buffers but compiled program expected 4" dispatch
# failures). A numpy scalar always inlines as a literal.


def _bit_iota() -> jnp.ndarray:
    """(1, 32, 1) uint32 bit indices (one per packed row within a word), as
    a traced iota rather than an embedded jnp.arange constant (closure
    constants can be hoisted into executable parameters, which breaks
    executable sharing across traces)."""
    return jax.lax.broadcasted_iota(jnp.uint32, (1, 32, 1), 1)


#: Cap on the uint32 scratch a single pack/unpack pass may expand to
#: (bytes) before the pass runs word-row-chunked, so the 32x expansion of
#: a mega-frame is never materialized whole (the 1080p frame, 8.3 MB,
#: runs unchunked).
_PACK_ONCHIP_BYTES = 16_500_000

#: Target uint32-expansion size per chunk once a pass IS chunked.
_PACK_CHUNK_TARGET = 8_000_000


def _chunk_count(row_bytes: int) -> int:
    """Word-rows per chunk: the largest power of two whose expansion fits
    the chunk target."""
    rows = max(1, _PACK_CHUNK_TARGET // row_bytes)
    return 1 << (rows.bit_length() - 1)


def _chunk_words(fn, x: jnp.ndarray, hw: int, word_row_bytes: int):
    """Apply ``fn`` over chunks of word-rows (each word-row = 32 image rows
    of ``x``, or 1 packed row, depending on direction) sized so each
    chunk's uint32 expansion stays bounded; single call when the whole
    array fits. ``x`` must already be padded to the word grid on axis 0
    (``hw`` word-rows of ``x.shape[0] // hw`` rows each)."""
    if hw * word_row_bytes <= _PACK_ONCHIP_BYTES:
        return fn(x)
    rows_per_word = x.shape[0] // hw
    wpc = _chunk_count(word_row_bytes)
    nb = -(-hw // wpc)
    xp = jnp.pad(x, ((0, (nb * wpc - hw) * rows_per_word), (0, 0)))
    out = jax.lax.map(fn, xp.reshape(nb, wpc * rows_per_word, x.shape[1]))
    return out.reshape(-1, x.shape[1])


def pack_mask(mask: jnp.ndarray) -> jnp.ndarray:
    """Pack a (H, W) boolean mask into (ceil(H/32), W) uint32 words,
    LSB-first along rows (bit j of word [k, c] = pixel [k*32 + j, c]).

    The (kw, 32, W) shift-and-reduce runs along the major axis — the image
    column axis stays minor throughout. On mega-frames the pass runs
    word-row-chunked so its uint32 expansion stays bounded (see
    _PACK_ONCHIP_BYTES)."""
    h, w = mask.shape
    hw = -(-h // 32)
    m = jnp.pad(mask, ((0, hw * 32 - h), (0, 0)))

    def pack_rows(rows_bool):
        kw = rows_bool.shape[0] // 32
        expanded = rows_bool.reshape(kw, 32, w).astype(jnp.uint32)
        return jnp.sum(expanded << _bit_iota(), axis=1, dtype=jnp.uint32)

    return _chunk_words(pack_rows, m, hw, 32 * w * 4)[:hw]


def unpack_mask(words: jnp.ndarray, height: int) -> jnp.ndarray:
    """Inverse of pack_mask: (Hw, W) uint32 -> (height, W) bool."""
    hw, w = words.shape

    def unpack_rows(rows_u32):
        bits = (rows_u32[:, None, :] >> _bit_iota()) & np.uint32(1)
        # -> bool INSIDE the chunk: a full-frame uint32 bit plane is the
        # exact expansion the chunking exists to avoid.
        return bits.astype(jnp.bool_).reshape(rows_u32.shape[0] * 32, w)

    return _chunk_words(unpack_rows, words, hw, 32 * w * 4)[:height]


def pack_pair(thresh: jnp.ndarray) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Pack the FINAL and CANDIDATE masks of a (H, W) uint8 threshold map,
    returning both (Hw, W) planes in the compute layout (row-packed: no
    transpose exists anymore — the packed minor axis IS the image minor
    axis).

    Two regimes, picked by whether ONE mask's uint32 expansion fits the
    budget:

    * small frames (<= ~1080p): two separate pack_mask passes that XLA
      fuses into the engine program.
    * mega frames: ONE fused chunked pass reading ``thresh`` once for both
      masks, budgeting 2x per word-row since both expansions are live at
      once."""
    h, w = thresh.shape
    hw = -(-h // 32)
    if hw * 32 * w * 4 <= _PACK_ONCHIP_BYTES:
        return (
            pack_mask(thresh == np.uint8(FINAL_EDGE)),
            pack_mask(thresh == np.uint8(CANDIDATE_EDGE)),
        )

    def pair_rows(t_rows):
        kw = t_rows.shape[0] // 32
        tr = t_rows.reshape(kw, 32, w)
        io = _bit_iota()
        f = jnp.sum(
            (tr == np.uint8(FINAL_EDGE)).astype(jnp.uint32) << io,
            axis=1, dtype=jnp.uint32,
        )
        p = jnp.sum(
            (tr == np.uint8(CANDIDATE_EDGE)).astype(jnp.uint32) << io,
            axis=1, dtype=jnp.uint32,
        )
        # Concatenate on the word axis so _chunk_words sees one array out.
        return jnp.concatenate([f, p], axis=0)

    tp = jnp.pad(thresh, ((0, hw * 32 - h), (0, 0)))
    # Both mask expansions are live at once in this pass: budget 2x per
    # word-row (always chunked here — the single-expansion early return
    # above already took every frame small enough to run unchunked).
    wpc = _chunk_count(2 * 32 * w * 4)
    nb = -(-hw // wpc)
    tp = jnp.pad(tp, ((0, (nb * wpc - hw) * 32), (0, 0)))
    fp = jax.lax.map(pair_rows, tp.reshape(nb, wpc * 32, w))
    fp = fp.reshape(nb, 2, wpc, w).transpose(1, 0, 2, 3).reshape(2, -1, w)
    return fp[0, :hw], fp[1, :hw]


# Compute layout: (Hw, W) words-by-image-columns — image columns on the
# minor axis, packed word rows on the major axis. Horizontal neighbors are
# minor-axis shifts; vertical propagation is in-word bit shifts plus a
# major-axis word shift for the cross-word carry.


def _shift_words(x: jnp.ndarray, k: int) -> jnp.ndarray:
    """out[i, :] = x[i-k, :], zero fill (whole-word = 32-image-row shifts;
    words are the MAJOR axis of the compute layout)."""
    if k == 0:
        return x
    hw = x.shape[0]
    if k > 0:
        return jnp.pad(x, ((k, 0), (0, 0)))[:hw]
    return jnp.pad(x, ((0, -k), (0, 0)))[-k:]


def _shift_cols(x: jnp.ndarray, k: int) -> jnp.ndarray:
    """out[:, c] = x[:, c-k], zero fill (image columns: the MINOR axis of
    the compute layout)."""
    if k == 0:
        return x
    w = x.shape[1]
    if k > 0:
        return jnp.pad(x, ((0, 0), (k, 0)))[:, :w]
    return jnp.pad(x, ((0, 0), (0, -k)))[:, -k:]


def _shift_px(x: jnp.ndarray, s: int) -> jnp.ndarray:
    """Shift the packed bit stream by ``s`` pixels along the packed (image
    ROW) axis: out[row r] = x[row r - s] (zero fill at the borders)."""
    if s == 0:
        return x
    q, r = divmod(abs(s), 32)
    if s > 0:
        base = _shift_words(x, q)
        if r == 0:
            return base
        return (base << np.uint32(r)) | (
            _shift_words(base, 1) >> np.uint32(32 - r)
        )
    base = _shift_words(x, -q)
    if r == 0:
        return base
    return (base >> np.uint32(r)) | (
        _shift_words(base, -1) << np.uint32(32 - r)
    )


def _doubling_steps(extent: int) -> Tuple[int, ...]:
    """Powers of two < extent (a scan with these steps covers any run)."""
    steps = []
    s = 1
    while s < extent:
        steps.append(s)
        s *= 2
    return tuple(steps)


def _scan_dir(f, p, shift, steps: Sequence[int]):
    """Resolve promotion along one direction: inclusive doubling scan of
    (generate, propagate) transfer pairs. ``shift(x, s)`` must fetch the
    value ``s`` cells *upstream* (where the carry comes from); zero fill is
    the correct boundary (no edges enter from outside the frame)."""
    g, pp = f, p
    for s in steps:
        gs = shift(g, s)
        ps = shift(pp, s)
        g = g | (pp & gs)
        pp = pp & ps
    return g


def _dilate8(
    f: jnp.ndarray,
    p: jnp.ndarray,
    exact: bool,
    shift_cols,
    shift_px_1,
    shift_px_1_inexact,
):
    """One promotion step: f | (p & 8-neighborhood-OR(f)), bit-parallel.
    Horizontal neighbors first (2 column shifts), then vertical over the
    horizontal OR (the 2-pass factorization): in-word bit shifts, plus the
    cross-word carry on ``exact`` steps.

    The inexact vertical OR drops the cross-word carry: plain
    ``v<<1 | v>>1`` propagates only WITHIN each 32-row word. That
    under-approximates one step — a front sitting at a word boundary
    (image rows 31/32, 63/64, ...) stalls until the next exact step — but
    promotion stays monotone and below the fixed point, so it is always
    safe as an *intermediate* step. Every round's LAST step must be exact:
    then "round produced no growth" still implies the true dilation fixed
    point and the convergence loop exits at exactly the oracle's answer."""
    v = f | shift_cols(f, 1) | shift_cols(f, -1)
    if exact:
        h = v | shift_px_1(v, 1) | shift_px_1(v, -1)
    else:
        h = v | shift_px_1_inexact(v, 1) | shift_px_1_inexact(v, -1)
    return f | (p & h)


def _dilate8_packed(
    f: jnp.ndarray, p: jnp.ndarray, exact: bool = True
) -> jnp.ndarray:
    """XLA-shift instantiation of _dilate8 (kept for tests/tools)."""
    return _dilate8(
        f, p, exact, _shift_cols, _shift_px, _shift_px_inexact
    )


def _shift_px_inexact(x: jnp.ndarray, s: int) -> jnp.ndarray:
    """1-pixel vertical shift WITHOUT the cross-word carry (the cheap
    intermediate-step operator; see _dilate8)."""
    return x << np.uint32(1) if s > 0 else x >> np.uint32(1)


#: Exact (cross-word-carry) dilation cadence inside a fused round: every
#: ``_CARRY_EVERY``-th step and the round's last step run exact, the rest
#: carry-free (cheap). Part of the round schedule, so cap-truncated outputs
#: depend on it (numpy_oracle.hysteresis_capped takes the same value).
_CARRY_EVERY = 8


def _make_ops(h: int, w: int, dilate_steps: int,
              carry_every: int = _CARRY_EVERY, shifts=None):
    """Build the two promotion operators: ``dilates`` = dilate_steps fused
    bit-parallel dilations (with the ``carry_every`` exactness cadence);
    ``scans`` = the 8-direction doubling scans.

    ``shifts`` injects the three shift primitives as
    ``(shift_cols, shift_px, shift_px_inexact)`` — None means the XLA
    pad/slice implementations. Any other implementation must keep the
    same round schedule, step cadence and direction order: that shared
    schedule is what keeps outputs bit-identical even when ``max_iters``
    truncates before the fixed point.

    Both operators are monotone and dominated by the fixed point, so the
    converged result is identical whatever mix runs — the mix only trades
    per-round cost against rounds needed."""
    shift_cols, shift_px, shift_px_ix = shifts or (
        _shift_cols, _shift_px, _shift_px_inexact
    )
    hsteps = _doubling_steps(w)
    vsteps = _doubling_steps(h)
    dsteps = _doubling_steps(min(h, w))
    directions = (
        (lambda x, s: shift_cols(x, s), hsteps),        # left -> right
        (lambda x, s: shift_cols(x, -s), hsteps),       # right -> left
        (lambda x, s: shift_px(x, s), vsteps),          # top -> bottom
        (lambda x, s: shift_px(x, -s), vsteps),         # bottom -> top
        (lambda x, s: shift_cols(shift_px(x, s), s), dsteps),    # down-right
        (lambda x, s: shift_cols(shift_px(x, -s), -s), dsteps),  # up-left
        (lambda x, s: shift_cols(shift_px(x, s), -s), dsteps),   # down-left
        (lambda x, s: shift_cols(shift_px(x, -s), s), dsteps),   # up-right
    )

    def scans(f, p):
        for shift, steps in directions:
            f = _scan_dir(f, p, shift, steps)
        return f

    def dilates(f, p):
        for i in range(1, dilate_steps + 1):
            exact = (i % carry_every == 0) or (i == dilate_steps)
            f = _dilate8(f, p, exact, shift_cols, shift_px, shift_px_ix)
        return f

    return dilates, scans


def converge_packed(
    f: jnp.ndarray,
    p: jnp.ndarray,
    h: int,
    w: int,
    dilate_steps: int = 16,
    scan_after: int = 10,
    max_iters: int = 100,
    carry_every: int = _CARRY_EVERY,
    shifts=None,
):
    """Run BOTH convergence phases directly on pre-packed (FINAL,
    CANDIDATE) planes; returns ``(f_fix, iters, growing)`` where
    ``growing`` is True iff the loop exited at the ``max_iters`` cap while
    the state was still changing (the caller's signal that the fixed point
    was NOT reached — the sharded round loop keys on it,
    parallel/packed_halo.py).

    Two escalating phases (two sequential while_loops — no data-dependent
    branching inside a loop body):

    1. rounds of ``dilate_steps`` fused bit-parallel dilations — optimal for
       real scenes, whose chains are windy (each dilation is ~8 vector ops
       on 1/32nd the pixels);
    2. if still growing after ``scan_after`` such rounds (long straight
       runs), rounds escalate to dilations + the 8-direction carry-lookahead
       scans, which promote whole monotone runs at once.

    ``h``/``w`` are the schedule extents (the logical frame dims — they
    size the doubling-step sequences); the planes may be larger
    (guard-ringed layouts: extra all-zero rows/lanes shift through as
    exact zero fill). ``shifts`` injects backend shift primitives exactly
    as in :func:`_make_ops`. This IS the one round schedule every executor
    runs (CLAUDE.md invariant).
    """
    dilates, scans = _make_ops(
        h, w, dilate_steps, carry_every=carry_every, shifts=shifts
    )

    def count(f):
        return jnp.sum(jax.lax.population_count(f), dtype=jnp.int32)

    # Phase 1 first round unconditionally; loop while the FINAL count grows
    # (promotion is monotone, so count growth == change).
    f1 = dilates(f, p)

    def cond1(state):
        _, prev, cur, it = state
        return (cur > prev) & (it < min(scan_after, max_iters))

    def body1(state):
        f, _, cur, it = state
        nf = dilates(f, p)
        return nf, cur, count(nf), it + 1

    state = jax.lax.while_loop(
        cond1, body1, (f1, count(f), count(f1), jnp.int32(1))
    )

    def cond2(state):
        _, prev, cur, it = state
        return (cur > prev) & (it < max_iters)

    def body2(state):
        f, _, cur, it = state
        nf = scans(dilates(f, p), p)
        return nf, cur, count(nf), it + 1

    # Entered only if phase 1 hit its round cap while still growing.
    f_fix, prev, cur, iters = jax.lax.while_loop(cond2, body2, state)
    return f_fix, iters, cur > prev


def hysteresis_packed(
    thresh: jnp.ndarray,
    max_iters: int = 100,
    remove_candidates: bool = True,
    return_iters: bool = False,
    dilate_steps: int = 16,
    scan_after: int = 10,
):
    """Global hysteresis fixed point of a (H, W) uint8 threshold map:
    pack both masks, run :func:`converge_packed`'s two escalating phases,
    unpack.

    ``max_iters`` caps total rounds — the reference's 100-relaunch safety
    belt (cannyEdgeH.cu:313); one phase-1 round covers >= dilate_steps
    pixels of propagation, a phase-2 round additionally any monotone run.
    Like the reference (which always launches once before reading the
    flag), at least ONE round runs: max_iters=0 still propagates up to
    dilate_steps pixels.
    """
    h, w = thresh.shape
    f, p = pack_pair(thresh)
    f_fix, iters, _ = converge_packed(
        f, p, h, w,
        dilate_steps=dilate_steps, scan_after=scan_after,
        max_iters=max_iters,
    )

    reached = unpack_mask(f_fix, h)
    if remove_candidates:
        out = jnp.where(reached, jnp.uint8(FINAL_EDGE), jnp.uint8(NO_EDGE))
    else:
        out = jnp.where(reached, jnp.uint8(FINAL_EDGE), thresh)
    if return_iters:
        return out, iters
    return out

"""Packed-state halo exchange for sharded hysteresis.

Carrying the u8 tile as loop state would re-pack and re-unpack the full
tile every collective round and exchange *unpacked* u8 halos. This module
makes the BIT-PACKED planes of ops/bitpack.py the carried state instead:

* each shard holds (FINAL, CANDIDATE) planes packed over an EXTENDED tile
  grid (halo slots around the owned core, 32 px vertical / 64 px
  horizontal for production tiles) — pack happens ONCE per frame, unpack
  ONCE at convergence;
* a collective round exchanges packed strips — ONE uint32 word-row per
  vertical side (~1/8th the bytes of the u8 halos) and 64 u32 lanes per
  horizontal side — and ORs them into the neighbor slots. OR (not
  replace) is sound: every exchanged bit is a promotion below the global
  fixed point, and promotion is monotone;
* the local saturate operator runs directly on the packed planes
  (``bitpack.converge_packed``, which executes the ONE
  ``bitpack._make_ops`` round schedule);
* the loop terminates when a global psum sees neither local growth nor any
  new halo bits anywhere: cores are then locally saturated w.r.t. stable
  halos, which IS the global fixed point.

The reference analog remains the host relaunch loop + per-iteration
device->host flag readback (/root/reference/src/cvp/cannyEdgeH.cu:297-338,
310, 322); the psum convergence flag replaces the readback, and the strip
exchange replaces the halo reload each relaunch performed through global
memory.

Layout contract: planes are ``(plane_rows, plane_lanes)`` uint32; bit b of
word [k, c] is extended-tile pixel (32*k + b, c); rows past the extended
tile (the tail bits and one guard word-row) are permanent zeros.
The owned core sits at pixel rows [e_top, e_top + h_loc) and lanes
[e_left, e_left + w_loc); the surrounding slots hold neighbor state. Core
bit offsets are arbitrary (e_top is not a word multiple in general), so
strip placement shifts-and-ORs across the two straddled words — a handful
of ops on 1-2 word rows, all offsets static.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np


@dataclasses.dataclass(frozen=True)
class PackedGeo:
    """Extended-tile packed-plane geometry for one shard."""

    h_loc: int
    w_loc: int
    e_top: int
    e_bot: int
    e_left: int
    e_right: int
    plane_rows: int  # total u32 word rows (incl. tail + guard zeros)
    plane_lanes: int  # total lanes

    @property
    def ext_h(self) -> int:
        return self.e_top + self.h_loc + self.e_bot

    @property
    def ext_w(self) -> int:
        return self.e_left + self.w_loc + self.e_right

    @property
    def hw(self) -> int:
        """Word rows covering the extended tile."""
        return -(-self.ext_h // 32)


def make_geo(
    h_loc: int,
    w_loc: int,
    ny: int = 2,
    nx: int = 2,
) -> PackedGeo:
    """Geometry for a (h_loc, w_loc) owned tile on an (ny, nx) tile grid.

    Halo slots are 32 px vertical / 64 px horizontal (clamped to the tile:
    a shard can only export state it owns — smaller tiles just propagate
    fewer pixels per collective round). A mesh axis with a SINGLE shard
    has no neighbors and gets zero slots — on a 1x1x1 mesh the extended
    grid degenerates to the raw tile, so the sharded program carries no
    extension overhead at all there (and a row-only mesh carries none on
    the column axis)."""
    e_top = min(32, h_loc) if ny > 1 else 0
    e_left = min(64, w_loc) if nx > 1 else 0
    e_bot, e_right = e_top, e_left
    ext_h = e_top + h_loc + e_bot
    ext_w = e_left + w_loc + e_right
    plane_rows = -(-ext_h // 32) + 1  # +1 guard word-row
    plane_lanes = ext_w
    return PackedGeo(
        h_loc, w_loc, e_top, e_bot, e_left, e_right, plane_rows, plane_lanes
    )


# --- bit-strip extraction / placement (static offsets) ---------------------


def _extract32(x: jnp.ndarray, b: int) -> jnp.ndarray:
    """(1, lanes) u32 strip of extended rows [b, b+32) of plane ``x``.
    ``b`` may be negative (rows before the tile read as zero; needs
    b > -32) — strips always span one full word of rows. ``b`` must
    START inside the plane (b < 32 * rows; exchange offsets derive from
    core positions, which always do)."""
    if b < 0:
        if b <= -32:
            raise ValueError(f"strip offset {b} <= -32 (contract: b > -32)")
        return x[0:1] << np.uint32(-b)
    if b >= 32 * x.shape[0]:
        raise ValueError(
            f"strip offset {b} starts past the plane ({x.shape[0]} word rows)"
        )
    q, r = divmod(b, 32)
    row = x[q : q + 1]
    if r:
        nxt = (
            x[q + 1 : q + 2]
            if q + 1 < x.shape[0]
            else jnp.zeros_like(row)
        )
        row = (row >> np.uint32(r)) | (nxt << np.uint32(32 - r))
    return row


def _or_place32(
    x: jnp.ndarray, strip: jnp.ndarray, b: int, cap_bits: int
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """OR a 32-row strip into plane rows [b, b+32), dropping bits outside
    [0, cap_bits) (rows the extended tile does not cover — the tail and
    guard words stay all-zero). Returns
    (plane, any_new_bits)."""
    if b < 0:
        strip = strip >> np.uint32(-b)
        b = 0
    if b >= cap_bits:
        return x, jnp.bool_(False)
    q, r = divmod(b, 32)

    def word_mask(word_idx: int) -> np.uint32:
        """Mask of bits of word ``word_idx`` that lie inside [b, cap)."""
        lo = max(b, word_idx * 32) - word_idx * 32
        hi = min(cap_bits, b + 32, (word_idx + 1) * 32) - word_idx * 32
        if hi <= lo:
            return np.uint32(0)
        bits = np.uint32(0xFFFFFFFF) if hi - lo >= 32 else np.uint32(
            ((1 << (hi - lo)) - 1) << lo
        )
        return bits

    new = jnp.bool_(False)
    lo_part = (strip << np.uint32(r) if r else strip) & word_mask(q)
    new = new | jnp.any(lo_part & ~x[q : q + 1])
    x = x.at[q : q + 1].set(x[q : q + 1] | lo_part)
    if r and q + 1 < x.shape[0]:
        hi_part = (strip >> np.uint32(32 - r)) & word_mask(q + 1)
        new = new | jnp.any(hi_part & ~x[q + 1 : q + 2])
        x = x.at[q + 1 : q + 2].set(x[q + 1 : q + 2] | hi_part)
    return x, new


# --- collective exchange ---------------------------------------------------


def _perms(n: int) -> Tuple[Sequence, Sequence]:
    down = [(i, i + 1) for i in range(n - 1)]  # shard i -> i+1
    up = [(i + 1, i) for i in range(n - 1)]  # shard i+1 -> i
    return down, up


def exchange_packed(
    x: jnp.ndarray,
    geo: PackedGeo,
    row_axis: str,
    col_axis: str,
    ny: int,
    nx: int,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """One halo refresh of plane ``x``: OR each neighbor's boundary strips
    into this shard's halo slots. Returns (plane, any_new_bits).

    Vertical strips are one (1, lanes) word-row spanning ALL lanes (so
    they carry the sender's column halos); the column exchange then sends
    (rows, 64)-lane strips spanning ALL word rows including the
    just-placed vertical halos — the second exchange carries the corner
    state, same two-phase scheme as the u8 halo exchange the reference's
    tile reload implies (cannyEdgeD.cu:89-98). Strips always map by
    GLOBAL pixel coordinates, so a strip may include halo-region bits the
    sender itself received — those are valid promotions below the fixed
    point, and OR keeps everything monotone-safe."""
    permute = jax.lax.ppermute
    new = jnp.bool_(False)
    cap = geo.ext_h
    if ny > 1:
        down, up = _perms(ny)
        # My bottom core rows -> the lower neighbor's top halo slot.
        send_down = _extract32(x, geo.e_top + geo.h_loc - 32)
        # My top core rows -> the upper neighbor's bottom halo slot.
        send_up = _extract32(x, geo.e_top)
        recv_top = permute(send_down, row_axis, down)
        recv_bot = permute(send_up, row_axis, up)
        x, n1 = _or_place32(x, recv_top, geo.e_top - 32, cap)
        x, n2 = _or_place32(x, recv_bot, geo.e_top + geo.h_loc, cap)
        new = new | n1 | n2
    if nx > 1:
        down, up = _perms(nx)
        k = min(64, geo.e_left)  # strip lanes (== slot depth by make_geo)
        c_r = geo.e_left + geo.w_loc
        send_right = x[:, c_r - k : c_r]
        send_left = x[:, geo.e_left : geo.e_left + k]
        recv_left = permute(send_right, col_axis, down)
        recv_right = permute(send_left, col_axis, up)
        old_l = x[:, geo.e_left - k : geo.e_left]
        old_r = x[:, c_r : c_r + k]
        new = new | jnp.any(recv_left & ~old_l) | jnp.any(recv_right & ~old_r)
        x = x.at[:, geo.e_left - k : geo.e_left].set(old_l | recv_left)
        x = x.at[:, c_r : c_r + k].set(old_r | recv_right)
    return x, new


# --- the collective round loop ---------------------------------------------


def packed_hysteresis_loop(
    f: jnp.ndarray,
    p: jnp.ndarray,
    still_growing: jnp.ndarray,
    geo: PackedGeo,
    saturate: Callable[[jnp.ndarray, jnp.ndarray], Tuple[jnp.ndarray, jnp.ndarray]],
    axes: Tuple[str, str, str],
    ny: int,
    nx: int,
    max_rounds: int,
) -> jnp.ndarray:
    """Converge the sharded fixed point on packed planes.

    ``saturate(f, p) -> (f, growing)`` is the injectable local operator
    (``bitpack.converge_packed`` by default, running the shared
    ``_make_ops`` schedule). ``still_growing`` is the entry state's flag
    (True when the producer stopped before the LOCAL fixed point). The
    candidate plane
    is static across rounds — it is exchanged ONCE up front to deepen the
    halo candidates; only FINAL strips move per round.

    Loop invariant: on entry to ``cond``, every shard's core is locally
    saturated unless ``growing``; exit requires a global psum to see
    neither local growth nor any new halo bit — every core is then at its
    local fixed point w.r.t. stable halos, i.e. the global fixed point
    (the psum replaces the reference's per-iteration device->host flag
    readback, cannyEdgeH.cu:310,322)."""
    b_axis, row_axis, col_axis = axes
    p, _ = exchange_packed(p, geo, row_axis, col_axis, ny, nx)
    f, new = exchange_packed(f, geo, row_axis, col_axis, ny, nx)

    def glob(flag) -> jnp.ndarray:
        return (
            jax.lax.psum(flag.astype(jnp.int32), (b_axis, row_axis, col_axis))
            > 0
        )

    def cond(state):
        _, pending, it = state
        return pending & (it < max_rounds)

    def body(state):
        f, _, it = state
        f, growing = saturate(f, p)
        f, new = exchange_packed(f, geo, row_axis, col_axis, ny, nx)
        return f, glob(growing | new), it + 1

    f, _, _ = jax.lax.while_loop(
        cond, body, (f, glob(still_growing | new), jnp.int32(0))
    )
    return f

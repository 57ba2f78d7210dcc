"""Production-scale cap-truncation golden.

The 1080p adversarial spiral (a single ~1M-px candidate chain,
io/sources.make_spiral_thresh) does NOT converge within the default
100-round cap — it is the one production-scale input where the cap
truncation semantics actually bite. This digest pins the truncated
output bit-for-bit:

a schedule regression — step cadence, direction order, round counting,
anything in bitpack._make_ops — flips the digest. chip_smoke.py checks the
same cap semantics on the GPU against numpy_oracle.hysteresis_capped.

If a DELIBERATE schedule change lands (it must land in bitpack._make_ops
and numpy_oracle.hysteresis_capped together — CLAUDE.md invariant),
regenerate with:
    python -c "import tests.test_cap_golden as g; g.regenerate()"
"""
import hashlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cudacam_tpu.io.sources import make_spiral_thresh
from cudacam_tpu.ops.bitpack import hysteresis_packed

#: sha256 of the (1080, 1920) uint8 output at max_iters=100 (the default
#: cap), dilate_steps=16, scan_after=12 (the 1080p engine defaults).
SPIRAL_1080P_CAP100_SHA = (
    "61ca860520f82b7a43be20833dcc5858dd7e6d25770f37aa4d9ed3e991848417"
)
SPIRAL_1080P_CAP100_FINALS = 248514

#: Same input at max_iters=400 (still truncated short of the fixed
#: point's full chain, but past another 300 rounds of schedule): a second
#: pin so a regression that happens to cancel at round 100 is still seen.
SPIRAL_1080P_CAP400_SHA = (
    "a822292e4a2125148907b11f7ca4ed75552e46db4bfa02d196364616b2bfa20d"
)


def _run(max_iters):
    t = make_spiral_thresh(1080, 1920)
    fn = jax.jit(
        hysteresis_packed,
        static_argnames=(
            "max_iters", "dilate_steps", "scan_after", "return_iters",
        ),
    )
    out, iters = fn(
        jnp.asarray(t), max_iters=max_iters, dilate_steps=16,
        scan_after=12, return_iters=True,
    )
    return np.asarray(out), int(iters)


@pytest.mark.slow
def test_spiral_1080p_cap100_golden():
    out, iters = _run(100)
    assert iters == 100  # the cap really truncated (not converged early)
    assert int((out == 255).sum()) == SPIRAL_1080P_CAP100_FINALS
    assert hashlib.sha256(out.tobytes()).hexdigest() == SPIRAL_1080P_CAP100_SHA


def regenerate():  # pragma: no cover - maintenance helper
    for cap in (100, 400):
        out, iters = _run(cap)
        print(
            f"cap={cap}: iters={iters} finals={(out == 255).sum()} "
            f"sha256={hashlib.sha256(out.tobytes()).hexdigest()}"
        )

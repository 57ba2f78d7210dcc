"""Configuration for the Canny pipeline.

The reference keeps its configuration in three tiers — compile-time CMake
options, compile-time constants (thresholds 10/40 at cannyEdgeH.cu:22-23,
Gaussian taps at cannyEdgeH.cu:372-380, grad coefficient at cannyEdgeD.cu:28),
and runtime UI state (imguiApp.cpp:303-349). This module promotes all of them
into one frozen dataclass, plus the extensions mandated by BASELINE.json:
variable kernel size (3/5/7), L1/L2 gradient norm, and sharding/mesh shape.

Static vs runtime split: fields that change compiled code (shapes, kernel
size, norm, parity, final stage) are static; thresholds are *runtime*
arguments to the jitted pipeline so slider changes never recompile
(the reference pays a kernel re-launch, we pay nothing).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

# Integer Gaussian taps. The 5x5 set is the canonical Canny-paper kernel used
# by the reference (cannyEdgeH.cu:372-380, sum 159). 3x3 / 7x7 are standard
# binomial kernels (powers of two, so the normalisation is a shift) added per
# BASELINE.json config 3.
GAUSSIAN_TAPS: dict[int, Tuple[Tuple[int, ...], ...]] = {
    3: (
        (1, 2, 1),
        (2, 4, 2),
        (1, 2, 1),
    ),  # sum 16
    5: (
        (2, 4, 5, 4, 2),
        (4, 9, 12, 9, 4),
        (5, 12, 15, 12, 5),
        (4, 9, 12, 9, 4),
        (2, 4, 5, 4, 2),
    ),  # sum 159
    7: (
        (1, 6, 15, 20, 15, 6, 1),
        (6, 36, 90, 120, 90, 36, 6),
        (15, 90, 225, 300, 225, 90, 15),
        (20, 120, 300, 400, 300, 120, 20),
        (15, 90, 225, 300, 225, 90, 15),
        (6, 36, 90, 120, 90, 36, 6),
        (1, 6, 15, 20, 15, 6, 1),
    ),  # sum 4096
}


def gaussian_kernel_sum(kernel_size: int) -> int:
    return sum(sum(row) for row in GAUSSIAN_TAPS[kernel_size])


@dataclasses.dataclass(frozen=True)
class CannyConfig:
    """Full pipeline configuration.

    Image specs are locked at engine construction, mirroring the reference's
    spec-locked init (cannyEdgeH.cu:124-130 rejects frames whose dimensions
    differ from the constructor's).
    """

    height: int
    width: int
    channels: int = 3  # 3 = BGR (OpenCV byte order, cannyEdgeD.cu:67), 1 = mono

    # --- algorithm parameters -------------------------------------------
    kernel_size: int = 5  # Gaussian kernel: 3, 5 or 7
    norm: str = "l2"  # 'l2' (reference, cannyEdgeD.cu:195) or 'l1' extension
    grad_coeff: int = 4  # GRAD_COEFF (cannyEdgeD.cu:28)
    low_threshold: int = 10  # default (cannyEdgeH.cu:22); runtime-adjustable
    high_threshold: int = 40  # default (cannyEdgeH.cu:23); runtime-adjustable

    # --- hysteresis ------------------------------------------------------
    # Global round cap: "safety belt", reference caps host relaunches at
    # 100 (cannyEdgeH.cu:313). Ours caps bit-packed promotion rounds
    # (ops/bitpack.py); every executor runs the same round schedule, so
    # outputs stay bit-identical even when the cap truncates.
    max_hysteresis_iters: int = 100
    # Bit-parallel dilations fused per round/convergence check. Default
    # (None): 16 everywhere except 32 in the 4K band. Together with
    # hysteresis_scan_after it fixes the round schedule, so cap-truncated
    # outputs depend on both; the defaults are kept as they are for that
    # reason. They were tuned on earlier hardware and have not been
    # re-tuned on the H100. The knob is exposed for depth-atypical content.
    hysteresis_inner_steps: Optional[int] = None
    # Rounds of pure dilation before escalating to the 8-direction
    # carry-lookahead scans (long straight candidate runs). Default
    # (None): 64 at <=1080p, 32 on mega-frames — about twice the deepest
    # phase-1 convergence seen on the synthetic scenes (31 rounds at
    # 1080p with kernel size 3, 15 at 4K). Real scenes then converge in
    # phase 1, and at the 100-round cap a later escalation truncates the
    # costlier scan rounds rather than the dilations. The escalation valve
    # itself stays (scan_after < max_iters) for inputs with genuinely long
    # monotone runs.
    hysteresis_scan_after: Optional[int] = None

    # --- execution -------------------------------------------------------
    parity: str = "reference"  # 'reference' | 'opencv'

    def __post_init__(self) -> None:
        if self.kernel_size not in GAUSSIAN_TAPS:
            raise ValueError(f"kernel_size must be one of {sorted(GAUSSIAN_TAPS)}")
        if self.norm not in ("l1", "l2"):
            raise ValueError("norm must be 'l1' or 'l2'")
        if self.channels not in (1, 3):
            raise ValueError("channels must be 1 (mono) or 3 (BGR)")
        if self.parity not in ("reference", "opencv"):
            raise ValueError("parity must be 'reference' or 'opencv'")
        if self.grad_coeff not in (1, 2, 4, 8):
            # The exact-integer display magnitude (isqrt(m)*coeff)//8 equals
            # the reference's trunc(coeff*sqrt(m)/8) only when coeff divides
            # 8 (cannyEdgeD.cu:28,195 uses 4).
            raise ValueError("grad_coeff must be 1, 2, 4 or 8")
        if self.height <= 0 or self.width <= 0:
            raise ValueError("height/width must be positive")
        side = max(self.height, self.width)
        if self.hysteresis_inner_steps is None:
            # Derived default (frozen dataclass, hence object.__setattr__):
            # 32 in the 4K band, 16 everywhere else (see the field comment).
            object.__setattr__(
                self,
                "hysteresis_inner_steps",
                32 if 2048 < side <= 4096 else 16,
            )
        elif self.hysteresis_inner_steps < 1:
            raise ValueError("hysteresis_inner_steps must be >= 1")
        if self.hysteresis_scan_after is None:
            # Derived default: see the field comment.
            object.__setattr__(
                self, "hysteresis_scan_after", 64 if side <= 2048 else 32
            )
        elif self.hysteresis_scan_after < 1:
            raise ValueError("hysteresis_scan_after must be >= 1")
        cap = self.threshold_cap
        if not (0 <= self.low_threshold <= cap) or not (
            0 <= self.high_threshold <= cap
        ):
            raise ValueError(
                f"thresholds must be in [0, {cap}] for parity='{self.parity}'"
            )
        if self.low_threshold > self.high_threshold:
            raise ValueError(
                f"low_threshold ({self.low_threshold}) must be <= "
                f"high_threshold ({self.high_threshold})"
            )

    @property
    def threshold_cap(self) -> int:
        """Largest meaningful threshold for the configured parity domain:
        255 for the reference's uint8 magnitudes; the raw Sobel magnitude
        ceiling (1443 L2 / 2040 L1, rounded up) for 'opencv' parity."""
        return 255 if self.parity == "reference" else 2048

    def with_thresholds(self, low: int, high: int) -> "CannyConfig":
        cap = self.threshold_cap
        low = max(0, min(cap, int(low)))
        high = max(0, min(cap, int(high)))
        if low > high:
            low = high
        return dataclasses.replace(self, low_threshold=low, high_threshold=high)

    @property
    def halo(self) -> int:
        """Total stencil halo from mono to threshold (rows/cols each side)."""
        return self.kernel_size // 2 + 1 + 1  # gaussian + sobel + nms

"""Canny pipeline stage identifiers.

The analog of the reference's ``CannyStage`` enum and display-name map
(reference: src/cvp/define.hpp:9-34). Stage selection is a first-class product
feature: running the pipeline with ``final_stage = k`` executes stages 0..k
cumulatively (reference: src/cvp/cannyEdgeH.cu:49-120).
"""
from __future__ import annotations

import enum


class CannyStage(enum.IntEnum):
    """Pipeline stages, in execution order (reference: define.hpp:9-17)."""

    MONO = 0
    GAUSSIAN = 1
    GRADIENT = 2
    NMS = 3
    THRESH = 4
    HYSTER = 5


#: Display names, mirroring the reference UI strings (define.hpp:27-34).
CANNY_STAGE_NAMES: dict[CannyStage, str] = {
    CannyStage.MONO: "1/6 Mono Conversion",
    CannyStage.GAUSSIAN: "2/6 Gaussian Filter",
    CannyStage.GRADIENT: "3/6 Gradient Computation",
    CannyStage.NMS: "4/6 Non-Maximum Suppression",
    CannyStage.THRESH: "5/6 Double Threshold",
    CannyStage.HYSTER: "6/6 Hysteresis",
}

#: Pixel classification constants (reference: cannyEdgeD.cu:31-33).
FINAL_EDGE = 255
CANDIDATE_EDGE = 128
NO_EDGE = 0

"""Device-resident output ring buffer — the PBO analog.

The reference keeps display frames on the GPU via a CUDA-GL interop pixel
buffer object: the pipeline D2D-copies its stage output into the PBO and
OpenGL textures straight from it, so display never crosses back to the host
(reference cannyEdgeH.cu:166-209; imguiApp.cpp:427-431). A headless host has
no GL; the equivalent discipline is a ring of device arrays: ``push`` retains
the engine's output on device (no transfer, no sync), and host readback
happens only on explicit ``fetch``/``latest_np`` for preview, recording or
inspection.

A plain slot list is used rather than one stacked device array: pushing a
frame is then a zero-cost reference retain of the engine's async output (a
stacked-array ring would pay a device-side copy per frame).
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np


class DeviceRingBuffer:
    """Fixed-capacity ring of device arrays, newest-first access."""

    def __init__(self, capacity: int = 8) -> None:
        if capacity <= 0:
            raise ValueError("capacity must be positive")
        self._cap = capacity
        self._slots: List = [None] * capacity
        self._head = -1  # index of newest
        self._count = 0
        self._pushed = 0

    def __len__(self) -> int:
        return self._count

    @property
    def capacity(self) -> int:
        return self._cap

    @property
    def total_pushed(self) -> int:
        return self._pushed

    def push(self, frame) -> None:
        """Retain a device array (async value is fine; no sync forced)."""
        self._head = (self._head + 1) % self._cap
        self._slots[self._head] = frame
        self._count = min(self._count + 1, self._cap)
        self._pushed += 1

    def latest(self):
        """Newest device array, or None."""
        return None if self._count == 0 else self._slots[self._head]

    def get(self, age: int = 0):
        """Device array ``age`` frames back (0 = newest)."""
        if age < 0 or age >= self._count:
            raise IndexError(f"age {age} out of range (have {self._count})")
        return self._slots[(self._head - age) % self._cap]

    def history(self, k: Optional[int] = None) -> List:
        """Newest-first list of up to k retained device arrays."""
        k = self._count if k is None else min(k, self._count)
        return [self.get(i) for i in range(k)]

    def latest_np(self) -> Optional[np.ndarray]:
        """Explicit host readback of the newest frame (the ONLY place the
        ring crosses the device->host boundary)."""
        f = self.latest()
        return None if f is None else np.asarray(f)

    def clear(self) -> None:
        self._slots = [None] * self._cap
        self._head = -1
        self._count = 0

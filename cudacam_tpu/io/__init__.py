"""Frame IO: sources, device ring buffer, FPS metering, preview/export.

The analog of the reference's IO and display plumbing:

* ``io::webcam`` (reference src/io/webcam.{hpp,cpp}) -> the ``FrameSource``
  family in sources.py (webcam, video file, recorded sequence, synthetic);
* the CUDA-GL interop PBO display path (reference cannyEdgeH.cu:166-209,
  imguiApp.cpp:427-431) -> ``DeviceRingBuffer`` in ring.py: outputs stay
  device-resident, host readback happens only on explicit preview/export;
* the ImGui FPS meter (imguiApp.cpp:267-283) -> ``FpsMeter`` in metrics.py;
* the SDL/OpenGL window -> headless preview/export in preview.py (compute
  hosts have no GL; PNG export and terminal rendering are first-class instead).
"""
from cudacam_tpu.io.sources import (
    FrameSource,
    SequenceSource,
    SyntheticSource,
    VideoFileSource,
    WebcamSource,
    make_scene,
    open_source,
)
from cudacam_tpu.io.ring import DeviceRingBuffer
from cudacam_tpu.io.metrics import FpsMeter
from cudacam_tpu.io.preview import ascii_preview, save_png

__all__ = [
    "FrameSource",
    "SyntheticSource",
    "VideoFileSource",
    "WebcamSource",
    "SequenceSource",
    "make_scene",
    "open_source",
    "DeviceRingBuffer",
    "FpsMeter",
    "ascii_preview",
    "save_png",
]

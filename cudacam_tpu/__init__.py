"""cudacam_tpu — a real-time Canny edge-detection framework in JAX.

Built from scratch in JAX/XLA with the capabilities of the CUDA
desktop app axoloto/CudaCam (see SURVEY.md), re-architected as one
compiled XLA program per frame: integer stencils, a bit-packed on-device
lax.while_loop hysteresis fixed point, device-resident frame ring buffers,
and shard_map tiling with halo exchange for multi-device / multi-host
scaling. Its accelerator is an NVIDIA GPU.
"""
from cudacam_tpu.config import CannyConfig
from cudacam_tpu.stages import CANDIDATE_EDGE, CANNY_STAGE_NAMES, FINAL_EDGE, NO_EDGE, CannyStage

__version__ = "0.2.0"

__all__ = [
    "CannyConfig",
    "CannyStage",
    "CANNY_STAGE_NAMES",
    "FINAL_EDGE",
    "CANDIDATE_EDGE",
    "NO_EDGE",
    "__version__",
]

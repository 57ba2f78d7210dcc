"""Soak of the STREAMING APP (not the bench harness): run the real
CannyApp loop with a device-resident frame cycle for thousands of frames,
recording rolling fps and host RSS — proof the app holds up in sustained
use.

    python tools/soak.py [frames] [loop_n]

Prints one status line every 500 frames and a final JSON summary.
Reference analog: the sustained ~60 Hz run loop the reference's product
is (reference src/imgui/imguiApp.cpp:496-525). The soak's claims are
STABILITY (fps flat, RSS flat), not throughput; bench.py owns the device
number.
"""
import json
import os
import resource
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from cudacam_tpu.app import CannyApp
from cudacam_tpu.io import open_source


def rss_mb() -> float:
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024.0


def main():
    frames = int(sys.argv[1]) if len(sys.argv) > 1 else 5000
    loop_n = int(sys.argv[2]) if len(sys.argv) > 2 else 8
    source = open_source("synthetic:1080x1920")
    with CannyApp(source) as app:
        app.warmup()
        got = app.preload_device_loop(loop_n)
        print(
            f"device loop: {got} frames preloaded; rss={rss_mb():.0f} MB",
            flush=True,
        )
        import jax

        samples = []
        t0 = time.perf_counter()
        window_t0, window_n = t0, 0
        out = None
        for done in range(1, frames + 1):
            out = app.step()
            window_n += 1
            if done % 500 == 0:
                now = time.perf_counter()
                fps = window_n / (now - window_t0)
                samples.append(
                    {"frame": done, "fps": round(fps, 1),
                     "rss_mb": round(rss_mb(), 1)}
                )
                print(samples[-1], flush=True)
                window_t0, window_n = now, 0
        # Drain: wait for the final output so queued device work is
        # included in wall_s.
        jax.block_until_ready(out)
        total_s = time.perf_counter() - t0
    fps_vals = [s["fps"] for s in samples]
    rss_vals = [s["rss_mb"] for s in samples]
    print(json.dumps({
        "frames": frames,
        "loop_n": loop_n,
        "wall_s": round(total_s, 1),
        "fps_overall": round(frames / total_s, 1),
        "fps_min": min(fps_vals),
        "fps_max": max(fps_vals),
        "rss_first_mb": rss_vals[0],
        "rss_last_mb": rss_vals[-1],
        "rss_growth_mb": round(rss_vals[-1] - rss_vals[0], 1),
    }))


if __name__ == "__main__":
    main()

#!/usr/bin/env python
"""Benchmark entry point (prints ONE JSON line; needs a GPU).

The implementation lives in cudacam_tpu.benchmark so it ships with the
package (`python -m cudacam_tpu bench` / `cudacam-tpu bench` work from an
installed copy); this shim keeps the repo-root invocation.

    python bench.py          # canonical single-line metric
    python bench.py --full   # extended per-configuration table

On a platform other than the GPU it exits non-zero and prints no result.
"""
from cudacam_tpu.benchmark import (  # noqa: F401 (re-exported for callers)
    BASELINE_MS,
    cli_entry,
    full_table,
    main,
    make_scene,
)

if __name__ == "__main__":
    cli_entry()

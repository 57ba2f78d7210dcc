"""Multi-host initialisation and cluster-wide mesh construction.

The reference has no distributed backend at all (no NCCL/MPI/Gloo — SURVEY.md
§2.4); this is the framework's. Multi-host runs use ``jax.distributed`` (one
process per host; XLA hands the collectives to NCCL on GPUs); every process
then builds the same global (b, y, x) mesh over ``jax.devices()`` and the
sharded pipeline (cudacam_tpu/parallel/sharded.py) runs SPMD with halo
exchange and convergence psums.

Typical multi-host launch (one command per host)::

    python -m cudacam_tpu.parallel.distributed --coordinator host0:8476 \
        --num-processes 4 --process-id $ID -- run --source synthetic ...

or programmatically::

    from cudacam_tpu.parallel.distributed import initialize, pod_mesh
    initialize("host0:8476", num_processes=4, process_id=ID)
    mesh = pod_mesh(batch=1)     # all devices on the row axis
"""
from __future__ import annotations

from typing import Optional

import jax

from cudacam_tpu.parallel.mesh import make_mesh
from cudacam_tpu.utils.logging import get_logger

log = get_logger("distributed")

_initialized = False


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> None:
    """Initialise jax.distributed (idempotent). Arguments left as None are
    left to jax's own cluster autodetection, which finds nothing on a plain
    GPU host: there, pass all three."""
    global _initialized
    if _initialized:
        return
    kwargs = {}
    if coordinator_address is not None:
        kwargs["coordinator_address"] = coordinator_address
    if num_processes is not None:
        kwargs["num_processes"] = num_processes
    if process_id is not None:
        kwargs["process_id"] = process_id
    jax.distributed.initialize(**kwargs)
    _initialized = True
    log.info(
        "distributed: process %d/%d, %d local / %d global devices",
        jax.process_index(),
        jax.process_count(),
        jax.local_device_count(),
        jax.device_count(),
    )


def pod_mesh(batch: int = 1, cols: int = 1):
    """Global (b, y, x) mesh over every device of every process; all
    remaining devices go to the row axis, so a mega-frame's halo exchange
    is with two neighbours."""
    return make_mesh(batch=batch, cols=cols, devices=jax.devices())


def is_coordinator() -> bool:
    """True on the process that should own logging/IO (analog of rank 0)."""
    return jax.process_index() == 0


def _main() -> int:  # pragma: no cover - requires several hosts
    """Tiny launcher: initialise distributed, then delegate to the CLI."""
    import argparse
    import sys

    p = argparse.ArgumentParser(prog="cudacam_tpu.parallel.distributed")
    p.add_argument("--coordinator", default=None)
    p.add_argument("--num-processes", type=int, default=None)
    p.add_argument("--process-id", type=int, default=None)
    p.add_argument("rest", nargs=argparse.REMAINDER,
                   help="CLI args after '--' (e.g. -- run --source ...)")
    args = p.parse_args()
    initialize(args.coordinator, args.num_processes, args.process_id)
    rest = args.rest[1:] if args.rest[:1] == ["--"] else args.rest
    from cudacam_tpu.cli import main as cli_main

    return cli_main(rest)


if __name__ == "__main__":  # pragma: no cover
    import sys

    sys.exit(_main())

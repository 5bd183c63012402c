"""Multi-host rendering: jax.distributed bring-up + cross-host assembly.

The reference is single-process (SURVEY.md §2.7); this build scales over
several hosts with the standard JAX multi-controller recipe:

* every host calls :func:`initialize` (coordinator address via env or args),
* :func:`global_mesh` builds the ('px', 'spp') mesh over ALL devices in the
  job — shard_map + psum then ride the device interconnect within a host
  and the network across hosts,
* :func:`render_image_multihost` runs the same sharded pass loop as
  ``parallel.render.render_image_sharded`` and gathers the framebuffer to
  every host with ``process_allgather`` (host 0 writes the image).

Fault tolerance is the standard JAX story (SURVEY.md §5): a lost host fails
the job; restart and resume from the last pass checkpoint
(``utils.checkpoint``), which is why the accumulation state is
(sum, spp_done) — any pass boundary is a resume point.

Single-host jobs work unchanged (initialize() is a no-op without peers), so
this module is exercised by the CPU test mesh too.
"""

from __future__ import annotations

from typing import Optional

import jax
import numpy as np

from .mesh import make_mesh
from .render import render_image_sharded


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None) -> None:
    """Bring up jax.distributed when running multi-process; no-op otherwise.

    With no arguments, relies on the standard env auto-detection
    (JAX_COORDINATOR_ADDRESS etc.)."""
    if num_processes is not None and num_processes <= 1:
        return
    if coordinator_address is None and num_processes is None:
        # single-process unless the environment says otherwise
        import os

        if not os.environ.get("JAX_COORDINATOR_ADDRESS"):
            return
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )


def global_mesh(spp_shards: Optional[int] = None):
    """('px', 'spp') mesh over every device in the job (all hosts)."""
    return make_mesh(jax.devices(), spp_shards=spp_shards)


def make_assemble(mesh) -> "callable":
    """Build the cross-host framebuffer assembler for ``mesh``.

    A px-sharded global array is not fully addressable on any one host, so
    ``np.asarray`` alone fails multi-process.  The assembler reshards to a
    fully-REPLICATED layout (an all-gather placed by XLA) and
    only then copies to host — every host gets the identical framebuffer.
    Single-process it degenerates to a plain device->host copy."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    def assemble(accum) -> np.ndarray:
        if jax.process_count() > 1:
            replicate = jax.jit(
                lambda x: x, out_shardings=NamedSharding(mesh, P()))
            accum = replicate(accum)
        return np.asarray(accum)

    return assemble


def render_image_multihost(scene, cfg, *, mesh=None, integrator: str = "path",
                           chunk: int = 65536, progress=None,
                           accum_state=None, on_pass=None):
    """Sharded render + cross-host framebuffer assembly.

    Returns (image_u8, accum_state) on every host (identical content).
    ``on_pass(state)`` fires at every pass boundary (checkpointing — the
    resume path after a lost-host job restart, SURVEY.md §5)."""
    if mesh is None:
        mesh = global_mesh()
    return render_image_sharded(
        scene, cfg, mesh=mesh, integrator=integrator, chunk=chunk,
        progress=progress, accum_state=accum_state, on_pass=on_pass,
        assemble=make_assemble(mesh),
    )

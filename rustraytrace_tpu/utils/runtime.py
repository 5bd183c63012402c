"""Process start-up for the entry points: compile cache and device checks.

The CLI, ``bench.py``, ``chip_smoke.py`` and ``examples/`` call these at
start-up; importing the package never does, so tests keep JAX's defaults.
"""

from __future__ import annotations

import os
import subprocess
import sys

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CACHE_DIR = os.path.join(_REPO, ".jax_cache")


def setup_compile_cache() -> str:
    """Point JAX's persistent compilation cache at one fixed directory.

    If ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and no
    other directory is set; otherwise the cache lives at ``<repo>/.jax_cache``
    (a fixed path, so later processes hit it).  Returns the directory."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax

    jax.config.update("jax_compilation_cache_dir", CACHE_DIR)
    return CACHE_DIR


def card_info() -> str:
    """The card's name and power limit as nvidia-smi reports them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True).stdout
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({e.__class__.__name__})"
    return out.strip()


def require_gpu(tool: str) -> None:
    """Exit non-zero unless JAX's first device is a GPU: a measurement or
    smoke run never carries on on the CPU."""
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"{tool}: needs a GPU, but JAX's first device is "
              f"{dev.platform!r} ({dev.device_kind}); refusing to run",
              file=sys.stderr)
        raise SystemExit(2)

#!/usr/bin/env python
"""Regenerate the golden-render fixtures in tests/goldens/.

Run this ONLY when integrator/intersection/RNG semantics change on purpose:

    python scripts/regen_goldens.py            # writes tests/goldens/*.npz
    python -m pytest tests/test_goldens.py -q  # must pass afterwards

Goldens are tiny XLA-path renders with a fixed key on the CPU backend (the
tests run with JAX_PLATFORMS=cpu; this script pins the CPU too, so regen ==
test environment).  The CASES table lives in tests/test_goldens.py and is imported
here so the two can never drift apart.
"""

import os
import sys

os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "")
    + " --xla_force_host_platform_device_count=8"
)

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tests"))

import numpy as np  # noqa: E402


def main() -> int:
    from test_goldens import CASES, GOLDEN_DIR, _render

    os.makedirs(GOLDEN_DIR, exist_ok=True)
    for name, spec in sorted(CASES.items()):
        img = _render(*spec)
        path = os.path.join(GOLDEN_DIR, f"{name}.npz")
        np.savez_compressed(path, img=img.astype(np.float32))
        print(f"{name}: {img.shape} mean={img.mean():.5f} -> {path}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

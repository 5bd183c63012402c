"""Pass-boundary checkpoint/resume of the accumulation state.

The reference's framebuffer is a running (RGB sum, sample count) pair
finalized only at write-out (src/gpu/renderer.wgsl:295-297,
src/render_io.rs:8-12), which makes every pass boundary
(src/gpu/mod.rs:449, src/cuda/mod.rs:403) a resumable state — the reference
just never persists it.  Here it is persisted: an .npz with the accumulated
radiance sum, samples done, the RNG seed, and a scene/config fingerprint so a
resume against different settings is refused instead of silently blending
incompatible renders.
"""

from __future__ import annotations

import hashlib
import json
import os
from typing import Optional

import numpy as np


def _fingerprint(cfg, scene) -> str:
    import jax

    h = hashlib.sha256()
    h.update(json.dumps(
        {k: str(v) for k, v in sorted(vars(cfg).items())}
    ).encode())
    for leaf in jax.tree.leaves(scene):
        a = np.asarray(leaf)
        h.update(str(a.shape).encode())
        # hash the WHOLE buffer: scenes differing only past the first rows
        # (e.g. later spheres of a ~500-sphere field, or diff.fit-updated
        # params) must not fingerprint identically — resume would silently
        # blend incompatible renders. Scene arrays are KBs; cost negligible.
        h.update(a.tobytes())
    return h.hexdigest()[:16]


def save_checkpoint(path: str, accum_state: dict, cfg, scene) -> None:
    np.savez_compressed(
        path,
        accum=np.asarray(accum_state["accum"], np.float32),
        spp_done=np.asarray(accum_state["spp_done"], np.int64),
        seed=np.asarray(cfg.seed, np.int64),
        fingerprint=np.asarray(_fingerprint(cfg, scene)),
    )


def load_checkpoint(path: str, cfg, scene) -> Optional[dict]:
    """Load and validate; raises ValueError on a fingerprint mismatch."""
    with np.load(path, allow_pickle=False) as z:
        fp = str(z["fingerprint"])
        if fp != _fingerprint(cfg, scene):
            raise ValueError(
                f"checkpoint {path} was produced by a different scene/config "
                f"(fingerprint {fp}); refusing to resume"
            )
        return {"accum": z["accum"], "spp_done": int(z["spp_done"])}


# ---------------------------------------------------------------------------
# Train-state checkpoints (inverse rendering)
# ---------------------------------------------------------------------------

TRAIN_STATE_FILE = "train_state.npz"


def train_state_path(ckpt_dir: str) -> str:
    return os.path.join(ckpt_dir, TRAIN_STATE_FILE)


def save_train_checkpoint(path: str, *, step: int, params, opt_state,
                          key) -> None:
    """Persist a diff.fit train state (params, optimizer state, step, RNG
    key) for long inverse-rendering runs — the analog of the
    render-accumulation .npz above.  ``path`` is a directory; the flattened
    state pytree goes to ``<path>/train_state.npz``, written to a temporary
    file and renamed so a killed run never leaves a torn checkpoint."""
    import jax

    os.makedirs(path, exist_ok=True)
    tree = {"step": np.asarray(step, np.int32), "params": params,
            "opt_state": opt_state,
            "key_data": jax.random.key_data(key)}
    leaves = {f"leaf_{i}": np.asarray(x)
              for i, x in enumerate(jax.tree.leaves(tree))}
    final = train_state_path(path)
    tmp = final + ".tmp.npz"
    np.savez(tmp, **leaves)
    os.replace(tmp, final)


def load_train_checkpoint(path: str, *, params_like, opt_state_like):
    """Restore a train state saved by :func:`save_train_checkpoint`.

    ``params_like`` / ``opt_state_like`` supply the pytree structure (build
    them exactly as diff.fit does: extract_params + opt.init) so optimizer
    NamedTuples come back as such.  Returns ``(step, params, opt_state,
    key)``."""
    import jax
    import jax.numpy as jnp

    like = {"step": np.asarray(0, np.int32), "params": params_like,
            "opt_state": opt_state_like,
            "key_data": jax.random.key_data(jax.random.key(0))}
    treedef = jax.tree.structure(like)
    with np.load(train_state_path(path), allow_pickle=False) as z:
        leaves = [jnp.asarray(z[f"leaf_{i}"])
                  for i in range(treedef.num_leaves)]
    restored = jax.tree.unflatten(treedef, leaves)
    key = jax.random.wrap_key_data(restored["key_data"])
    return (int(restored["step"]), restored["params"],
            restored["opt_state"], key)

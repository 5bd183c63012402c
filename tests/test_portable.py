"""Portable dependencies: the .npz train-state checkpoint, the decoded
earth texture asset, and the optional PNG writer."""

import os
import subprocess

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from rustraytrace_tpu.models import scenes
from rustraytrace_tpu.utils.checkpoint import (load_train_checkpoint,
                                               save_train_checkpoint,
                                               train_state_path)

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_train_checkpoint_roundtrip(tmp_path):
    """Params, Adam state (NamedTuples), step and RNG key survive exactly."""
    params = {"sph_center": jnp.arange(12.0).reshape(4, 3),
              "tex_color1": jnp.full((3, 3), 0.25)}
    opt = optax.adam(1e-2)
    state = opt.init(params)
    grads = jax.tree.map(jnp.ones_like, params)
    _, state = opt.update(grads, state, params)
    key = jax.random.split(jax.random.key(7))[1]
    ck = str(tmp_path / "ck")
    save_train_checkpoint(ck, step=5, params=params, opt_state=state,
                          key=key)
    assert os.path.exists(train_state_path(ck))
    assert not [f for f in os.listdir(ck) if f.endswith(".tmp.npz")]
    step, p2, s2, k2 = load_train_checkpoint(
        ck, params_like=params, opt_state_like=opt.init(params))
    assert step == 5
    assert jax.tree.structure(s2) == jax.tree.structure(state)
    for a, b in zip(jax.tree.leaves((params, state)),
                    jax.tree.leaves((p2, s2))):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    np.testing.assert_array_equal(jax.random.key_data(k2),
                                  jax.random.key_data(key))
    # overwriting an existing checkpoint replaces it
    save_train_checkpoint(ck, step=6, params=params, opt_state=state,
                          key=key)
    assert load_train_checkpoint(ck, params_like=params,
                                 opt_state_like=state)[0] == 6


def test_earthmap_asset_loads():
    img = scenes._load_earthmap()
    assert img.shape == (512, 1024, 3) and img.dtype == np.float32
    assert 0.0 <= img.min() and img.max() <= 1.0
    # a real map, not a flat or two-color fill
    assert len(np.unique(img[::8, ::8].reshape(-1, 3), axis=0)) > 1000


def test_earthmap_env_dir_first(monkeypatch, tmp_path):
    """$RTW_IMAGES is searched before the bundled asset (rtw_image.rs)."""
    mine = np.full((2, 4, 3), 51, np.uint8)
    np.savez(tmp_path / "earthmap.npz", img=mine)
    monkeypatch.setenv("RTW_IMAGES", str(tmp_path))
    np.testing.assert_allclose(scenes._load_earthmap(), 0.2)


def test_earthmap_missing_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("RTW_IMAGES", str(tmp_path))
    monkeypatch.setattr(scenes.os.path, "exists", lambda p: False)
    with pytest.raises(FileNotFoundError, match="earthmap.npz"):
        scenes.book2_earth()


def test_png_without_pillow_says_so(monkeypatch, tmp_path, capsys):
    import builtins

    from rustraytrace_tpu.utils.image_io import read_ppm, write_image

    real_import = builtins.__import__

    def no_pil(name, *a, **kw):
        if name == "PIL" or name.startswith("PIL."):
            raise ImportError("no Pillow")
        return real_import(name, *a, **kw)

    monkeypatch.setattr(builtins, "__import__", no_pil)
    img = np.zeros((2, 3, 3), np.uint8)
    write_image(img, str(tmp_path / "x.png"))
    assert "needs Pillow" in capsys.readouterr().err
    assert read_ppm(str(tmp_path / "x.ppm")).shape == (2, 3, 3)


def test_native_library_not_tracked():
    """The shared library is a build output of native/src, not a source."""
    tracked = subprocess.run(["git", "ls-files", "native"], cwd=_REPO,
                             capture_output=True, text=True).stdout.split()
    if not tracked:
        pytest.skip("not a git checkout")
    assert "native/librtt_native.so" not in tracked
    assert "native/Makefile" in tracked

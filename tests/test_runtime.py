"""Entry-point start-up: the compile-cache helper and the GPU-only gates of
bench.py and chip_smoke.py."""

import json
import os
import shutil
import subprocess
import sys

import jax
import pytest

from rustraytrace_tpu.utils import runtime

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def restore_cache_dir():
    before = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", before)


def test_compile_cache_default_dir(monkeypatch, restore_cache_dir):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = runtime.setup_compile_cache()
    assert path == os.path.join(_REPO, ".jax_cache")
    assert jax.config.jax_compilation_cache_dir == path


def test_compile_cache_env_wins(monkeypatch, tmp_path, restore_cache_dir):
    """With the variable set, the helper sets no directory of its own."""
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    jax.config.update("jax_compilation_cache_dir", None)
    assert runtime.setup_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir is None


def test_cache_dir_is_ignored():
    with open(os.path.join(_REPO, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


def test_require_gpu_refuses_cpu(capsys):
    assert jax.devices()[0].platform == "cpu"
    with pytest.raises(SystemExit) as e:
        runtime.require_gpu("tool")
    assert e.value.code == 2
    assert "needs a GPU" in capsys.readouterr().err


def _run(args, cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH", None)
    return subprocess.run([sys.executable] + args, cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def _no_result(stdout):
    for line in stdout.splitlines():
        try:
            rec = json.loads(line)
        except ValueError:
            continue
        assert not isinstance(rec, dict), line


@pytest.mark.parametrize("script", ["bench.py", "chip_smoke.py"])
def test_entry_point_refuses_cpu(script):
    p = _run([script], _REPO)
    assert p.returncode != 0
    assert "needs a GPU" in p.stderr
    _no_result(p.stdout)


def test_chip_smoke_alone_fails(tmp_path):
    """chip_smoke.py without the rest of the repo prints no result."""
    shutil.copy(os.path.join(_REPO, "chip_smoke.py"), tmp_path)
    p = _run(["chip_smoke.py"], str(tmp_path))
    assert p.returncode != 0
    _no_result(p.stdout)


def test_card_info_without_nvidia_smi(monkeypatch):
    monkeypatch.setenv("PATH", "")
    assert runtime.card_info().startswith("nvidia-smi unavailable")

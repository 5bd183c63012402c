"""Multi-process CPU execution of the multihost bring-up + sharded render.

This spawns TWO real processes (jax.distributed over a local
coordinator, one CPU device each), renders the same tiny scene through
``render_image_multihost``, and asserts both hosts assemble the identical
framebuffer."""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_CHILD = """
import os, sys
import jax
jax.config.update("jax_platforms", "cpu")
pid, coord, outdir = int(sys.argv[1]), sys.argv[2], sys.argv[3]
from rustraytrace_tpu.parallel import multihost
multihost.initialize(coordinator_address=coord, num_processes=2,
                     process_id=pid)
assert jax.process_count() == 2, jax.process_count()
assert len(jax.devices()) == 2  # one CPU device per process

import numpy as np
from rustraytrace_tpu import models

scene, cfg, integ = models.book1_three_spheres(
    dict(image_width=16, samples_per_pixel=2, max_depth=3, spp_per_pass=2))
cfg = cfg.replace(aspect_ratio=2.0)  # 16x8
img, state = multihost.render_image_multihost(
    scene, cfg, integrator=integ, chunk=256)
np.savez(os.path.join(outdir, f"out_{pid}.npz"),
         img=img, accum=state["accum"], spp=state["spp_done"])
"""


_CHILD_SPP = """
import os, sys
import jax
jax.config.update("jax_platforms", "cpu")
pid, coord, outdir = int(sys.argv[1]), sys.argv[2], sys.argv[3]
from rustraytrace_tpu.parallel import multihost
multihost.initialize(coordinator_address=coord, num_processes=2,
                     process_id=pid)
assert jax.process_count() == 2

import numpy as np
from rustraytrace_tpu import models
from rustraytrace_tpu.utils.checkpoint import load_checkpoint, save_checkpoint

# spp-sharded mesh: px=1, spp=2 — each PROCESS owns one sample shard
mesh = multihost.global_mesh(spp_shards=2)
assert dict(mesh.shape) == {"px": 1, "spp": 2}, dict(mesh.shape)

scene, cfg, integ = models.book1_three_spheres(
    dict(image_width=16, samples_per_pixel=4, max_depth=3, spp_per_pass=2))
cfg = cfg.replace(aspect_ratio=2.0)  # 16x8

# full 4-spp render: the reference result
img_full, st_full = multihost.render_image_multihost(
    scene, cfg, mesh=mesh, integrator=integ, chunk=256)
assert st_full["spp_done"] == 4

# checkpoint/resume cycle UNDER the sharded loop: render the first pass
# only, persist the assembled state (each process writes its own copy),
# then resume the remaining pass from the checkpoint
assemble = multihost.make_assemble(mesh)
states = []
multihost.render_image_multihost(
    scene, cfg.replace(samples_per_pixel=2), mesh=mesh, integrator=integ,
    chunk=256,
    on_pass=lambda s: states.append(
        {"accum": assemble(s["accum"]), "spp_done": s["spp_done"]}))
ck = os.path.join(outdir, f"ck_{pid}.npz")
save_checkpoint(ck, states[-1], cfg, scene)
resumed_state = load_checkpoint(ck, cfg, scene)
assert resumed_state is not None and resumed_state["spp_done"] == 2
img_res, st_res = multihost.render_image_multihost(
    scene, cfg, mesh=mesh, integrator=integ, chunk=256,
    accum_state=resumed_state)
assert st_res["spp_done"] == 4
np.savez(os.path.join(outdir, f"spp_{pid}.npz"),
         img_full=img_full, accum_full=st_full["accum"],
         img_res=img_res, accum_res=st_res["accum"])
"""


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_two_process_cpu_multihost(tmp_path):
    coord = f"127.0.0.1:{_free_port()}"
    env = dict(os.environ)
    # one local CPU device per process (the parent test env forces 8)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=1"
    env["JAX_PLATFORMS"] = "cpu"  # two concurrent children: never a card
    procs = [
        subprocess.Popen(
            [sys.executable, "-c", _CHILD, str(i), coord, str(tmp_path)],
            env=env, cwd=_REPO,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE)
        for i in (0, 1)
    ]
    errs = []
    for p in procs:
        try:
            _, err = p.communicate(timeout=420)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail("multihost child timed out")
        errs.append(err.decode(errors="replace"))
        assert p.returncode == 0, errs
    a = np.load(tmp_path / "out_0.npz")
    b = np.load(tmp_path / "out_1.npz")
    # identical framebuffers on every host, real content, correct spp
    np.testing.assert_array_equal(a["img"], b["img"])
    np.testing.assert_array_equal(a["accum"], b["accum"])
    assert np.isfinite(a["accum"]).all()
    assert float(np.abs(a["accum"]).sum()) > 0.0
    assert int(a["spp"]) == 2


def test_two_process_spp_sharded_with_resume(tmp_path):
    """A 2-process mesh with spp_shards=2 —
    each PROCESS owns a sample shard — assembles identical framebuffers,
    and a checkpoint/resume cycle under the sharded loop reproduces the
    uninterrupted render bit-exactly (the spp-sharded key basis is the
    absolute sample index, so pass splits don't change the streams)."""
    coord = f"127.0.0.1:{_free_port()}"
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=1"
    env["JAX_PLATFORMS"] = "cpu"  # two concurrent children: never a card
    procs = [
        subprocess.Popen(
            [sys.executable, "-c", _CHILD_SPP, str(i), coord, str(tmp_path)],
            env=env, cwd=_REPO,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE)
        for i in (0, 1)
    ]
    errs = []
    for p in procs:
        try:
            _, err = p.communicate(timeout=420)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail("multihost spp child timed out")
        errs.append(err.decode(errors="replace"))
        assert p.returncode == 0, errs
    a = np.load(tmp_path / "spp_0.npz")
    b = np.load(tmp_path / "spp_1.npz")
    # both processes assemble the identical framebuffer at the right spp
    np.testing.assert_array_equal(a["accum_full"], b["accum_full"])
    np.testing.assert_array_equal(a["img_full"], b["img_full"])
    assert float(np.abs(a["accum_full"]).sum()) > 0.0
    # resume == uninterrupted, on every host
    np.testing.assert_array_equal(a["accum_res"], a["accum_full"])
    np.testing.assert_array_equal(b["img_res"], b["img_full"])

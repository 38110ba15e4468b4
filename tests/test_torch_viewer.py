"""The port's trajectory viewer (``utils/viewer``) and ``cli play --render``
against the JAX package, on the CPU.

- ``record_frame`` of a perturbed stand state against the JAX
  ``record_frame`` of the same state, to 1e-6 absolute;
- ``_terrain_patch`` on ``uneven_patches(seed=0)`` against JAX's, to 1e-6
  absolute;
- ``render`` of 8 frames writes a GIF of 8 frames;
- without matplotlib, ``require_matplotlib`` (and ``render``) raise naming
  it, and ``play --render`` raises before its first tick;
- ``cli play --render`` at 2 envs for 0.1 s writes the GIF.
"""
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from rl_mpc_locomotion_tpu.models import robots as jrobots
from rl_mpc_locomotion_tpu.sim import physics as jphysics
from rl_mpc_locomotion_tpu.sim import terrain as jterrain
from rl_mpc_locomotion_tpu.utils import viewer as jviewer

from rl_mpc_locomotion_tpu_torch import cli
from rl_mpc_locomotion_tpu_torch.models import robots
from rl_mpc_locomotion_tpu_torch.sim import terrain
from rl_mpc_locomotion_tpu_torch.utils import convert, viewer


def perturbed_stand(seed):
    """JAX's stand state with position, orientation and joints moved by
    seeded amounts (numpy fields)."""
    rng = np.random.default_rng(seed)
    st = jphysics.init_state(jrobots.go1_params(),
                             jnp.tile(jnp.array([0.0, 0.8, -1.6]), 4), 0.33)
    quat = np.array([1.0, 0.0, 0.0, 0.0]) + 0.2 * rng.normal(size=4)
    quat /= np.linalg.norm(quat)
    return st._replace(
        pos=jnp.asarray(np.asarray(st.pos) + 0.3 * rng.normal(size=3),
                        jnp.float32),
        quat=jnp.asarray(quat, jnp.float32),
        q=jnp.asarray(np.asarray(st.q) + 0.3 * rng.normal(size=12),
                      jnp.float32))


@pytest.mark.parametrize("seed", [0, 1])
def test_record_frame_matches_jax(seed):
    jst = perturbed_stand(seed)
    want = jviewer.record_frame(jrobots.go1_params(), jst)
    st = convert.phys_state_from_numpy(
        [np.asarray(x) for x in jst], batch=1)
    got = viewer.record_frame(robots.go1_params("cpu"), st)
    assert sorted(got) == sorted(want) == ["corners", "feet", "knees", "pos"]
    for k in want:
        assert got[k].shape == np.asarray(want[k]).shape, k
        np.testing.assert_allclose(got[k], np.asarray(want[k]), rtol=0,
                                   atol=1e-6, err_msg=k)


def test_record_frame_takes_a_batch_of_one():
    st = convert.phys_state_from_numpy(
        [np.asarray(x) for x in perturbed_stand(0)], batch=2)
    with pytest.raises(ValueError, match="batch of one"):
        viewer.record_frame(robots.go1_params("cpu"), st)


def test_terrain_patch_matches_jax():
    x_rng, y_rng = (-1.3, 2.1), (-3.4, 0.7)
    want = jviewer._terrain_patch(jterrain.uneven_patches(seed=0), x_rng,
                                  y_rng)
    got = viewer._terrain_patch(terrain.uneven_patches(seed=0), x_rng, y_rng)
    for g, w in zip(got, want):
        assert g.shape == w.shape == (40, 40)
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-6)


def _gif_frames(path):
    from PIL import Image
    with Image.open(path) as im:
        return im.n_frames


def test_render_writes_a_gif(tmp_path):
    params = robots.go1_params("cpu")
    frames = []
    for i in range(8):
        jst = perturbed_stand(i)
        st = convert.phys_state_from_numpy([np.asarray(x) for x in jst],
                                           batch=1)
        frames.append(viewer.record_frame(params, st))
    out = str(tmp_path / "walk.gif")
    assert viewer.render(frames, terrain.flat(), out, stride=1) == out
    assert _gif_frames(out) == 8


def test_without_matplotlib_rendering_raises(monkeypatch, tmp_path):
    for name in [m for m in sys.modules if m.split(".")[0] == "matplotlib"]:
        monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(ImportError, match="matplotlib"):
        viewer.require_matplotlib()
    with pytest.raises(ImportError, match="matplotlib"):
        viewer.render([], terrain.flat(), str(tmp_path / "x.gif"))

    def no_tick(*args, **kwargs):
        raise AssertionError("a tick ran before the matplotlib check")
    monkeypatch.setattr(cli.runner, "min_step", no_tick)
    with pytest.raises(ImportError, match="matplotlib"):
        cli.main(["play", "--device", "cpu", "--num-envs", "2",
                  "--seconds", "0.1", "--render", str(tmp_path / "p.gif")])
    assert not (tmp_path / "p.gif").exists()


def test_play_render_writes_a_gif(tmp_path, capsys):
    out = tmp_path / "play.gif"
    cli.main(["play", "--device", "cpu", "--num-envs", "2", "--seconds",
              "0.1", "--render", str(out)])
    assert "[play] animation written to" in capsys.readouterr().out
    assert _gif_frames(out) == 3          # 10 ticks at the default stride 4

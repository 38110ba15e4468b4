"""The port's URDF loader (``models/urdf``) and streaming filter
(``ops/filters``) against the JAX package, on the CPU.

Tolerances: ``params_from_urdf`` bitwise (both parse the file in float64
and round once to float32); the moving-window filter and ``smooth``
bitwise too (the same float32 operations in the same order: the Neumaier
compensation is reproduced step for step, nothing is reassociated), and
the compensated average within 2**-23 (relative) of the exact float64
moving average on a trace of 1.0s and 1e8s where an uncompensated float32
running sum is off by more than 10 %.
"""
import os
import tempfile

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from rl_mpc_locomotion_tpu.models import urdf as jurdf
from rl_mpc_locomotion_tpu.ops import filters as jfilters

from rl_mpc_locomotion_tpu_torch.models import robots, urdf
from rl_mpc_locomotion_tpu_torch.ops import filters

ASSETS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "assets")
# (file, body height, mass scale, inertia scale, weights, robot id)
URDFS = [("aliengo", 0.35, 2.0, 1.0, None, robots.ALIENGO),
         ("go1", 0.26, 2.0, 5.0, [10.0] * 13, robots.GO1),
         ("a1", 0.26, 3.0, 10.0, None, robots.A1)]


@pytest.mark.parametrize("name,height,mass_scale,inertia_scale,weights,rid",
                         URDFS, ids=[u[0] for u in URDFS])
def test_params_from_urdf_matches_jax_bitwise(name, height, mass_scale,
                                              inertia_scale, weights, rid):
    path = os.path.join(ASSETS, f"{name}.urdf")
    kw = dict(body_height=height, mass_scale=mass_scale,
              inertia_scale=inertia_scale, friction_coeff=0.6,
              mpc_weights=weights, robot_id=rid)
    want = jurdf.params_from_urdf(path, **kw)
    got = urdf.params_from_urdf(path, **kw, device="cpu")
    assert got.art is None
    for field, g, w in zip(robots.PARAM_RANKS, got, want):
        w = np.asarray(w)
        assert g.dtype == torch.from_numpy(w.copy()).dtype, field
        assert tuple(g.shape) == w.shape, field
        np.testing.assert_array_equal(g.numpy(), w, err_msg=field)


def test_params_from_urdf_missing_joint_raises():
    with open(os.path.join(ASSETS, "a1.urdf")) as f:
        text = f.read().replace("FL_foot_fixed", "FL_toe_fixed")
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "a1.urdf")
        with open(path, "w") as f:
            f.write(text)
        with pytest.raises(KeyError, match="FL_foot_fixed"):
            urdf.params_from_urdf(path, body_height=0.26)


def _window_trace():
    """20 samples of shape (3,) near 1.0, with 1e8 pushed now and then: once
    a big sample has left the window, an uncompensated running sum keeps
    its rounding error, of the order of the small samples themselves."""
    rng = np.random.default_rng(0)
    values = 1.0 + rng.uniform(-0.5, 0.5, (20, 3))
    for col, ticks in enumerate([(0, 7, 13), (2, 3, 10), (5,)]):
        values[list(ticks), col] += 1e8
    return values.astype(np.float32)


def test_moving_window_update_matches_jax():
    values = _window_trace()
    js = jfilters.init_moving_window(4, shape=(3,))
    ts = filters.init_moving_window(4, shape=(3,))
    for t, v in enumerate(values):
        js, javg = jfilters.moving_window_update(js, jnp.asarray(v))
        ts, tavg = filters.moving_window_update(ts, torch.from_numpy(v))
        np.testing.assert_array_equal(tavg.numpy(), np.asarray(javg),
                                      err_msg=f"push {t}")
        for field, g, w in zip(filters.MovingWindowState._fields, ts, js):
            w = np.asarray(w)
            assert g.dtype == torch.from_numpy(w.copy()).dtype, field
            np.testing.assert_array_equal(g.numpy(), w,
                                          err_msg=f"{field}, push {t}")
        # the compensated average is the float64 moving average, rounded
        want = values[max(0, t - 3):t + 1].astype(np.float64).mean(axis=0)
        np.testing.assert_allclose(tavg.numpy(), want, rtol=2 ** -23,
                                   atol=0.0)


def test_neumaier_term_matters_on_the_trace():
    """Against the float64 moving average, relative to it: an
    uncompensated float32 running sum over the same pushes is off by more
    than 10 % once a 1e8 sample has left the window; the filter stays
    within two float32 roundings."""
    values = _window_trace()
    state = filters.init_moving_window(4, shape=(3,))
    naive = np.zeros(3, np.float32)
    naive_err = filtered_err = 0.0
    for t, v in enumerate(values):
        state, avg = filters.moving_window_update(state, torch.from_numpy(v))
        if t >= 4:
            naive = naive - values[t - 4]
        naive = naive + v
        want = values[max(0, t - 3):t + 1].astype(np.float64).mean(axis=0)
        naive_err = max(naive_err, (np.abs(naive / min(t + 1, 4) - want)
                                    / want).max())
        filtered_err = max(filtered_err,
                           (np.abs(avg.numpy() - want) / want).max())
    assert naive_err > 0.1 and filtered_err < 2 * 2 ** -23, (naive_err,
                                                             filtered_err)


def test_smooth_matches_jax():
    rng = np.random.default_rng(1)
    trace = (rng.normal(size=(50, 2, 3)) * np.array([1.0, 1e4, 1e-3])
             ).astype(np.float32)
    want = np.asarray(jfilters.smooth(trace, 7))
    got = filters.smooth(torch.from_numpy(trace), 7)
    assert got.dtype == torch.float32 and tuple(got.shape) == (50, 2, 3)
    np.testing.assert_array_equal(got.numpy(), want)

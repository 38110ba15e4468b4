"""The MPC assembly kernel (``ops/cuda/mpc_assembly``, ``csrc/mpc_assembly.cu``)
against its plain version: on the host through tests/host_emulation, and on
the card (``gpu``-marked tests, skipped without one). The plain version is
the PyTorch code ``control/locomotion._solve_mpc`` runs on CPU tensors; the
JAX parity tests of that code are in tests/test_torch_ops.py and the control
tests. This file imports no JAX, so its card tests run on a machine without
it (``python -m pytest --noconftest tests/test_torch_mpc_assembly.py -m
gpu``).

Tolerances. ``s_chain`` and ``q``: 1e-5 of the robot's largest |value|, for
the kernel against the plain version and against the plain version run in
float64 on the same inputs (sound runs: ~4e-7 and ~9e-7). The kernel takes
the chain in closed form (A^3 = 0, so s[k] = S0 + k S1) and regroups the
gradient's sums, where the plain version multiplies 13 x 13 matrices k
times and sums in cuBLAS's or the CPU's order: float32 rounding of sums of
at most 13 h terms. ``lb``, ``ub`` and ``mask``: exact, the same float32
operations in the same order on entries in {0, 1}.
"""
import numpy as np
import pytest
import torch

from rl_mpc_locomotion_tpu_torch.ops import gait
from rl_mpc_locomotion_tpu_torch.ops import srb_dynamics as srb
from rl_mpc_locomotion_tpu_torch.ops.cuda import mpc_assembly

NAMES = ("s_chain", "q", "lb", "ub", "mask")
CHAIN_TOL = 1e-5
DT_MPC = 0.02
HIPS = np.array([[0.24, -0.13, 0.0], [0.24, 0.13, 0.0], [-0.24, -0.13, 0.0],
                 [-0.24, 0.13, 0.0]])
# the kernel's per_robot bits (csrc/mpc_assembly.cu)
PER_ROBOT_BITS = {"weights": 1, "normal": 2, "mass": 4, "inertia": 8,
                  "height": 16, "mu": 32}


def contact_table(kind, b, h, rng):
    """(B,h,4) in {0,1}: a trot from the gait tables at each robot's own
    phase, all legs down, one leg in swing (three down), or random."""
    if kind == "trot":
        assert h == gait.N_SEGMENTS
        offsets, durations = gait.gait_params(0)
        it = torch.from_numpy(rng.integers(0, 10, b).astype(np.float32))
        return gait.mpc_table(it, offsets, durations).numpy()
    if kind == "stand":
        return np.ones((b, h, 4), np.float32)
    if kind == "three":
        table = np.ones((b, h, 4), np.float32)
        table[np.arange(b), :, rng.integers(0, 4, b)] = 0.0
        return table
    return rng.integers(0, 2, (b, h, 4)).astype(np.float32)


def problem(b, h, seed, table="trot", per_robot=(), flat=True):
    """The wrapper's 13 inputs as float32 numpy arrays, in order: a robot's
    state near a trot's (roll / pitch +-0.3, any yaw, rates +-1, CoM at
    0.28-0.40 m, feet about the hips), commands over the env's ranges, and
    the six shared-or-per-robot inputs, per robot where ``per_robot`` names
    them (``weights``, ``normal``, ``mass``, ``inertia``, ``height``,
    ``mu``). ``flat`` False tilts the ground normal."""
    rng = np.random.default_rng(seed)

    def f32(a):
        return np.ascontiguousarray(a, dtype=np.float32)

    def one_or_per(name, per, shared):
        # a shared value keeps its own shape: () for a scalar
        return f32(per) if name in per_robot else np.array(shared, np.float32)

    rpy = np.c_[rng.uniform(-0.3, 0.3, (b, 2)), rng.uniform(-np.pi, np.pi, b)]
    feet = HIPS + rng.uniform(-0.05, 0.05, (b, 4, 3)) + [0.0, 0.0, -0.33]
    commands = rng.uniform([-2.5, -1.0, -2.5], [2.5, 1.0, 2.5], (b, 3))
    weights_one = [0.25, 0.25, 10, 2, 2, 50, 0, 0, 0.3, 0.2, 0.2, 0.1, 0]
    normal = np.tile([0.0, 0.0, 1.0], (b, 1))
    if not flat:
        normal = normal + rng.normal(size=(b, 3)) * 0.15
        normal /= np.linalg.norm(normal, axis=1, keepdims=True)
    inertia = np.empty((b, 3, 3))
    for i in range(b):
        a = rng.normal(size=(3, 3)) * 0.02
        inertia[i] = np.diag(rng.uniform(0.05, 0.5, 3)) + a @ a.T
    return [
        f32(rpy), f32(rng.uniform(0.28, 0.40, b)),
        f32(rng.uniform(-1, 1, (b, 3))), f32(rng.uniform(-1, 1, (b, 3))),
        f32(feet), contact_table(table, b, h, rng), one_or_per(
            "weights", rng.uniform(0.1, 50, (b, 13)), weights_one),
        f32(commands),
        one_or_per("normal", normal, normal[0]),
        one_or_per("mass", rng.uniform(10, 25, b), 11.041),
        one_or_per("inertia", inertia, np.diag([0.050874, 0.64036, 0.6565])),
        one_or_per("height", rng.uniform(0.30, 0.40, b), 0.35),
        one_or_per("mu", rng.uniform(0.3, 0.8, b), 0.4)]


def reference(args, h, dtype=torch.float32):
    return [o.numpy() for o in mpc_assembly.assemble_mpc_batch_reference(
        *[torch.from_numpy(a).to(dtype) for a in args], dt_mpc=DT_MPC,
        horizon=h)]


def robot_rel(got, want):
    """Largest |got - want| a robot over the robot's largest |want|."""
    b = want.shape[0]
    err = np.abs(got.astype(np.float64) - want).reshape(b, -1).max(1)
    scale = np.abs(want).reshape(b, -1).max(1)
    return float((err / np.maximum(scale, 1e-30)).max())


def assert_matches_plain_version(got, args, h):
    want = reference(args, h)
    want64 = reference(args, h, torch.float64)
    for name, g, w, w64 in zip(NAMES, got, want, want64):
        assert g.shape == w.shape, name
        assert np.isfinite(g).all(), name
        if name in ("s_chain", "q"):
            assert robot_rel(g, w) < CHAIN_TOL, (name, robot_rel(g, w))
            assert robot_rel(g, w64) < CHAIN_TOL, (name, robot_rel(g, w64))
        else:
            np.testing.assert_array_equal(g, w, err_msg=name)


# ---- the CUDA source on the host ------------------------------------------------

@pytest.fixture(scope="module")
def emulation(tmp_path_factory):
    from host_emulation import library
    lib = library.build(tmp_path_factory.mktemp("emu"))
    if lib is None:
        pytest.skip("no g++ to build the host emulation of the kernels")
    return lib


def emulate(lib, args, h, per_robot=()):
    b = args[0].shape[0]
    outs = [np.full(s, np.nan, np.float32)
            for s in ((b, h, 13, 12), (b, 12 * h), (b, 20 * h), (b, 20 * h),
                      (b, 12 * h))]
    rc = lib.rlmpc_emulate_mpc_assembly(
        *[a.ctypes.data for a in list(args) + outs], b, h,
        sum(PER_ROBOT_BITS[name] for name in per_robot), DT_MPC)
    assert rc == 0
    return outs


@pytest.mark.parametrize("b,h,table,per_robot,flat", [
    # a trot, everything shared, flat ground: the fleet's case
    (64, 10, "trot", (), True),
    # all legs down, per-robot weights and ground normal (rough ground)
    (64, 10, "stand", ("weights", "normal"), False),
    # three legs down, domain randomisation's per-robot mass and mu, a
    # stacked batch of robot kinds (inertia, height), another horizon
    (61, 6, "three", ("mass", "mu", "inertia", "height"), True),
    # everything per robot, random tables, a ragged last block
    (37, 10, "random", ("weights", "normal", "mass", "inertia", "height",
                        "mu"), False),
])
def test_mpc_assembly_source_on_the_host_matches_plain_version(
        emulation, b, h, table, per_robot, flat):
    """mpc_assembly_kernel's source, thread for thread on the host, against
    the plain version (module docstring's limits); every output entry is
    written (outputs and shared memory start as NaN)."""
    args = problem(b, h, seed=11 + h, table=table, per_robot=per_robot,
                   flat=flat)
    assert_matches_plain_version(emulate(emulation, args, h, per_robot),
                                 args, h)


def test_mpc_assembly_source_zeroes_the_last_a_qp_block(emulation,
                                                        monkeypatch):
    """The kernel's q keeps the reference's zeroed last A_qp block: it is
    within the limit of the plain version with compat_last_aqp_zero and
    far outside it without."""
    h = 10
    args = problem(32, h, seed=5, per_robot=("weights",))
    got_q = emulate(emulation, args, h, ("weights",))[1]
    assert robot_rel(got_q, reference(args, h)[1]) < CHAIN_TOL
    full = srb.condense_chain
    monkeypatch.setattr(srb, "condense_chain",
                        lambda a, b_, hh: full(a, b_, hh, False))
    unzeroed = reference(args, h)[1]
    assert robot_rel(got_q, unzeroed) > 100 * CHAIN_TOL


def test_mpc_assembly_wrapper_takes_plain_version_on_cpu():
    """CPU tensors take the plain version, bit for bit, and launch
    nothing."""
    args = problem(5, 10, seed=2, per_robot=("mass",))
    before = mpc_assembly.launch_count()
    got = mpc_assembly.assemble_mpc_batch(
        *[torch.from_numpy(a) for a in args], dt_mpc=DT_MPC, horizon=10)
    assert mpc_assembly.launch_count() == before
    for name, g, w in zip(NAMES, got, reference(args, 10)):
        np.testing.assert_array_equal(g.numpy(), w, err_msg=name)


@pytest.mark.parametrize("use_kernel", [True, False])
def test_solve_mpc_takes_the_wrapper_only_with_use_kernel(monkeypatch,
                                                          use_kernel):
    """A solving min_step assembles through the wrapper (the kernel on the
    card) with ``use_kernel``, and through the plain version directly
    without it, so that ``use_kernel=False`` stays a plain pipeline."""
    from rl_mpc_locomotion_tpu_torch.control import runner
    from rl_mpc_locomotion_tpu_torch.control.types import ControlConfig
    from rl_mpc_locomotion_tpu_torch.models import robots
    from rl_mpc_locomotion_tpu_torch.ops import qp as tqp
    calls = []
    for name in ("assemble_mpc_batch", "assemble_mpc_batch_reference"):
        def recorded(*a, _name=name, _fn=getattr(mpc_assembly, name), **kw):
            calls.append(_name)
            return _fn(*a, **kw)
        monkeypatch.setattr(mpc_assembly, name, recorded)
    b = 3
    params = robots.aliengo_params("cpu")
    cfg = ControlConfig(qp=tqp.production_qp_config()._replace(
        use_kernel=use_kernel))
    state = runner.init_state(params, cfg, batch=b, device="cpu")
    q = torch.tensor([0.0, 0.8, -1.6] * 4).repeat(b, 1)
    body = torch.tensor([0, 0, 0.33, 0, 0, 0, 1, 0.2, 0, 0, 0, 0,
                         0.1]).repeat(b, 1)
    commands = torch.tensor([0.4, 0.0, 0.2]).repeat(b, 1)
    _, tau, _ = runner.min_step(params, cfg, state, q, torch.zeros_like(q),
                                body, commands, solve_gate=True)
    assert bool(torch.isfinite(tau).all())
    # the wrapper hands CPU tensors on to the plain version
    assert calls == (["assemble_mpc_batch", "assemble_mpc_batch_reference"]
                     if use_kernel else ["assemble_mpc_batch_reference"])


# ---- on the card --------------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the kernels run only on the card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("b,h,table,per_robot,flat", [
    (4099, 10, "trot", (), True),
    (4099, 10, "stand", ("weights", "normal", "mass", "mu"), False),
    (257, 7, "random", ("weights", "normal", "mass", "inertia", "height",
                        "mu"), False),
])
def test_mpc_assembly_kernel_matches_plain_version_on_the_card(
        b, h, table, per_robot, flat):
    """The kernel on the card against the plain version on the CPU (module
    docstring's limits), one launch."""
    dev = _card()
    args = problem(b, h, seed=3, table=table, per_robot=per_robot,
                   flat=flat)
    before = mpc_assembly.launch_count()
    got = mpc_assembly.assemble_mpc_batch(
        *[torch.from_numpy(a).to(dev) for a in args], dt_mpc=DT_MPC,
        horizon=h)
    torch.cuda.synchronize()
    assert mpc_assembly.launch_count() == before + 1
    for g in got:
        assert g.is_cuda and g.is_contiguous()
    assert_matches_plain_version([g.cpu().numpy() for g in got], args, h)


@pytest.mark.gpu
def test_mpc_assembly_wrapper_refuses_what_the_kernel_does_not_take():
    """Wrong shape, float64, non-contiguous, a tensor on the CPU beside card
    tensors, a misaligned table: each raises and launches nothing."""
    dev = _card()
    args = [torch.from_numpy(a).to(dev) for a in problem(33, 10, seed=4)]
    bad = {
        "shape": (6, args[6][:12]),
        "float64": (0, args[0].double()),
        "contiguity": (2, args[2].t().contiguous().t()),
        "device": (7, args[7].cpu()),
        "alignment": (5, torch.zeros(33 * 40 + 1, device=dev)[1:]
                      .reshape(33, 10, 4)),
        "horizon": (5, args[5][:, :9].contiguous()),
    }
    before = mpc_assembly.launch_count()
    for what, (i, t) in bad.items():
        given = list(args)
        given[i] = t
        with pytest.raises((ValueError, TypeError)):
            mpc_assembly.assemble_mpc_batch(*given, dt_mpc=DT_MPC, horizon=10)
    assert mpc_assembly.launch_count() == before


@pytest.mark.gpu
def test_mpc_assembly_launches_once_a_solving_min_step():
    """runner.min_step on the card: no launch on a tick that does not
    solve, one on a tick that does, none with ``use_kernel=False``."""
    dev = _card()
    from rl_mpc_locomotion_tpu_torch.control import runner
    from rl_mpc_locomotion_tpu_torch.control.types import ControlConfig
    from rl_mpc_locomotion_tpu_torch.models import robots
    from rl_mpc_locomotion_tpu_torch.ops import qp as tqp
    b = 64
    params = robots.aliengo_params(dev)
    cfg = ControlConfig(qp=tqp.production_qp_config())
    state = runner.init_state(params, cfg, batch=b, device=dev)
    q = torch.tensor([0.0, 0.8, -1.6] * 4, device=dev).repeat(b, 1)
    body = torch.tensor([0, 0, 0.33, 0, 0, 0, 1, 0.2, 0, 0, 0, 0, 0.1],
                        dtype=torch.float32, device=dev).repeat(b, 1)
    commands = torch.tensor([0.4, 0.0, 0.2], device=dev).repeat(b, 1)
    counts = []
    for t in range(4):
        before = mpc_assembly.launch_count()
        state, tau, _ = runner.min_step(params, cfg, state, q,
                                        torch.zeros_like(q), body, commands,
                                        solve_gate=(t % 2 == 1))
        counts.append(mpc_assembly.launch_count() - before)
    plain = ControlConfig(qp=cfg.qp._replace(use_kernel=False))
    for t in range(4, 6):
        before = mpc_assembly.launch_count()
        state, tau, _ = runner.min_step(params, plain, state, q,
                                        torch.zeros_like(q), body, commands,
                                        solve_gate=(t % 2 == 1))
        counts.append(mpc_assembly.launch_count() - before)
    torch.cuda.synchronize()
    assert counts == [0, 1, 0, 1, 0, 0]
    assert bool(torch.isfinite(tau).all())

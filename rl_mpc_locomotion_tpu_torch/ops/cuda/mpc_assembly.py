"""The MPC problem of every robot assembled in one CUDA kernel: the A^k B
chain, the gradient, the bounds of the cone rows and the swing mask.

It replaces no TPU kernel: the JAX package assembles the problem in XLA
(``rl_mpc_locomotion_tpu/control/locomotion.py``), which fuses it. In eager
PyTorch the same code is ~215 small launches a solve (13 x 13 batched
products, concatenations, copies, gathers), several times slower than the
bytes it writes; ``csrc/mpc_assembly.cu`` does it in one pass. Its note says
what bounds it on an H100 (the 8.8 KB a robot it writes) and how the design
uses the structure of A (A^3 = 0, so the chain is affine in k).

``assemble_mpc_batch`` launches the kernel for CUDA tensors, or raises; CPU
tensors take ``assemble_mpc_batch_reference``, the plain PyTorch that
``control/locomotion._solve_mpc`` ran before, which is also what the kernel
is compared with. ``launch_count()`` counts kernel launches and nothing
else.
"""
from __future__ import annotations

import ctypes
import math

import torch

from .. import rotations as rot
from .. import srb_dynamics as srb
from . import _build

STATE_DIM, ACTION_DIM = srb.STATE_DIM, srb.ACTION_DIM

# which inputs carry a robot axis (bits of the kernel's ``per_robot``), and
# the size of one robot's value
_SHARED_OR_PER_ROBOT = (("weights", 1, (STATE_DIM,)),
                        ("ground_normal", 2, (3,)),
                        ("body_mass", 4, ()),
                        ("body_inertia", 8, (3, 3)),
                        ("body_height", 16, ()),
                        ("friction", 32, ()))

_launches = 0
_bound = None


def launch_count() -> int:
    """Kernel launches since the last ``reset_launch_count()``."""
    return _launches


def reset_launch_count() -> None:
    global _launches
    _launches = 0


def _library():
    global _bound
    if _bound is None:
        lib = _build.load_library()
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.rlmpc_mpc_assembly.argtypes = (
            [ptr] * 18 + [i32] * 3 + [ctypes.c_float, ptr])
        lib.rlmpc_mpc_assembly.restype = i32
        lib.rlmpc_mpc_assembly_shared_bytes.argtypes = [i32]
        lib.rlmpc_mpc_assembly_shared_bytes.restype = i32
        _bound = lib
    return _bound


def assemble_mpc_batch(rpy, com_z, omega, vel, foot_positions, mpc_table,
                       weights, commands, ground_normal, body_mass,
                       body_inertia, body_height, friction, *,
                       dt_mpc: float, horizon: int):
    """The QP of one MPC solve for the batch, in the layouts that
    ``qp.solve_qp_chain`` and row 1 read.

    Args (float32; B robots, h = ``horizon``):
      rpy, omega, vel: (B,3) body rpy, angular and linear velocity in the
        yaw-aligned ground frame; com_z (B,) the estimated CoM height.
      foot_positions: (B,4,3) feet about the CoM in the body frame.
      mpc_table: (B,h,4) contact table in {0, 1}.
      commands: (B,3) vx, vy, yaw rate.
      weights (13,) | (B,13), ground_normal (3,) | (B,3), body_mass () | (B,),
        body_inertia (3,3) | (B,3,3), body_height () | (B,), friction () |
        (B,): one value for the batch or one a robot.
    Returns:
      s_chain (B,h,13,12) = A_exp^k B_exp; q_vec (B,12h) = 2 B_qp^T Q
      (A_qp x0 - x_des) with A_qp's last block zeroed; lb, ub (B,20h); mask
      (B,12h).

    CUDA tensors go through the kernel on the current stream, without a
    synchronise, or raise; CPU tensors go through the plain version.
    """
    if _build.kernel_device(rpy) == "cpu":
        return assemble_mpc_batch_reference(
            rpy, com_z, omega, vel, foot_positions, mpc_table, weights,
            commands, ground_normal, body_mass, body_inertia, body_height,
            friction, dt_mpc=dt_mpc, horizon=horizon)

    b, h = rpy.shape[0], int(horizon)
    if b < 1 or h < 1:
        raise ValueError(f"need B >= 1 and horizon >= 1, got B={b} h={h}")
    inputs = {"rpy": rpy, "com_z": com_z, "omega": omega, "vel": vel,
              "foot_positions": foot_positions, "mpc_table": mpc_table,
              "weights": weights, "commands": commands,
              "ground_normal": ground_normal, "body_mass": body_mass,
              "body_inertia": body_inertia, "body_height": body_height,
              "friction": friction}
    per_robot, shapes = 0, {}
    for name, bit, shape in _SHARED_OR_PER_ROBOT:
        t = inputs[name]
        if tuple(t.shape) == (b,) + shape:
            per_robot |= bit
        elif t.numel() != math.prod(shape):
            raise ValueError(f"{name}: expected {shape} (one for the batch) "
                             f"or {(b,) + shape}, got {tuple(t.shape)}")
        shapes[name] = tuple(t.shape)
    _build.check_tensors(
        {"rpy": (b, 3), "com_z": (b,), "omega": (b, 3), "vel": (b, 3),
         "foot_positions": (b, 4, 3), "mpc_table": (b, h, 4),
         "commands": (b, 3), **shapes}, inputs)
    if mpc_table.data_ptr() % 16:
        raise ValueError("mpc_table: the kernel reads it in 16-byte words; "
                         "its storage must start 16-byte aligned")
    lib = _library()
    if lib.rlmpc_mpc_assembly_shared_bytes(h) < 0:
        raise ValueError(f"horizon {h} does not fit the kernel's shared "
                         f"memory")
    dev = rpy.device
    outs = tuple(torch.empty(shape, dtype=torch.float32, device=dev)
                 for shape in ((b, h, STATE_DIM, ACTION_DIM), (b, 12 * h),
                               (b, 20 * h), (b, 20 * h), (b, 12 * h)))
    with torch.cuda.device(dev):
        err = lib.rlmpc_mpc_assembly(
            *[t.data_ptr() for t in inputs.values()],
            *[t.data_ptr() for t in outs], b, h, per_robot, float(dt_mpc),
            _build.stream_of(rpy))
    _build.check_launch(err, "mpc_assembly")
    global _launches
    _launches += 1
    return outs


def assemble_mpc_batch_reference(rpy, com_z, omega, vel, foot_positions,
                                 mpc_table, weights, commands, ground_normal,
                                 body_mass, body_inertia, body_height,
                                 friction, *, dt_mpc: float, horizon: int):
    """The kernel's function in plain PyTorch, op for op the code
    ``control/locomotion._solve_mpc`` ran before the kernel: rotations,
    ``build_a_mat`` / ``build_b_mat``, ``discretize_exact``, the chain by
    repeated 13 x 13 products, ``gradient_from_chain``, ``constraint_bounds``
    and the mask. Same arguments and returns as ``assemble_mpc_batch``; any
    dtype the ops take."""
    b = com_z.shape[0]
    dt, dev = com_z.dtype, com_z.device
    zero = torch.zeros_like(com_z)
    com_position = torch.stack([zero, zero, com_z], dim=-1)
    desired_position = torch.stack([zero, zero, body_height.expand(b)],
                                   dim=-1)
    desired_velocity = torch.stack([commands[:, 0], commands[:, 1], zero],
                                   dim=-1)
    desired_rpy = torch.zeros((b, 3), dtype=dt, device=dev)
    desired_omega = torch.stack([zero, zero, commands[:, 2]], dim=-1)

    # Foot positions rotated to world by Rx(r)Ry(p)Rz(y) — the (nonstandard)
    # order the reference solver uses for feet, distinct from the Rz Ry Rx
    # used for the inertia below.
    r_feet = (rot.rot_x(rpy[:, 0]).transpose(-1, -2)
              @ rot.rot_y(rpy[:, 1]).transpose(-1, -2)
              @ rot.rot_z(rpy[:, 2]).transpose(-1, -2))
    foot_world = foot_positions @ r_feet.transpose(-1, -2)

    rotation = rot.rpy_to_rot(rpy).transpose(-1, -2)  # active Rz Ry Rx
    inv_inertia = torch.linalg.inv_ex(body_inertia).inverse
    inv_inertia_world = rotation @ inv_inertia @ rotation.transpose(-1, -2)

    a_mat = srb.build_a_mat(rpy, ground_normal)
    b_mat = srb.build_b_mat(1.0 / body_mass, inv_inertia_world, foot_world)
    a_exp, b_exp = srb.discretize_exact(a_mat, b_mat, dt_mpc)
    # chain-form condensation: B_qp is never materialised; the Hessian is
    # built from the A^k B chain inside row 1 (or by hessian_from_chain on
    # the plain path)
    a_qp, s_chain = srb.condense_chain(a_exp, b_exp, horizon)

    x0 = srb.build_state_vec(rpy, com_position, omega, vel)
    x_des = srb.build_desired_states(rpy, com_position, desired_position,
                                     desired_velocity, desired_rpy,
                                     desired_omega, dt_mpc, horizon)
    q_vec = srb.gradient_from_chain(s_chain, a_qp, x0, x_des, weights,
                                    horizon)
    lb, ub = srb.constraint_bounds(mpc_table, body_mass, friction, horizon)
    # the swing-variable mask is applied inside solve_qp_chain (inside the
    # kernel on the fused path)
    mask = torch.repeat_interleave(mpc_table.reshape(b, -1), 3, dim=1)
    return s_chain, q_vec, lb, ub, mask

"""Batched math core: rotations, gait, Bezier, kinematics, SRB dynamics and
the GRF-QP solver."""

from . import bezier, gait, leg_kinematics, qp, rotations, srb_dynamics  # noqa: F401

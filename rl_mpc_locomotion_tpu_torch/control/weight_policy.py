"""Weight-policy inference for deployment (Policy mode), for a batch.

Counterpart of ``rl_mpc_locomotion_tpu/control/weight_policy.py``: a
trained actor-critic predicts the 12 MPC cost weights online from a 48-wide
observation built from the robot's state; the weights, with a 0 gravity
placeholder appended, feed the MPC. Every function takes a leading batch
axis ``B``.

Observations: the deployment path builds the TRAINING env's layout
(``compute_observations_train_parity``: base pos, body-frame velocities,
commands, dof offsets from the stand pose, dof velocities, previous
action), so a trained checkpoint stays in-distribution. The reference's own
deployment layout, which differs from its training env, is kept as
``compute_observations`` for parity documentation, as in the JAX file.

Actions: clip to [-1, 1], then ``MPC_PARAM_SCALE * a + MPC_PARAM_CONST``.

Parameters: the port's ``ActorCritic`` holds its parameters, so
``policy_params`` is a dict of tensors keyed by parameter name (what
``WeightPolicy.params`` holds) and the forward (``policy_mean``) is
``torch.func.functional_call`` of the actor on them, the counterpart of
flax's ``model.apply(params, obs)``'s mean. Only the actor runs: under
``jax.jit`` the JAX package's unused value head is dropped too. Inference
runs under ``torch.no_grad``: no autograd graph follows the action into the
MPC.

``WeightPolicy(checkpoint)`` loads a checkpoint of the port (``cli train``)
or one of the JAX package's trained runs, through the weights committed
beside this package (``weights/<run>/model_<i>.npz``); a checkpoint it
cannot load raises. It never falls back to a random init, as the JAX class
does: a random policy would then be evaluated as if it were trained.
"""
from __future__ import annotations

import os
from typing import NamedTuple, Optional, Sequence

import torch
from torch.func import functional_call

from ..models.actor_critic import ActorCritic
from ..models.robots import RobotParams
from ..ops import rotations as rot
from . import fsm as fsm_mod
from . import leg_controller, state_estimator
from .runner import _resolve_device
from .types import ControlConfig, ControlState, StateEstimate

# the stand pose; equal to sim/env.DEFAULT_DOF_POS (observation parity),
# kept here because sim imports control
STAND_DOF_POS = torch.tensor([0.0, 0.8, -1.6], dtype=torch.float32).repeat(4)

MPC_PARAM_SCALE = torch.tensor([4, 4, 4, 20, 20, 20, 1, 1, 1, 1, 1, 1],
                               dtype=torch.float32)
MPC_PARAM_CONST = torch.tensor([5, 5, 5, 50, 50, 50, 1, 1, 1, 1, 1, 1],
                               dtype=torch.float32)

# the JAX package's trained runs, converted (tests/test_torch_weight_policy.py)
WEIGHTS_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "weights")
WRITE_WEIGHTS = "python tests/test_torch_weight_policy.py --write-weights"

_consts = {}


def _const(name, device):
    """One of the module's constant vectors on ``device``, copied once."""
    key = (name, torch.device(device))
    if key not in _consts:
        _consts[key] = {"stand": STAND_DOF_POS, "scale": MPC_PARAM_SCALE,
                        "const": MPC_PARAM_CONST}[name].to(device)
    return _consts[key]


class PolicyScales(NamedTuple):
    lin_vel: float = 1.0
    ang_vel: float = 1.0
    dof_pos: float = 1.0
    dof_vel: float = 1.0


def _scaled_commands(commands, scales: PolicyScales):
    return torch.cat([commands[:, :2] * scales.lin_vel,
                      commands[:, 2:] * scales.ang_vel], dim=-1)


def compute_observations(se: StateEstimate, dof_q, dof_qd, commands,
                         prev_action, scales: PolicyScales = PolicyScales()):
    """(B,48) observation in the reference's deployment layout; projected
    gravity is -ground_normal_yaw, as the reference has it."""
    return torch.cat([
        se.v_body * scales.lin_vel,
        se.omega_body * scales.ang_vel,
        -se.ground_normal_yaw,
        _scaled_commands(commands, scales),
        dof_q * scales.dof_pos,
        dof_qd * scales.dof_vel,
        prev_action,
    ], dim=-1)


def compute_observations_train_parity(body_state, dof_q, dof_qd, commands,
                                      prev_action,
                                      scales: PolicyScales = PolicyScales(),
                                      clip_obs: float = 5.0):
    """(B,48) observation in the TRAINING layout (``sim/env.observations``):
    [base pos(3), v_body(3), omega_body(3), commands(3),
     dof_pos - stand(12), dof_vel(12), prev_action(12)], clipped.

    body_state: (B,13) [pos, quat xyzw, linvel, angvel].
    """
    quat = torch.cat([body_state[:, 6:7], body_state[:, 3:6]], dim=-1)
    r_bw = rot.quat_to_rot(quat)
    lin = (r_bw @ body_state[:, 7:10, None])[..., 0] * scales.lin_vel
    ang = (r_bw @ body_state[:, 10:13, None])[..., 0] * scales.ang_vel
    obs = torch.cat([
        body_state[:, 0:3], lin, ang, _scaled_commands(commands, scales),
        (dof_q - _const("stand", dof_q.device)) * scales.dof_pos,
        dof_qd * scales.dof_vel, prev_action], dim=-1)
    return torch.clamp(obs, -clip_obs, clip_obs)


def actions_to_weights(action):
    """(B,12) actions, clipped and rescaled to 12 MPC weights, with the 0
    gravity placeholder appended: (B,13)."""
    dev = action.device
    w = (torch.clamp(action, -1.0, 1.0) * _const("scale", dev)
         + _const("const", dev))
    return torch.cat([w, torch.zeros_like(w[:, :1])], dim=-1)


def policy_mean(model: ActorCritic, policy_params: dict, obs):
    """The policy's deterministic action (B,12): the actor of ``model``
    applied with ``policy_params`` (names as ``model.named_parameters()``
    gives them), without autograd."""
    actor = {k[len("actor."):]: v for k, v in policy_params.items()
             if k.startswith("actor.")}
    with torch.no_grad():
        return functional_call(model.actor, actor, (obs,))


def policy_step(model: ActorCritic, policy_params: dict, body_state,
                dof_q, dof_qd, commands, prev_action,
                scales: PolicyScales = PolicyScales()):
    """Deterministic inference -> (weights (B,13), raw action (B,12)), on
    training-layout observations (see the module docstring)."""
    obs = compute_observations_train_parity(body_state, dof_q, dof_qd,
                                            commands, prev_action, scales)
    mean = policy_mean(model, policy_params, obs)
    return actions_to_weights(mean), mean


def policy_fsm_step(params: RobotParams, cfg: ControlConfig,
                    model: ActorCritic, policy_params: dict,
                    state: ControlState, prev_action, dof_q, dof_qd,
                    body_state, commands, gait_id, control_mode,
                    passive_iter, solve_gate: Optional[bool] = None):
    """One Policy-mode tick for the batch: the FSM with the policy's MPC
    weights (the reference's RobotRunnerPolicy.run).

    ``solve_gate`` is the batch's QP gate as a Python bool (or None), as for
    ``runner.fsm_step``: a batched caller reads ``fsm.solve_gate(cfg,
    state)`` back once a tick. Returns (new_state, torques (B,12),
    new_prev_action (B,12), new_passive_iter, metrics).
    """
    leg_data = leg_controller.update_data(params, dof_q, dof_qd)
    se = state_estimator.update(state.est, body_state)
    weights, action = policy_step(model, policy_params, body_state, dof_q,
                                  dof_qd, commands, prev_action)
    new_state, cmds, passive_iter, metrics = fsm_mod.fsm_step(
        params, cfg, state, se, leg_data, commands, weights, gait_id,
        control_mode, passive_iter, solve_gate)
    torques = leg_controller.compute_torques(cmds, leg_data)
    metrics["policy_action"] = action
    return new_state, torques, action, passive_iter, metrics


def _is_orbax(path: str) -> bool:
    return os.path.isfile(os.path.join(path, "_CHECKPOINT_METADATA"))


def _resolve_checkpoint(checkpoint: str):
    """(kind, path) of what ``checkpoint`` names: ``("port", file)`` for a
    checkpoint of the port, ``("npz", file)`` for a JAX run's converted
    weights. A run directory means its latest model_<i>. Raises on anything
    else."""
    from ..utils.checkpoint import latest_checkpoint

    path = os.path.abspath(checkpoint)
    if os.path.isdir(path) and not _is_orbax(path):
        path = latest_checkpoint(path) or path
    if os.path.isfile(path):
        return "port", path
    if _is_orbax(path):
        run = os.path.basename(os.path.dirname(path))
        npz = os.path.join(WEIGHTS_DIR, run, os.path.basename(path) + ".npz")
        if os.path.isfile(npz):
            return "npz", npz
        raise FileNotFoundError(
            f"{checkpoint!r} is a JAX (orbax) checkpoint without converted "
            f"weights at {npz}; convert it where the JAX package and orbax "
            f"are installed: {WRITE_WEIGHTS}")
    raise FileNotFoundError(
        f"{checkpoint!r} is neither a checkpoint of this package (a model_<i> "
        "file or a run directory of them, as cli train writes) nor a JAX run "
        f"with weights converted by {WRITE_WEIGHTS}")


class WeightPolicy:
    """A trained (or, with no checkpoint, freshly initialised) policy for
    deployment: ``model`` (the ``ActorCritic``) and ``params`` (its
    parameters by name) on ``device`` (None: the GPU)."""

    def __init__(self, checkpoint: Optional[str] = None,
                 hidden: Sequence[int] = (512, 256, 128), num_obs: int = 48,
                 device=None):
        """``num_obs``: the observation width the checkpoint was trained
        with (48, or 48 + 3 for a robot-one-hot conditioned policy,
        ``sim/env.num_obs``). A JAX run's weights give their own widths."""
        from ..utils import convert, seeding

        dev = _resolve_device(device)
        self.source = None
        if checkpoint is None:
            self.model = ActorCritic(num_actions=12, hidden=hidden,
                                     num_obs=num_obs).to(dev)
            self.model.reset_parameters(seeding.key(0, dev))
        else:
            kind, self.source = _resolve_checkpoint(checkpoint)
            if kind == "npz":
                self.model = convert.actor_critic_from_flax(
                    convert.flax_params_from_npz(self.source), dev)
            else:
                from ..utils.checkpoint import restore_model
                self.model = ActorCritic(num_actions=12, hidden=hidden,
                                         num_obs=num_obs).to(dev)
                restore_model(self.source, self.model)
        if self.model.num_obs != num_obs:
            raise ValueError(
                f"{checkpoint!r} takes {self.model.num_obs} observations, "
                f"not {num_obs}")
        self.num_obs = num_obs
        self.params = {k: v.detach()
                       for k, v in self.model.named_parameters()}

    def step_batch(self, pstate, cstate, commands, prev_action=None):
        """Physics and control states of a batch -> ((B,13) weights, (B,12)
        action). ``commands`` (3,) for every robot or (B,3).

        ``prev_action`` is the previous tick's raw action (B,12): the
        training observation holds it, so deployment feeds the true value
        (zeros when None)."""
        from ..sim import physics

        batch = pstate.q.shape[0]
        if prev_action is None:
            prev_action = torch.zeros((batch, 12), dtype=torch.float32,
                                      device=pstate.q.device)
        commands = torch.as_tensor(commands, dtype=torch.float32,
                                   device=pstate.q.device).expand(batch, 3)
        body = physics.root_state_vector(pstate)
        return policy_step(self.model, self.params, body, pstate.q,
                           pstate.qd, commands, prev_action)

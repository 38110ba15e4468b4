"""Command-line entry points of the port: ``play``, ``train``, ``bench`` and
``eval``.

  python -m rl_mpc_locomotion_tpu_torch.cli play --robot Aliengo --mode Min \
      --num-envs 4 --gait trot --vx 0.5 --seconds 5
  python -m rl_mpc_locomotion_tpu_torch.cli train --task Aliengo \
      --num-envs 4096 --max-iterations 1000 --checkpoint runs/aliengo
  python -m rl_mpc_locomotion_tpu_torch.cli bench --batch 4096
  python -m rl_mpc_locomotion_tpu_torch.cli bench --batch 64 --device cpu

``play`` runs a batch of robots in closed loop, controller against the
batched physics (``sim/physics``), headless, in ``Min``, ``Fsm`` or
``Policy`` mode (the FSM with the MPC weights of a trained policy,
``--checkpoint``), and prints env 0's state every ``--log-every`` ticks and
a ``[play]`` summary line. ``bench`` runs ``bench.bench``: a batch of robots
in lockstep through ``runner.min_step`` under the production QP
configuration, two control ticks an MPC period, the second gated to solve
one QP a robot. It prints one JSON line: the period, or with ``--profile``
where the period goes on the card (the sweeps are
``python -m rl_mpc_locomotion_tpu_torch.bench``). ``train`` trains the MPC
weight policy with PPO (``rl/train``) under the production QP
configuration, so the fused chain-QP kernel runs in every rollout on the
card; ``--device cpu`` runs the plain versions. ``train --multi-device``
splits the env batch over the processes of a ``torch.distributed`` group,
one card each (``parallel/distributed``), as ``torchrun`` starts them:

  torchrun --nproc-per-node 4 -m rl_mpc_locomotion_tpu_torch.cli train \
      --multi-device --num-envs 16384

and runs on one card (a group of one) without ``torchrun``.
``eval`` runs the A/B of a trained weight policy against the default MPC
weights (``rl/evaluate.ab_compare``) under the production QP configuration,
so the fused chain-QP kernel runs in both arms on the card, and prints (and
with ``--out`` writes) the JSON result:

  python -m rl_mpc_locomotion_tpu_torch.cli play --mode Policy \
      --checkpoint artifacts/aliengo_weight_policy --num-envs 64 --seconds 5
  python -m rl_mpc_locomotion_tpu_torch.cli eval \
      --checkpoint artifacts/aliengo_weight_policy --num-envs 4096 \
      --out ab.json

A checkpoint is a run directory or a model_<i> of ``cli train``, or one of
the JAX package's trained runs under ``artifacts/``, read from the weights
converted beside the package (``weights/<run>/model_<i>.npz``).
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from .control import fsm as fsm_mod
from .control import runner
from .control.types import ControlConfig
from .models import robots
from .ops.qp import production_qp_config
from .sim import physics, terrain

GAIT_IDS = {"trot": 0, "bound": 1, "pronk": 2, "pace": 3, "gallop": 5,
            "walk": 6, "trotrun": 7}
MODES = ("Min", "Fsm", "Policy")
TERRAINS = ("flat", "slope", "stairs", "rough", "uneven")


def cmd_bench(args):
    """``bench.bench`` (or ``bench.profile``) at ``--batch``."""
    from . import bench as bench_mod
    if args.profile:
        if args.device not in (None, "cuda"):
            raise SystemExit("bench --profile traces the GPU; it takes no "
                             "--device other than cuda")
        print(json.dumps(bench_mod.profile(batch=args.batch)))
        return
    print(json.dumps(bench_mod.bench(batch=args.batch, iters=args.periods,
                                     device=args.device)))


def _make_terrain(name: str, device):
    return {
        "flat": terrain.flat,
        "slope": terrain.slope_platform,
        "stairs": terrain.stairs,
        "rough": terrain.random_uniform,
        "uneven": terrain.uneven_patches,
    }[name](device=device)


def gamepad_tick_update(gamepad):
    """One gamepad poll a tick: (commands (3,) float32, gait_id,
    control_mode, estop). The e-stop is the latched ``estop_flagged``
    (LB+RB), not part of the command vector."""
    commands = gamepad.get_command()
    return (np.asarray(commands, np.float32), int(gamepad.get_gait()),
            int(gamepad.get_mode()), bool(gamepad.estop_flagged))


TELEMETRY_FIELDS = (["tick", "x", "y", "z", "vx", "com_z_est", "mpc_loss"]
                    + [f"f_{leg}{a}" for leg in range(4) for a in "xyz"])


def cmd_play(args):
    """Closed-loop play: ``Min`` (MPC only), ``Fsm`` (the state machine,
    starting in recovery stand and commanded to locomotion) or ``Policy``
    (the FSM with the MPC weights predicted by a trained weight policy,
    ``--checkpoint``). The solve gate of a Min tick follows the batch's
    aligned counters (every second tick); an Fsm or Policy tick reads
    ``fsm.solve_gate`` back, one bool a tick, as it reads the unsafe flag.
    ``--telemetry`` writes env 0's frame every tick through the native
    logger, ``--gamepad`` takes the commands, gait and mode from a
    joystick. ``--render`` records env 0 every tick (one copy to the host a
    tick, the only flag that reads state back every tick) and renders the
    animation at the end; it needs matplotlib and fails before the first
    tick without it."""
    render_frames = None
    if args.render:
        from .utils import viewer
        viewer.require_matplotlib()
        render_frames = []
    dev = runner._resolve_device(args.device)
    on_gpu = dev.type == "cuda"
    params = {"aliengo": robots.aliengo_params, "go1": robots.go1_params,
              "a1": robots.a1_params}[args.robot.lower()](dev)
    cfg = ControlConfig(flat_ground=(args.terrain == "flat"))
    pcfg = physics.PhysicsConfig()
    ter = _make_terrain(args.terrain, dev)
    gait_id = GAIT_IDS[args.gait.lower()]
    n = args.num_envs
    commands = torch.tensor([args.vx, args.vy, args.yaw_rate],
                            dtype=torch.float32, device=dev).repeat(n, 1)
    q0 = torch.tensor([0.0, 0.8, -1.6], device=dev).repeat(4)
    pstate = physics.init_state(params, q0, params.body_height + 0.03, n, dev)
    cstate = runner.init_state(params, cfg, batch=n, device=dev)
    passive_iters = torch.zeros(n, dtype=torch.int32, device=dev)
    policy = None
    if args.mode == "Policy":
        from .control.weight_policy import WeightPolicy, policy_fsm_step
        policy = WeightPolicy(checkpoint=args.checkpoint, device=dev)
        print(f"[play] policy from {policy.source or 'a random init'}")
        prev_action = torch.zeros((n, 12), dtype=torch.float32, device=dev)

    telemetry = None
    if args.telemetry:
        from .utils.native_runtime import TelemetryLogger
        telemetry = TelemetryLogger(args.telemetry,
                                    frame_size=len(TELEMETRY_FIELDS),
                                    field_names=TELEMETRY_FIELDS)
        print(f"[play] telemetry to {args.telemetry} "
              f"({'native' if telemetry.available else 'Python'} logger)")
    gamepad = None
    if args.gamepad:
        from .utils.native_runtime import Gamepad
        gamepad = Gamepad()
        if not gamepad.connected:
            print("[play] no gamepad at /dev/input/js0 — using scripted "
                  "commands")
            gamepad = None

    # unsafe handling: on the locomotion-unsafe flag, command RECOVERY_STAND
    # for two seconds, then restore locomotion
    control_mode = fsm_mod.LOCOMOTION
    recovery_until = -1
    ticks = int(args.seconds / cfg.dt)
    t0 = time.time()
    for t in range(ticks):
        if gamepad is not None:
            cmd, gait_id, control_mode, estop = gamepad_tick_update(gamepad)
            if estop:
                print("[play] e-stop (LB+RB)")
                break
            commands = torch.as_tensor(cmd, device=dev).repeat(n, 1)
        body = physics.root_state_vector(pstate)
        if args.mode == "Min":
            cstate, tau, metrics = runner.min_step(
                params, cfg, cstate, pstate.q, pstate.qd, body, commands,
                gait_id=gait_id,
                solve_gate=(t + 1) % cfg.iterations_between_mpc == 0)
        else:
            gate = bool(fsm_mod.solve_gate(cfg, cstate))
            if policy is not None:
                cstate, tau, prev_action, passive_iters, metrics = \
                    policy_fsm_step(params, cfg, policy.model, policy.params,
                                    cstate, prev_action, pstate.q, pstate.qd,
                                    body, commands, gait_id, control_mode,
                                    passive_iters, solve_gate=gate)
            else:
                cstate, tau, passive_iters, metrics = runner.fsm_step(
                    params, cfg, cstate, passive_iters, pstate.q, pstate.qd,
                    body, commands, gait_id=gait_id,
                    control_mode=control_mode, solve_gate=gate)
        pstate, _, _ = physics.step(params, pcfg, ter, pstate, tau)
        if args.mode != "Min":
            unsafe = bool(cstate.fsm.locomotion_unsafe.any())
            if unsafe and t > recovery_until:
                print(f"[play] t={t * cfg.dt:.2f}s locomotion unsafe -> "
                      "RECOVERY_STAND")
                control_mode = fsm_mod.RECOVERY_STAND
                recovery_until = t + int(2.0 / cfg.dt)
                cstate = cstate._replace(fsm=cstate.fsm._replace(
                    locomotion_unsafe=torch.zeros_like(
                        cstate.fsm.locomotion_unsafe)))
            elif t == recovery_until:
                control_mode = fsm_mod.LOCOMOTION
        if telemetry is not None:
            # env 0's frame, one copy to the host
            frame = torch.cat([
                torch.tensor([float(t)], device=dev), pstate.pos[0],
                pstate.v[0, :1], metrics["com_z"][0].reshape(1),
                metrics["mpc_loss"][0].reshape(1),
                metrics["f_ff"][0].reshape(-1)]).cpu().numpy()
            telemetry.push(frame)
        if render_frames is not None:
            render_frames.append(viewer.record_frame(
                params, type(pstate)(*(x[0:1] for x in pstate))))
        if t % args.log_every == 0:
            pos = pstate.pos[0].tolist()
            print(f"t={t * cfg.dt:6.2f}s  env0 pos="
                  f"[{pos[0]:+.2f} {pos[1]:+.2f} {pos[2]:+.3f}] "
                  f"vx={float(pstate.v[0, 0]):+.2f} "
                  f"com_z={float(metrics['com_z'][0]):.3f}")
    if on_gpu:
        torch.cuda.synchronize(dev)
    wall = time.time() - t0
    if telemetry is not None:
        telemetry.flush()
        telemetry.close()
        print(f"[play] telemetry written to {args.telemetry}")
    if render_frames:
        out = viewer.render(render_frames, ter, args.render, dt=cfg.dt)
        print(f"[play] animation written to {out}")
    # speed factor: simulated seconds per wall second (>1 = faster than RT)
    rt = ticks * cfg.dt / wall
    print(f"[play] {ticks} ticks x {n} envs in {wall:.1f}s "
          f"({ticks * n / wall:.0f} robot-ticks/s, {rt:.2f}x real-time — "
          f"{'faster' if rt >= 1.0 else 'slower'} than real-time) on "
          f"{torch.cuda.get_device_name(dev) if on_gpu else 'cpu'}")


def yaml_scalar(text: str):
    """Parse a CLI override value with YAML scalar rules ('3'->int, etc.)."""
    import yaml
    return yaml.safe_load(text)


def cmd_train(args):
    """PPO training of the weight policy (``rl/train.train``)."""
    import dataclasses

    from .rl import train as train_mod
    from .rl.ppo import PPOConfig
    from .sim.env import EnvConfig
    from .utils.profiling import device_trace
    from .utils.seeding import set_seed

    set_seed(args.seed)  # host-side generators; the device's come from
    # utils/seeding.key(cfg.seed) inside train()
    dev = runner._resolve_device(args.device)
    mesh = None
    if args.multi_device:
        # one process a card: the env batch splits over the group's ranks
        from .parallel import distributed
        distributed.initialize(
            backend="gloo" if dev.type == "cpu" else "nccl")
        if dev.type == "cuda":
            dev = distributed.local_device()
        mesh = distributed.global_env_mesh(dev.type)
    if args.robots:
        # heterogeneous batch: the listed robots cycled over the envs
        ids = [robots.ROBOT_NAMES[r.strip().lower()]
               for r in args.robots.split(",")]
        ids = (ids * (args.num_envs // len(ids) + 1))[:args.num_envs]
        params = train_mod.stacked_robot_params(ids, dev)
    else:
        params = {"aliengo": robots.aliengo_params, "go1": robots.go1_params,
                  "a1": robots.a1_params}[args.task.lower()](dev)
    dr = None
    if args.dr:
        from .sim.randomize import DomainRandomization
        dr = DomainRandomization()
    cfg = train_mod.TrainConfig(
        num_envs=args.num_envs,
        max_iterations=args.max_iterations or 5000,
        seed=args.seed,
        ppo=PPOConfig(),
        # non-flat terrain turns on the slope-aware MPC path (plane-fit
        # ground normal), the reference's default training condition
        env=EnvConfig(control=ControlConfig(
            qp=production_qp_config(), flat_ground=(args.terrain == "flat")),
            dr=dr),
    )
    overrides = {k: yaml_scalar(v)
                 for k, v in (kv.split("=", 1) for kv in args.override)}
    if args.config:
        from .utils.config import load_config
        cfg = load_config(cfg, args.config, overrides)
        if isinstance(cfg.env.dr, dict):
            # YAML spec-dict -> DomainRandomization
            from .sim.randomize import from_dict
            cfg = dataclasses.replace(cfg, env=dataclasses.replace(
                cfg.env, dr=from_dict(cfg.env.dr)))
    elif overrides:
        from .utils.config import apply_overrides
        cfg = apply_overrides(cfg, overrides)
    resume_from = args.resume
    if resume_from == "":  # bare --resume: latest run in the save dir
        if not args.checkpoint:
            raise SystemExit("--resume without a path needs --checkpoint")
        resume_from = args.checkpoint
    try:
        with device_trace(args.profile_dir):
            train_mod.train(params, cfg, _make_terrain(args.terrain, dev),
                            mesh=mesh, checkpoint_dir=args.checkpoint,
                            log_dir=args.log_dir,
                            max_iterations=args.max_iterations,
                            resume_from=resume_from, device=dev)
    finally:
        if mesh is not None:
            distributed.shutdown()


def cmd_eval(args):
    """A/B eval: a trained weight policy against the default MPC weights."""
    from .control.weight_policy import WeightPolicy
    from .rl import evaluate as eval_mod
    from .sim.env import EnvConfig, num_obs

    dev = runner._resolve_device(args.device)
    params = {"aliengo": robots.aliengo_params, "go1": robots.go1_params,
              "a1": robots.a1_params}[args.task.lower()](dev)
    dr = None
    if args.dr:
        from .sim.randomize import DomainRandomization
        dr = DomainRandomization()
    cfg = EnvConfig(control=ControlConfig(
        qp=production_qp_config(), flat_ground=(args.terrain == "flat")),
        dr=dr, obs_robot_id=args.obs_robot_id)
    policy = WeightPolicy(checkpoint=args.checkpoint, num_obs=num_obs(cfg),
                          device=dev)
    sweep = None
    if args.sweep:
        sweep = [(0.5, 0.0, 0.0), (1.0, 0.0, 0.0), (-0.5, 0.0, 0.0),
                 (0.0, 0.5, 0.0), (0.5, 0.0, 0.5), (1.5, 0.0, 0.0)]
    seeds = (tuple(int(s) for s in args.seeds.split(",")) if args.seeds
             else None)
    res = eval_mod.ab_compare(params, cfg, _make_terrain(args.terrain, dev),
                              policy.params, policy.model,
                              num_envs=args.num_envs,
                              num_steps=int(args.seconds / cfg.control.dt),
                              seed=args.seed, command_sweep=sweep,
                              seeds=seeds)
    print(json.dumps(res, indent=1))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(res, f, indent=1)
        print(f"[eval] written to {args.out}")


def main(argv=None):
    p = argparse.ArgumentParser(
        prog="rl_mpc_locomotion_tpu_torch",
        description="PyTorch/CUDA port of the quadruped RL+MPC stack")
    sub = p.add_subparsers(dest="cmd", required=True)
    pp = sub.add_parser("play", help="run controllers in the batched sim")
    pp.add_argument("--robot", default="Aliengo",
                    choices=["Aliengo", "A1", "Go1", "aliengo", "a1", "go1"])
    pp.add_argument("--mode", default="Min", choices=MODES)
    pp.add_argument("--num-envs", type=int, default=1)
    pp.add_argument("--gait", default="trot", choices=list(GAIT_IDS))
    pp.add_argument("--terrain", default="flat", choices=TERRAINS)
    pp.add_argument("--vx", type=float, default=0.5)
    pp.add_argument("--vy", type=float, default=0.0)
    pp.add_argument("--yaw-rate", type=float, default=0.0)
    pp.add_argument("--seconds", type=float, default=5.0)
    pp.add_argument("--log-every", type=int, default=50)
    pp.add_argument("--checkpoint", default=None,
                    help="Policy mode: a run directory or model_<i> of "
                         "cli train, or a JAX run under artifacts/ (default: "
                         "random init)")
    pp.add_argument("--telemetry", default=None, metavar="PATH",
                    help="write env 0's telemetry every tick (native logger)")
    pp.add_argument("--render", default=None, metavar="GIF",
                    help="record env 0 and render a skeleton animation "
                         "(.gif or .mp4; needs matplotlib)")
    pp.add_argument("--gamepad", action="store_true",
                    help="drive commands from /dev/input/js0 (native reader)")
    pp.add_argument("--device", default=None,
                    help="default: the GPU; 'cpu' runs the plain versions")
    pp.set_defaults(fn=cmd_play)
    pt = sub.add_parser("train", help="PPO weight-policy training")
    pt.add_argument("--task", default="Aliengo")
    pt.add_argument("--robots", default=None, metavar="LIST",
                    help="comma list for a heterogeneous batch, e.g. "
                         "'aliengo,go1,a1' (cycled over --num-envs; "
                         "overrides --task)")
    pt.add_argument("--config", default=None, metavar="YAML",
                    help="TrainConfig YAML overlay (e.g. cfg/aliengo.yaml)")
    pt.add_argument("--override", action="append", default=[],
                    metavar="KEY=VAL",
                    help="dotted config override, e.g. ppo.learning_rate=3e-4")
    pt.add_argument("--num-envs", type=int, default=512)
    pt.add_argument("--max-iterations", type=int, default=None,
                    help="PPO iterations (default 5000; YAML/--override win "
                         "when this flag is omitted)")
    pt.add_argument("--seed", type=int, default=1)
    # default rough: the reference trains on random-uniform terrain with the
    # slope-aware MPC path on
    pt.add_argument("--terrain", default="rough", choices=TERRAINS)
    pt.add_argument("--dr", action="store_true",
                    help="enable domain randomisation (per-env friction/"
                         "mass/damping/contact-stiffness draws)")
    pt.add_argument("--checkpoint", default=None, metavar="DIR",
                    help="save model_<i> checkpoints here")
    pt.add_argument("--resume", nargs="?", const="", default=None,
                    metavar="PATH",
                    help="resume from a checkpoint (model_<i> path or run "
                         "dir; bare --resume uses the --checkpoint dir)")
    pt.add_argument("--multi-device", action="store_true",
                    help="split --num-envs over the processes of a "
                         "torch.distributed group, one card each (torchrun); "
                         "a group of one without torchrun")
    pt.add_argument("--log-dir", default=None, metavar="DIR",
                    help="write metrics.jsonl + TensorBoard scalars here")
    pt.add_argument("--profile-dir", default=None, metavar="DIR",
                    help="write a torch.profiler trace of the run here")
    pt.add_argument("--device", default=None,
                    help="default: the GPU; 'cpu' runs the plain versions")
    pt.set_defaults(fn=cmd_train)
    pb = sub.add_parser("bench", help="MPC solves/s benchmark")
    pb.add_argument("--batch", type=int, default=4096)
    pb.add_argument("--periods", type=int, default=100)
    pb.add_argument("--device", default=None,
                    help="default: the GPU; 'cpu' runs the plain versions")
    pb.add_argument("--profile", action="store_true",
                    help="trace a few periods on the GPU with torch.profiler "
                         "instead of timing")
    pb.set_defaults(fn=cmd_bench)
    pe = sub.add_parser("eval", help="A/B: trained policy vs default weights")
    pe.add_argument("--task", default="Aliengo")
    pe.add_argument("--checkpoint", default=None,
                    help="a run directory or model_<i> of cli train, or a "
                         "JAX run under artifacts/ (default: random init)")
    pe.add_argument("--num-envs", type=int, default=64)
    pe.add_argument("--seconds", type=float, default=5.0)
    pe.add_argument("--seed", type=int, default=0)
    pe.add_argument("--seeds", default=None, metavar="S0,S1,...",
                    help="multi-seed eval: comma list; reports mean+-95%% CI")
    pe.add_argument("--obs-robot-id", action="store_true",
                    help="robot-one-hot conditioned checkpoint (obs 48+3)")
    pe.add_argument("--terrain", default="flat", choices=TERRAINS)
    pe.add_argument("--dr", action="store_true",
                    help="evaluate under domain randomisation")
    pe.add_argument("--sweep", action="store_true",
                    help="also run a fixed command sweep")
    pe.add_argument("--out", default=None, metavar="JSON",
                    help="write results here")
    pe.add_argument("--device", default=None,
                    help="default: the GPU; 'cpu' runs the plain versions")
    pe.set_defaults(fn=cmd_eval)
    args = p.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()

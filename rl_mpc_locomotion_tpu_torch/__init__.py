"""rl_mpc_locomotion_tpu_torch — the PyTorch / CUDA port of
``rl_mpc_locomotion_tpu`` for one NVIDIA H100.

Same layout and function names as the JAX package, every function written
with a leading batch axis instead of ``vmap``:

- ``ops``      rotations, gait phase arithmetic, Bezier swing trajectories,
               leg kinematics, SRB dynamics condensation, the batched ADMM
               GRF-QP solver; ``ops/cuda`` holds the wrappers of the
               hand-written CUDA kernels and their plain PyTorch versions.
- ``csrc``     the CUDA C++ sources, compiled at first use.
- ``models``   robot constants (A1/Go1/Aliengo), the actor-critic policy.
- ``control``  state estimator, locomotion planner, leg controller, the
               control FSM, the Min- and FSM-mode runners.
- ``sim``      heightfield terrain, batched physics, domain randomisation,
               the RL environment.
- ``rl``       PPO (rollout, GAE, the clipped update with the adaptive
               lr) and the training loop over the env.
- ``parallel`` the env axis's name (one card; no mesh yet).
- ``utils``    converters between the two packages' state containers and
               policies, checkpoints, YAML configs, metrics, seeding,
               timers and traces.
- ``cli``      ``play``, ``train``, ``bench``.

The package imports ``torch`` and never ``jax`` nor the JAX package. Entry
points run on the GPU unless ``device="cpu"`` is passed.
"""

__version__ = "0.1.0"

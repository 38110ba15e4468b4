"""Batched control stack: estimator, locomotion planner, leg controller,
Min-mode runner."""

from . import leg_controller, locomotion, runner, state_estimator, types  # noqa: F401

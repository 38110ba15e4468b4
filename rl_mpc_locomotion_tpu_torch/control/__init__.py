"""Batched control stack: estimator, locomotion planner, leg controller,
the control FSM, the Min- and FSM-mode runners."""

from . import (fsm, leg_controller, locomotion, runner,  # noqa: F401
               state_estimator, types)

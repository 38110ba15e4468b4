"""The measuring and campaign scripts:
``python -m rl_mpc_locomotion_tpu_torch.scripts.<name>`` (``qp_budget_sweep``,
``envelope_sweep``, ``plot_telemetry``, ``multidev_scaling``,
``run_campaigns``, ``extend_and_select``, ``eval_only``)."""

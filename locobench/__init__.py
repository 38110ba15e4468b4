"""The benchmark of rl_mpc_locomotion_tpu_torch: its harness, traffic,
configurations, plain reference and per-layer readers."""

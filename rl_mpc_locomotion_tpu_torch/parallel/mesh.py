"""The env axis's name, as ``rl_mpc_locomotion_tpu/parallel/mesh.py`` names
it. The port targets one card: the mesh, sharding and gradient reduction
over several are ROADMAP Queue A item 10."""

ENV_AXIS = "env"

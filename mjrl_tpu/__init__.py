"""mjrl_tpu — an on-device on-policy RL framework in JAX.

A from-scratch rebuild of the capabilities of ``bennevans/mjrl`` (NPG / TRPO /
PPO with conjugate-gradient Fisher-vector products and KL line search,
Gaussian-MLP policies, GAE with linear/quadratic/MLP value-function baselines,
behavior cloning, DAPG demo-augmented learning), designed for JAX/XLA:

- env rollouts are ``vmap``-ed over thousands of env instances inside a
  time-major ``lax.scan`` (replacing mjrl's per-process CPU sampling,
  reference: mjrl/samplers/core.py),
- the full sample -> GAE -> natural-gradient iteration fuses into a single
  jitted SPMD program,
- multi-host scale-out shards the env axis over a ``jax.sharding.Mesh`` with
  XLA-emitted collectives for gradient and FVP reductions.

The public concept names follow mjrl (``train_step``, ``baseline.fit``,
metric keys like ``running_score``/``kl_dist``/``alpha``) so learning-curve
parity tooling can read both frameworks' logs side by side.
"""

__version__ = "0.1.0"

import jax as _jax

# Physics correctness requires full f32 contractions. On NVIDIA GPUs from
# Ampere on, XLA's default lets f32 matmuls run in TF32 (about 3
# significant digits), which corrupts the engine's small einsums
# (rotations, inertia products) and the SoA/engine parity. "float32" keeps
# TF32 off for the whole process; chip_smoke.py checks the setting.
# Re-override after import if you know what you're doing.
_jax.config.update("jax_default_matmul_precision", "float32")

from mjrl_tpu.types import EnvSpec, TrajectoryBatch  # noqa: F401

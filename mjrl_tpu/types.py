"""Core data types: the batched trajectory pytree and env specs.

The reference passes data between layers as variable-length "path" dicts
(``{observations (T,do), actions (T,da), rewards (T,), agent_infos, ...}``,
reference: mjrl/samplers/core.py + mjrl/utils/process_samples.py). A
variable-length list of dicts cannot live under ``jit``; the equivalent wire
format here is a fixed-shape, mask-padded batch of trajectories
(``TrajectoryBatch``) laid out env-major ``(num_envs, horizon, ...)`` so the
env axis can be sharded over a device mesh.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import jax
import jax.numpy as jnp


def _pytree_dataclass(cls):
    """Register a dataclass as a JAX pytree (all fields are children)."""
    cls = dataclasses.dataclass(frozen=True)(cls)
    fields = [f.name for f in dataclasses.fields(cls)]
    return jax.tree_util.register_dataclass(cls, data_fields=fields, meta_fields=[])


@dataclasses.dataclass(frozen=True)
class EnvSpec:
    """Static env metadata (reference: EnvSpec in mjrl/utils/gym_env.py).

    Attributes:
      observation_dim: flat observation size.
      action_dim: flat action size.
      horizon: default episode horizon (max steps per episode).
    """

    observation_dim: int
    action_dim: int
    horizon: int


@_pytree_dataclass
class TrajectoryBatch:
    """A fixed-shape batch of (possibly padded) trajectories.

    Shapes: ``N`` envs/trajectories, ``T`` time steps.

    - ``observations (N, T, do)``: obs the action was taken from.
    - ``actions (N, T, da)``
    - ``rewards (N, T)``
    - ``valid (N, T)`` bool: step is inside an episode (padding after early
      termination is invalid). All masked statistics use this.
    - ``done (N, T)`` bool: step ``t`` is the LAST valid step of an episode
      (either terminated or truncated at that step). With auto-reset sampling a
      single row can contain several episodes, so ``done`` may be true at
      multiple ``t``.
    - ``terminated (N, T)`` bool: the episode ending at step ``t`` ended in a
      true environment termination (no bootstrap), as opposed to a horizon
      truncation. Mirrors the reference's per-path ``terminated`` flag
      (mjrl/samplers/core.py do_rollout).
    - ``mean (N, T, da)``, ``log_std (N, T, da)``: the behavior policy's
      distribution parameters at sampling time (reference: ``agent_infos``).
    - ``log_prob (N, T)``: behavior log-likelihood of the sampled action.
    - ``time (N, T)`` int32: timestep index within the episode (for the
      baselines' time features, reference: mjrl/baselines/linear_baseline.py).
    - ``returns / baseline / advantages (N, T)``: filled by post-processing
      (reference: mjrl/utils/process_samples.py); zeros until computed.
    - ``env_info``: dict of extra per-step arrays (e.g. success flags).
    """

    observations: jax.Array
    actions: jax.Array
    rewards: jax.Array
    valid: jax.Array
    done: jax.Array
    terminated: jax.Array
    mean: jax.Array
    log_std: jax.Array
    log_prob: jax.Array
    time: jax.Array
    returns: jax.Array
    baseline: jax.Array
    advantages: jax.Array
    env_info: Dict[str, jax.Array]

    @property
    def num_envs(self) -> int:
        return self.rewards.shape[0]

    @property
    def horizon(self) -> int:
        return self.rewards.shape[1]

    @property
    def num_valid(self) -> jax.Array:
        """Total number of valid transitions (scalar)."""
        return jnp.sum(self.valid.astype(jnp.float32))

    def replace(self, **kwargs: Any) -> "TrajectoryBatch":
        return dataclasses.replace(self, **kwargs)

    def flatten_valid(self) -> Dict[str, jax.Array]:
        """Concatenated (N*T, ...) views plus the valid mask.

        Fixed-shape equivalent of the reference's
        ``np.concatenate([p["observations"] for p in paths])`` pattern
        (mjrl/algos/batch_reinforce.py train_from_paths) — consumers weight by
        ``valid`` instead of physically dropping padded steps.
        """
        n = self.num_envs * self.horizon
        return dict(
            observations=self.observations.reshape(n, -1),
            actions=self.actions.reshape(n, -1),
            advantages=self.advantages.reshape(n),
            valid=self.valid.reshape(n),
        )


def zeros_trajectory_batch(
    num_envs: int,
    horizon: int,
    obs_dim: int,
    act_dim: int,
    env_info: Optional[Dict[str, jax.Array]] = None,
) -> TrajectoryBatch:
    """An all-zeros batch with the canonical shapes/dtypes (for init/tests)."""
    f = jnp.zeros
    return TrajectoryBatch(
        observations=f((num_envs, horizon, obs_dim)),
        actions=f((num_envs, horizon, act_dim)),
        rewards=f((num_envs, horizon)),
        valid=jnp.ones((num_envs, horizon), dtype=bool),
        done=jnp.zeros((num_envs, horizon), dtype=bool),
        terminated=jnp.zeros((num_envs, horizon), dtype=bool),
        mean=f((num_envs, horizon, act_dim)),
        log_std=f((num_envs, horizon, act_dim)),
        log_prob=f((num_envs, horizon)),
        time=jnp.broadcast_to(jnp.arange(horizon, dtype=jnp.int32), (num_envs, horizon)),
        returns=f((num_envs, horizon)),
        baseline=f((num_envs, horizon)),
        advantages=f((num_envs, horizon)),
        env_info=env_info or {},
    )

"""Policy evaluation + trajectory export (reference: GymEnv.evaluate_policy /
visualize_policy in mjrl/utils/gym_env.py).

``evaluate_policy`` mirrors the reference's contract: roll N episodes
(deterministic mean action by default), return ``[mean, std, min, max]`` of
the per-episode discounted score plus optional percentiles. It is one jitted
on-device computation.

``export_rollout`` replaces interactive visualization (no display on an
accelerator host): it dumps qpos/action/reward trajectories to ``.npz``; for
the locomotion envs these replay directly in any MuJoCo viewer against the
same Gymnasium asset the env was compiled from.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from mjrl_tpu.envs.base import Env
from mjrl_tpu.models.gaussian_mlp import GaussianMLP
from mjrl_tpu.ops.gae import compute_returns
from mjrl_tpu.samplers.rollout import sample_episodes


def evaluate_policy(
    env: Env,
    policy: GaussianMLP,
    params: Any,
    transforms: Any,
    key: jax.Array,
    num_episodes: int = 10,
    horizon: Optional[int] = None,
    gamma: float = 1.0,
    mean_action: bool = True,
    percentiles: Sequence[float] = (),
) -> Dict[str, float]:
    """Per-episode discounted-score statistics, reference-compatible."""
    batch = sample_episodes(
        env,
        policy,
        params,
        transforms,
        key,
        num_episodes,
        horizon,
        eval_mode=mean_action,
    )
    rets = compute_returns(batch.rewards, batch.done, batch.valid, gamma)
    scores = np.asarray(rets[:, 0])  # score of each episode (one per row)
    out = {
        "mean": float(scores.mean()),
        "std": float(scores.std()),
        "min": float(scores.min()),
        "max": float(scores.max()),
    }
    for p in percentiles:
        out[f"p{p}"] = float(np.percentile(scores, p))
    return out


def export_rollout(
    env: Env,
    policy: GaussianMLP,
    params: Any,
    transforms: Any,
    key: jax.Array,
    path: str,
    horizon: Optional[int] = None,
    mean_action: bool = True,
) -> str:
    """Roll one episode (host loop, recording raw state) and save it."""
    key_reset, key_act = jax.random.split(key)
    state, obs = env.reset(key_reset)
    step_fn = jax.jit(env.step)
    T = horizon or env.spec.horizon
    obs_l, act_l, rew_l, q_l = [], [], [], []
    for t in range(T):
        mean, log_std = policy.apply(params, transforms, obs)
        if mean_action:
            action = mean
        else:
            key_act, k = jax.random.split(key_act)
            action = mean + jnp.exp(log_std) * jax.random.normal(k, mean.shape)
        if hasattr(state, "q"):
            q_l.append(np.asarray(state.q))
        obs_l.append(np.asarray(obs))
        act_l.append(np.asarray(action))
        state, obs, reward, terminated, info = step_fn(state, action)
        rew_l.append(float(reward))
        if bool(terminated):
            break
    data = {
        "observations": np.stack(obs_l),
        "actions": np.stack(act_l),
        "rewards": np.asarray(rew_l),
    }
    if q_l:
        data["qpos"] = np.stack(q_l)
    np.savez(path, **data)
    return path

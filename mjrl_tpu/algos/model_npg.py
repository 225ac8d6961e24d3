"""Model-accelerated NPG: learn dynamics, imagine rollouts, update for real.

Capability twin of the reference's model_accel subsystem (reference:
mjrl/algos/model_accel/ — ensemble MLP dynamics models fit on collected
paths + NPG updated on rollouts through the learned models, cutting real
env samples per unit of policy improvement). Shape of the program:

- one fused jitted train_step does: real rollout -> ensemble fit (vmapped
  members) -> imagined rollouts through a ``ModelEnv`` (the SAME
  sample_episodes scan as real sampling, with the learned step function) ->
  NPG update + baseline fit on the imagined batch;
- imagined episodes start from states visited in real data (a masked
  categorical draw over the real batch's valid observations) and each
  imagined episode commits to one random ensemble member — the reference's
  trajectory-consistent model sampling;
- the env must expose ``reward_from_obs(obs, act, next_obs)`` (and
  optionally ``terminated_from_obs``) so imagination can score itself,
  mirroring the reference's per-task reward functions.

``running_score`` tracks the REAL rollout statistics only, so learning
curves stay comparable to the model-free agents.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import jax
import jax.numpy as jnp

from mjrl_tpu.algos.base import AgentState
from mjrl_tpu.algos.npg import NPG
from mjrl_tpu.envs.base import Env, StepResult
from mjrl_tpu.models.dynamics import DynamicsEnsemble
from mjrl_tpu.samplers.rollout import rollout_statistics, sample_episodes
from mjrl_tpu.types import EnvSpec


def _agent_state_dataclass(cls):
    cls = dataclasses.dataclass(frozen=True)(cls)
    fields = [f.name for f in dataclasses.fields(cls)]
    return jax.tree_util.register_dataclass(cls, data_fields=fields, meta_fields=[])


@_agent_state_dataclass
class ModelAgentState:
    """AgentState + the learned-dynamics state (one checkpointable pytree)."""

    params: Any
    old_params: Any
    transforms: Any
    baseline_state: Any
    opt_state: Any
    iteration: jax.Array
    running_score: jax.Array
    dynamics_state: Any

    def replace(self, **kwargs: Any) -> "ModelAgentState":
        return dataclasses.replace(self, **kwargs)


class ModelEnv(Env):
    """Imagination env over a (traced) dynamics-ensemble state.

    Constructed INSIDE the jitted train_step with the current ensemble
    parameters closed over; state = (obs, member). Episode starts draw an
    observation from the provided start pool and a random ensemble member
    that the whole episode sticks with.
    """

    def __init__(
        self,
        real_env: Env,
        dynamics: DynamicsEnsemble,
        dyn_state: Any,
        start_pool: jax.Array,  # (P, do)
        start_logits: jax.Array,  # (P,) -inf at invalid rows
        horizon: int,
    ):
        self.spec = EnvSpec(
            observation_dim=real_env.spec.observation_dim,
            action_dim=real_env.spec.action_dim,
            horizon=horizon,
        )
        self.real_env = real_env
        self.dynamics = dynamics
        self.dyn_state = dyn_state
        self.start_pool = start_pool
        self.start_logits = start_logits

    def reset(self, key: jax.Array):
        k_idx, k_member = jax.random.split(key)
        idx = jax.random.categorical(k_idx, self.start_logits)
        member = jax.random.randint(k_member, (), 0, self.dynamics.K)
        obs = self.start_pool[idx]
        return (obs, member), obs

    def step(self, state, action) -> StepResult:
        obs, member = state
        nxt = self.dynamics.predict(self.dyn_state, obs, action, member)
        reward = self.real_env.reward_from_obs(obs, action, nxt)
        if hasattr(self.real_env, "terminated_from_obs"):
            term = self.real_env.terminated_from_obs(nxt)
        else:
            term = jnp.zeros((), dtype=bool)
        return (nxt, member), nxt, reward, term, {}


class ModelAccelNPG(NPG):
    """NPG whose policy updates run on imagined rollouts.

    ``num_traj`` (inherited) is the REAL episodes collected per iteration
    (the sample-efficiency budget); ``img_traj``/``img_horizon`` size the
    imagined batch the update actually consumes.
    """

    def __init__(
        self,
        env: Env,
        policy,
        baseline,
        ensemble_size: int = 4,
        dyn_hidden_sizes=(256, 256),
        dyn_learn_rate: float = 1e-3,
        dyn_batch_size: int = 256,
        dyn_fit_epochs: int = 10,
        img_traj: int = 256,
        img_horizon: Optional[int] = None,
        **kwargs: Any,
    ):
        super().__init__(env, policy, baseline, **kwargs)
        assert hasattr(env, "reward_from_obs"), (
            "model-based acceleration needs env.reward_from_obs(obs, act, "
            "next_obs) — the reference's per-task reward function"
        )
        self.dynamics = DynamicsEnsemble(
            env.spec,
            ensemble_size=ensemble_size,
            hidden_sizes=dyn_hidden_sizes,
            learn_rate=dyn_learn_rate,
            batch_size=dyn_batch_size,
            fit_epochs=dyn_fit_epochs,
        )
        self.img_traj = img_traj
        self.img_horizon = img_horizon or self.horizon

    def init(self, key: jax.Array) -> ModelAgentState:
        k_base, k_dyn = jax.random.split(key)
        base = super().init(k_base)
        return ModelAgentState(
            params=base.params,
            old_params=base.old_params,
            transforms=base.transforms,
            baseline_state=base.baseline_state,
            opt_state=base.opt_state,
            iteration=base.iteration,
            running_score=base.running_score,
            dynamics_state=self.dynamics.init(k_dyn),
        )

    def train_step(
        self, state: ModelAgentState, key: jax.Array
    ) -> Tuple[ModelAgentState, Dict[str, jax.Array]]:
        k_real, k_fit, k_img, k_update, k_bfit = jax.random.split(key, 5)

        # 1. real-world data (the sample budget of record)
        real = sample_episodes(
            self.env,
            self.policy,
            state.params,
            state.transforms,
            k_real,
            self.num_traj,
            self.horizon,
        )

        # 2. fit the dynamics ensemble on it
        dyn_state, dyn_metrics = self.dynamics.fit(
            state.dynamics_state, real, k_fit
        )

        # 3. imagined on-policy batch from real start states
        do = real.observations.shape[-1]
        pool = real.observations.reshape(-1, do)
        validf = real.valid.reshape(-1)
        logits = jnp.where(validf, 0.0, -jnp.inf)
        model_env = ModelEnv(
            self.env, self.dynamics, dyn_state, pool, logits, self.img_horizon
        )
        img = sample_episodes(
            model_env,
            self.policy,
            state.params,
            state.transforms,
            k_img,
            self.img_traj,
            self.img_horizon,
        )

        # 4. NPG update + baseline fit on imagination
        img = self.process_batch(state, img)
        state, update_metrics = self.update(state, img, k_update)
        baseline_state, vf_metrics = self.baseline.fit(
            state.baseline_state, img, k_bfit
        )

        # 5. score with REAL statistics
        stats = rollout_statistics(real)
        running = jnp.where(
            state.iteration == 0,
            stats.mean,
            0.9 * state.running_score + 0.1 * stats.mean,
        )
        state = state.replace(
            baseline_state=baseline_state,
            dynamics_state=dyn_state,
            iteration=state.iteration + 1,
            running_score=running,
        )
        metrics = {
            "stoc_pol_mean": stats.mean,
            "stoc_pol_std": stats.std,
            "stoc_pol_max": stats.max,
            "stoc_pol_min": stats.min,
            "success_rate": stats.success_rate,
            "running_score": running,
            "num_samples": real.num_valid,
            **update_metrics,
            **vf_metrics,
            **dyn_metrics,
        }
        return state, metrics

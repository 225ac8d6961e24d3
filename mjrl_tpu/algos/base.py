"""Agent base: likelihood-ratio policy gradient machinery + train_step.

Capability twin of the reference's ``BatchREINFORCE``
(reference: mjrl/algos/batch_reinforce.py): the CPI surrogate
``mean(LR * adv)``, its flat gradient (``flat_vpg``), mean-KL between old and
new policies, and the ``train_step`` orchestration
sample -> returns -> advantages -> update -> baseline-fit.

Differences from the reference:
- ``train_step`` is ONE jitted program: sampling, GAE, the update and the
  baseline fit all fuse; the host loop only feeds PRNG keys and reads
  metrics (the reference crosses a process pool and torch autograd per
  phase).
- Data stays in the fixed-shape masked ``TrajectoryBatch``; every statistic
  is valid-mask-weighted instead of physically concatenating variable-length
  paths.
- The old-policy copy is an explicit ``old_params`` pytree in the agent
  state (the reference's in-module ``old_params``/``set_param_values(...,
  set_old=True)``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import jax
import jax.numpy as jnp

from mjrl_tpu.envs.base import Env
from mjrl_tpu.models.baselines import Baseline
from mjrl_tpu.models.gaussian_mlp import GaussianMLP, PolicyParams
from mjrl_tpu.ops.distributions import DiagGaussian
from mjrl_tpu.ops.gae import compute_advantages, compute_returns, masked_mean_std
from mjrl_tpu.samplers.rollout import (
    init_autoreset_carry,
    rollout_statistics,
    sample_autoreset,
    sample_episodes,
)
from mjrl_tpu.types import TrajectoryBatch


def _agent_state_dataclass(cls):
    cls = dataclasses.dataclass(frozen=True)(cls)
    fields = [f.name for f in dataclasses.fields(cls)]
    return jax.tree_util.register_dataclass(cls, data_fields=fields, meta_fields=[])


@_agent_state_dataclass
class AgentState:
    """The full mutable training state as one pytree (checkpointable)."""

    params: Any
    old_params: Any
    transforms: Any
    baseline_state: Any
    opt_state: Any
    iteration: jax.Array
    running_score: jax.Array

    def replace(self, **kwargs: Any) -> "AgentState":
        return dataclasses.replace(self, **kwargs)


class BatchREINFORCE:
    """REINFORCE with a learned baseline; base class for NPG/TRPO/PPO/DAPG.

    Hyperparameter names/defaults follow the reference (SURVEY.md §5.6).
    ``sample_mode`` 'trajectories' -> one episode per env row
    (``sample_paths``); 'samples' -> auto-reset continuous rows
    (``sample_data_batch``).
    """

    def __init__(
        self,
        env: Env,
        policy: GaussianMLP,
        baseline: Baseline,
        learn_rate: float = 0.01,
        desired_kl: Optional[float] = None,
        num_traj: int = 64,
        num_samples: Optional[int] = None,
        horizon: Optional[int] = None,
        gamma: float = 0.995,
        gae_lambda: Optional[float] = 0.97,
        sample_mode: str = "trajectories",
        normalize_advantages: bool = True,
        adv_norm_eps: float = 1e-6,
        mesh: Optional[Any] = None,
    ):
        assert sample_mode in ("trajectories", "samples")
        self.env = env
        self.policy = policy
        self.baseline = baseline
        self.learn_rate = learn_rate
        self.desired_kl = desired_kl
        self.num_traj = num_traj
        self.num_samples = num_samples
        self.horizon = horizon or env.spec.horizon
        self.gamma = gamma
        self.gae_lambda = gae_lambda
        self.sample_mode = sample_mode
        self.normalize_advantages = normalize_advantages
        self.adv_norm_eps = adv_norm_eps
        # SPMD scale-out: when a mesh is set, the sampled batch is
        # sharding-constrained along its env axis inside the jitted step, and
        # GSPMD partitions rollout/GAE/update accordingly (parallel/mesh.py).
        self.mesh = mesh
        self._jitted_train_step = None
        # Persistent auto-reset sampler carry (samples mode): env states
        # survive across train steps so short per-iteration windows still
        # visit the FULL episode state distribution (the reference's
        # sample_data_batch collects whole episodes; always re-resetting
        # would confine training to the first num_steps states of every
        # episode). Held on the agent, not in AgentState: it is on-policy
        # rollout state, cheap to re-create after a restart, and keeping it
        # out of the checkpoint preserves restore compatibility.
        self._sampler_carry = None

    # -- state --------------------------------------------------------------
    def init(self, key: jax.Array) -> AgentState:
        kp, kb = jax.random.split(key)
        params = self.policy.init(kp)
        return AgentState(
            params=params,
            old_params=jax.tree.map(jnp.copy, params),
            transforms=self.policy.init_transforms(),
            baseline_state=self.baseline.init(kb),
            opt_state=self.init_opt_state(params),
            iteration=jnp.zeros((), jnp.int32),
            running_score=jnp.zeros(()),
        )

    def init_opt_state(self, params: PolicyParams) -> Any:
        return ()

    # -- core math (reference: CPI_surrogate / kl_old_new / flat_vpg) -------
    def surrogate(
        self, params: PolicyParams, transforms: Any, batch: TrajectoryBatch
    ) -> jax.Array:
        """CPI surrogate ``mean(LR * adv)`` over valid steps."""
        new_mean, new_log_std = self.policy.apply(
            params, transforms, batch.observations
        )
        lr = DiagGaussian.likelihood_ratio(
            batch.actions, new_mean, new_log_std, batch.mean, batch.log_std
        )
        validf = batch.valid.astype(lr.dtype)
        n = jnp.maximum(jnp.sum(validf), 1.0)
        return jnp.sum(lr * batch.advantages * validf) / n

    def mean_kl(
        self,
        params: PolicyParams,
        old_params: PolicyParams,
        transforms: Any,
        batch: TrajectoryBatch,
        weights: Optional[jax.Array] = None,
    ) -> jax.Array:
        """Masked mean ``KL(old || new)`` over states (reference:
        kl_old_new)."""
        new_mean, new_log_std = self.policy.apply(
            params, transforms, batch.observations
        )
        old_mean, old_log_std = self.policy.apply(
            jax.lax.stop_gradient(old_params), transforms, batch.observations
        )
        kl = DiagGaussian.kl(old_mean, old_log_std, new_mean, new_log_std)
        w = batch.valid.astype(kl.dtype)
        if weights is not None:
            w = w * weights
        return jnp.sum(kl * w) / jnp.maximum(jnp.sum(w), 1.0)

    def vpg_grad(
        self, params: PolicyParams, transforms: Any, batch: TrajectoryBatch
    ) -> Any:
        """Gradient pytree of the surrogate (reference: flat_vpg)."""
        return jax.grad(self.surrogate)(params, transforms, batch)

    # -- sampling + post-processing -----------------------------------------
    def sample_batch(
        self, state: AgentState, key: jax.Array, eval_mode: bool = False
    ) -> TrajectoryBatch:
        batch = self._sample_batch_inner(state, key, eval_mode)
        if self.mesh is not None:
            from mjrl_tpu.parallel.mesh import shard_env_pytree

            batch = shard_env_pytree(batch, self.mesh)
        return batch

    def _sample_batch_inner(
        self, state: AgentState, key: jax.Array, eval_mode: bool = False
    ) -> TrajectoryBatch:
        if self.sample_mode == "trajectories":
            return sample_episodes(
                self.env,
                self.policy,
                state.params,
                state.transforms,
                key,
                self.num_traj,
                self.horizon,
                eval_mode=eval_mode,
            )
        num_steps = -(-int(self.num_samples) // self.num_traj)
        return sample_autoreset(
            self.env,
            self.policy,
            state.params,
            state.transforms,
            key,
            self.num_traj,
            num_steps,
            episode_horizon=self.horizon,
            eval_mode=eval_mode,
        )

    def init_sampler_carry(self, key: jax.Array):
        """Fresh persistent-sampler carry (samples mode only, else None)."""
        if self.sample_mode != "samples":
            return None
        carry = init_autoreset_carry(self.env, key, self.num_traj)
        if self.mesh is not None:
            from mjrl_tpu.parallel.mesh import shard_env_pytree

            carry = shard_env_pytree(carry, self.mesh)
        return carry

    def reset_sampler_carry(self) -> None:
        """Drop the persistent sampler carry so the next step re-initializes.

        Called by the harness's transient-error retry path: under async
        dispatch a failed step's error surfaces at the metric readback, AFTER
        the (possibly poisoned) carry arrays were already assigned — the
        in-``step`` except clause alone cannot catch that case.
        """
        self._sampler_carry = None

    def sample_batch_carry(
        self, state: AgentState, key: jax.Array, carry: Any
    ):
        """Samples-mode sampling continuing from ``carry`` (persistent envs)."""
        num_steps = -(-int(self.num_samples) // self.num_traj)
        batch, carry = sample_autoreset(
            self.env,
            self.policy,
            state.params,
            state.transforms,
            key,
            self.num_traj,
            num_steps,
            episode_horizon=self.horizon,
            carry=carry,
        )
        if self.mesh is not None:
            from mjrl_tpu.parallel.mesh import shard_env_pytree

            batch = shard_env_pytree(batch, self.mesh)
            carry = shard_env_pytree(carry, self.mesh)
        return batch, carry

    def process_batch(
        self, state: AgentState, batch: TrajectoryBatch
    ) -> TrajectoryBatch:
        """compute_returns + compute_advantages (reference: train_step body).

        In samples mode the window tail bootstraps the MC return with the
        baseline's value of the row's last state (documented deviation: the
        reference's ``sample_data_batch`` collects whole episodes, so its
        un-bootstrapped returns never truncate mid-episode; ours would, and a
        baseline fit on truncated returns is biased low everywhere).
        """
        values = self.baseline.predict_batch(state.baseline_state, batch)
        bootstrap = values[:, -1] if self.sample_mode == "samples" else None
        rets = compute_returns(
            batch.rewards, batch.done, batch.valid, self.gamma,
            bootstrap_value=bootstrap,
        )
        batch = batch.replace(returns=rets)
        batch = compute_advantages(
            batch, values, self.gamma, self.gae_lambda, normalize=False
        )
        if self.normalize_advantages:
            mean, std = masked_mean_std(batch.advantages, batch.valid, eps=0.0)
            adv = (batch.advantages - mean) / (std + self.adv_norm_eps)
            batch = batch.replace(
                advantages=adv * batch.valid.astype(adv.dtype)
            )
        return batch

    # -- the policy update (overridden by subclasses) -----------------------
    def update(
        self, state: AgentState, batch: TrajectoryBatch, key: jax.Array
    ) -> Tuple[AgentState, Dict[str, jax.Array]]:
        """Vanilla PG: ``params += learn_rate * vpg``."""
        surr_before = self.surrogate(state.params, state.transforms, batch)
        grads = self.vpg_grad(state.params, state.transforms, batch)
        new_params = jax.tree.map(
            lambda p, g: p + self.learn_rate * g, state.params, grads
        )
        new_params = self.policy.project(new_params)
        kl_dist = self.mean_kl(new_params, state.params, state.transforms, batch)
        surr_after = self.surrogate(new_params, state.transforms, batch)
        state = state.replace(
            params=new_params, old_params=jax.tree.map(jnp.copy, new_params)
        )
        return state, {
            "alpha": jnp.asarray(self.learn_rate),
            "kl_dist": kl_dist,
            "surr_improvement": surr_after - surr_before,
        }

    # -- the fused train step ----------------------------------------------
    def train_step(
        self, state: AgentState, key: jax.Array
    ) -> Tuple[AgentState, Dict[str, jax.Array]]:
        """One on-policy iteration, fully jittable.

        Reference: BatchREINFORCE.train_step — sample_paths ->
        compute_returns -> compute_advantages -> train_from_paths ->
        baseline.fit, plus running_score EMA and rollout statistics.
        """
        k_sample, k_update, k_fit = jax.random.split(key, 3)
        batch = self.sample_batch(state, k_sample)
        return self._finish_train_step(state, batch, k_update, k_fit)

    def train_step_carry(
        self, state: AgentState, key: jax.Array, sampler_carry: Any
    ):
        """Samples-mode train step with a persistent sampler carry.

        Same as :meth:`train_step` but env rows continue from where the last
        iteration left them instead of re-resetting — returns
        ``(state, metrics, new_carry)``.
        """
        k_sample, k_update, k_fit = jax.random.split(key, 3)
        batch, sampler_carry = self.sample_batch_carry(state, k_sample, sampler_carry)
        state, metrics = self._finish_train_step(state, batch, k_update, k_fit)
        return state, metrics, sampler_carry

    def _finish_train_step(
        self, state: AgentState, batch: TrajectoryBatch, k_update, k_fit
    ) -> Tuple[AgentState, Dict[str, jax.Array]]:
        batch = self.process_batch(state, batch)
        state, update_metrics = self.update(state, batch, k_update)
        baseline_state, vf_metrics = self.baseline.fit(
            state.baseline_state, batch, k_fit
        )
        stats = rollout_statistics(batch)
        # EMA over per-episode scores; a short auto-reset window that
        # completed NO episode must not dilute the EMA with zeros (episode
        # mode always completes every row, so this guard is a no-op there).
        # The EMA seeds at the FIRST iteration that completes an episode —
        # not at iteration 0 — matching the reference, which seeds with the
        # first observed mean (in samples mode the first done can arrive
        # many windows in; seeding with 0 would understate running_score for
        # dozens of iterations). `running_score == 0.0` is the unseeded
        # sentinel: it is exact only before the first episode completes.
        has_ep = stats.num_episodes > 0
        unseeded = state.running_score == 0.0
        running = jnp.where(
            has_ep,
            jnp.where(
                unseeded,
                stats.mean,
                0.9 * state.running_score + 0.1 * stats.mean,
            ),
            state.running_score,
        )
        state = state.replace(
            baseline_state=baseline_state,
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
            "num_samples": batch.num_valid,
            **update_metrics,
            **vf_metrics,
        }
        return state, metrics

    @property
    def jitted_train_step(self):
        if self._jitted_train_step is None:
            if self.sample_mode == "samples":
                inner = jax.jit(self.train_step_carry)

                def step(state, key):
                    if self._sampler_carry is None:
                        self._sampler_carry = self.init_sampler_carry(
                            jax.random.fold_in(key, 0x5A17)
                        )
                    try:
                        state, metrics, self._sampler_carry = inner(
                            state, key, self._sampler_carry
                        )
                    except Exception:
                        # A failed step may have poisoned the carry arrays;
                        # drop it so the harness's retry re-initializes
                        # (one window of fresh-reset data, then back on
                        # distribution).
                        self._sampler_carry = None
                        raise
                    return state, metrics

                self._jitted_train_step = step
            else:
                self._jitted_train_step = jax.jit(self.train_step)
        return self._jitted_train_step

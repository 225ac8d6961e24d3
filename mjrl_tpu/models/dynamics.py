"""Learned-dynamics ensemble for model-based acceleration.

Capability twin of the reference's model_accel dynamics models (reference:
mjrl/algos/model_accel/nn_dynamics.py — torch MLPs fit to predict the next
state from (s, a), with input/target normalization, consumed by
model-accelerated NPG). Design:

- the K ensemble members are ONE stacked parameter pytree trained under
  ``jax.vmap`` — K small MLP fits become one batched program of batched
  matmuls instead of K sequential fits;
- members differ by init and by independent minibatch shuffles (bootstrap
  by shuffling, the reference's scheme);
- the model predicts the normalized DELTA ``s' - s``; normalization stats
  are recomputed from each fit batch and carried in the state pytree;
- transition pairs come straight from the fixed-shape ``TrajectoryBatch``:
  ``(obs[t], act[t]) -> obs[t+1]`` wherever ``valid[t] & valid[t+1] &
  ~done[t]`` (no episode-crossing pairs under auto-reset).
"""

from __future__ import annotations

from typing import Any, Dict, Sequence, Tuple

import jax
import jax.numpy as jnp
import optax

from mjrl_tpu.models.mlp import apply_mlp, identity_transforms, init_mlp
from mjrl_tpu.types import EnvSpec, TrajectoryBatch


def transition_pairs(batch: TrajectoryBatch):
    """Flatten a TrajectoryBatch into (obs, act, next_obs, weight) pairs."""
    obs = batch.observations[:, :-1]
    act = batch.actions[:, :-1]
    nxt = batch.observations[:, 1:]
    ok = batch.valid[:, :-1] & batch.valid[:, 1:] & (~batch.done[:, :-1])
    do = obs.shape[-1]
    da = act.shape[-1]
    return (
        obs.reshape(-1, do),
        act.reshape(-1, da),
        nxt.reshape(-1, do),
        ok.reshape(-1).astype(obs.dtype),
    )


class DynamicsEnsemble:
    """K-member MLP ensemble predicting normalized next-state deltas."""

    def __init__(
        self,
        spec: EnvSpec,
        ensemble_size: int = 4,
        hidden_sizes: Sequence[int] = (256, 256),
        learn_rate: float = 1e-3,
        batch_size: int = 256,
        fit_epochs: int = 10,
    ):
        self.spec = spec
        self.K = ensemble_size
        self.hidden_sizes = tuple(hidden_sizes)
        self.learn_rate = learn_rate
        self.batch_size = batch_size
        self.fit_epochs = fit_epochs
        self.optimizer = optax.adam(learn_rate)
        self._in_dim = spec.observation_dim + spec.action_dim
        self._out_dim = spec.observation_dim

    # -- state ---------------------------------------------------------------
    def init(self, key: jax.Array) -> Dict[str, Any]:
        sizes = (self._in_dim, *self.hidden_sizes, self._out_dim)
        params = jax.vmap(lambda k: init_mlp(k, sizes, final_scale=0.01))(
            jax.random.split(key, self.K)
        )
        do, da = self.spec.observation_dim, self.spec.action_dim
        return {
            "params": params,
            "opt_state": jax.vmap(self.optimizer.init)(params),
            # input (obs, act) and target (delta) normalizers
            "in_shift": jnp.zeros(do + da),
            "in_scale": jnp.ones(do + da),
            "delta_shift": jnp.zeros(do),
            "delta_scale": jnp.ones(do),
        }

    # -- prediction ----------------------------------------------------------
    def _forward(self, member_params, state, obs, act):
        x = jnp.concatenate([obs, act], axis=-1)
        x = (x - state["in_shift"]) / (state["in_scale"] + 1e-8)
        tf = identity_transforms(self._in_dim, self._out_dim, x.dtype)
        d = apply_mlp(member_params, tf, x, activation=jax.nn.relu)
        return obs + d * state["delta_scale"] + state["delta_shift"]

    def predict(self, state, obs, act, member: jax.Array):
        """Next-obs prediction by ensemble member ``member`` (traced int)."""
        params_m = jax.tree.map(lambda p: p[member], state["params"])
        return self._forward(params_m, state, obs, act)

    def predict_all(self, state, obs, act):
        """(K, ..., do) predictions of every member (disagreement metric)."""
        return jax.vmap(lambda p: self._forward(p, state, obs, act))(
            state["params"]
        )

    # -- fitting -------------------------------------------------------------
    def fit(
        self, state: Dict[str, Any], batch: TrajectoryBatch, key: jax.Array
    ) -> Tuple[Dict[str, Any], Dict[str, jax.Array]]:
        obs, act, nxt, w = transition_pairs(batch)
        x = jnp.concatenate([obs, act], axis=-1)
        delta = nxt - obs
        n = jnp.maximum(jnp.sum(w), 1.0)
        # refresh normalizers from this batch (masked moments)
        in_shift = jnp.sum(x * w[:, None], 0) / n
        in_scale = jnp.sqrt(
            jnp.sum(jnp.square(x - in_shift) * w[:, None], 0) / n
        ) + 1e-3
        d_shift = jnp.sum(delta * w[:, None], 0) / n
        d_scale = jnp.sqrt(
            jnp.sum(jnp.square(delta - d_shift) * w[:, None], 0) / n
        ) + 1e-6
        state = {
            **state,
            "in_shift": in_shift,
            "in_scale": in_scale,
            "delta_shift": d_shift,
            "delta_scale": d_scale,
        }
        xn = (x - in_shift) / (in_scale + 1e-8)
        yn = (delta - d_shift) / d_scale
        m = xn.shape[0]
        mb = min(self.batch_size, m)
        num_mb = max(m // mb, 1)
        tf = identity_transforms(self._in_dim, self._out_dim, xn.dtype)

        def member_fit(params, opt_state, mkey):
            def loss_fn(p, idx):
                pred = apply_mlp(p, tf, xn[idx], activation=jax.nn.relu)
                ww = w[idx][:, None]
                return jnp.sum(ww * jnp.square(pred - yn[idx])) / jnp.maximum(
                    jnp.sum(ww) * self._out_dim, 1.0
                )

            def epoch(carry, ekey):
                p, o = carry
                perm = jax.random.permutation(ekey, m)[: num_mb * mb]
                perm = perm.reshape(num_mb, mb)

                def mb_step(c, idx):
                    p, o = c
                    g = jax.grad(loss_fn)(p, idx)
                    updates, o = self.optimizer.update(g, o, p)
                    return (optax.apply_updates(p, updates), o), ()

                carry, _ = jax.lax.scan(mb_step, (p, o), perm)
                return carry, ()

            (params, opt_state), _ = jax.lax.scan(
                epoch, (params, opt_state), jax.random.split(mkey, self.fit_epochs)
            )
            return params, opt_state

        params, opt_state = jax.vmap(member_fit)(
            state["params"], state["opt_state"], jax.random.split(key, self.K)
        )
        state = {**state, "params": params, "opt_state": opt_state}

        # masked full-batch prediction error (normalized MSE), per member mean
        def member_err(p):
            pred = apply_mlp(p, tf, xn, activation=jax.nn.relu)
            return jnp.sum(w[:, None] * jnp.square(pred - yn)) / jnp.maximum(
                jnp.sum(w) * self._out_dim, 1.0
            )

        errs = jax.vmap(member_err)(params)
        return state, {
            "dyn_error": jnp.mean(errs),
            "dyn_error_max": jnp.max(errs),
            "dyn_num_pairs": n,
        }

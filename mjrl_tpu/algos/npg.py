"""Natural policy gradient with CG Fisher-vector products.

Capability twin of the reference's NPG (reference: mjrl/algos/npg_cg.py
``NPG``): the Fisher matrix is never materialized — CG inverts it through
Fisher-vector products, and the step is scaled to a fixed KL budget
``alpha = sqrt(2 * delta / g^T F^-1 g)`` (normalized step size).

Differences from the reference:
- The FVP is forward-over-reverse: ``jvp(grad(mean_kl))`` (one forward-mode
  pass over the gradient instead of the reference's double-backward), which
  XLA compiles into the same fused program as the surrounding CG iteration.
- The whole update — VPG grad, 10 CG iterations each with an FVP, the step,
  the KL/surrogate diagnostics — is a single jitted computation with zero
  host round-trips. Under pjit with the env axis sharded, XLA inserts the
  gradient/FVP cross-device reductions automatically (SURVEY.md §5.8).
- ``hvp_sample_frac`` subsampling is a per-step Bernoulli mask (fixed
  shapes) rather than the reference's index subsampling.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import jax
import jax.numpy as jnp

from mjrl_tpu.algos.base import AgentState, BatchREINFORCE
from mjrl_tpu.ops.cg import cg_solve
from mjrl_tpu.ops.ravel import ravel_pytree
from mjrl_tpu.types import TrajectoryBatch


class NPG(BatchREINFORCE):
    """Reference defaults: ``normalized_step_size=0.01``,
    ``FIM_invert_args={'iters': 10, 'damping': 1e-4}``, ``hvp_sample_frac=1``.
    """

    def __init__(
        self,
        env,
        policy,
        baseline,
        normalized_step_size: float = 0.01,
        FIM_invert_args: Optional[Dict[str, Any]] = None,
        hvp_sample_frac: float = 1.0,
        residual_tol: float = 1e-10,
        **kwargs: Any,
    ):
        super().__init__(env, policy, baseline, **kwargs)
        args = dict(iters=10, damping=1e-4)
        args.update(FIM_invert_args or {})
        self.normalized_step_size = normalized_step_size
        self.cg_iters = int(args["iters"])
        self.damping = float(args["damping"])
        self.hvp_sample_frac = hvp_sample_frac
        self.residual_tol = residual_tol

    # -- Fisher-vector product ---------------------------------------------
    def build_fvp(
        self,
        state: AgentState,
        batch: TrajectoryBatch,
        key: jax.Array,
    ):
        """FVP closure over the flat param vector (reference:
        ``HVP``/``build_Hvp_eval``), with damping and optional stochastic
        state subsampling."""
        flat, unravel = ravel_pytree(state.params)
        if self.hvp_sample_frac < 1.0:
            mask = jax.random.bernoulli(
                key, self.hvp_sample_frac, batch.rewards.shape
            ).astype(batch.rewards.dtype)
        else:
            mask = None

        def kl_of_flat(p_flat: jax.Array) -> jax.Array:
            return self.mean_kl(
                unravel(p_flat), state.params, state.transforms, batch, weights=mask
            )

        grad_kl = jax.grad(kl_of_flat)

        def fvp(v: jax.Array) -> jax.Array:
            return jax.jvp(grad_kl, (flat,), (v,))[1] + self.damping * v

        return fvp, flat, unravel

    def step_direction(
        self, state: AgentState, batch: TrajectoryBatch, key: jax.Array
    ):
        """VPG -> CG -> (npg direction, initial alpha, flat params, unravel)."""
        grads = self.vpg_grad(state.params, state.transforms, batch)
        vpg_flat, _ = ravel_pytree(grads)
        fvp, flat, unravel = self.build_fvp(state, batch, key)
        npg_flat = cg_solve(
            fvp, vpg_flat, cg_iters=self.cg_iters, residual_tol=self.residual_tol
        )
        inner = jnp.abs(jnp.dot(vpg_flat, npg_flat))
        alpha = jnp.sqrt(2.0 * self.normalized_step_size / (inner + 1e-20))
        return npg_flat, alpha, flat, unravel

    def update(
        self, state: AgentState, batch: TrajectoryBatch, key: jax.Array
    ) -> Tuple[AgentState, Dict[str, jax.Array]]:
        surr_before = self.surrogate(state.params, state.transforms, batch)
        npg_flat, alpha, flat, unravel = self.step_direction(state, batch, key)
        new_params = self.policy.project(unravel(flat + alpha * npg_flat))
        kl_dist = self.mean_kl(new_params, state.params, state.transforms, batch)
        surr_after = self.surrogate(new_params, state.transforms, batch)
        state = state.replace(
            params=new_params, old_params=jax.tree.map(jnp.copy, new_params)
        )
        return state, {
            "alpha": alpha,
            "delta": jnp.asarray(self.normalized_step_size),
            "kl_dist": kl_dist,
            "surr_improvement": surr_after - surr_before,
        }

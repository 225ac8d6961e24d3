"""Ridge-regularized least squares on device (for linear/quadratic baselines).

The reference solves its baseline fits with float64
``np.linalg.lstsq(F F^T + reg I, F y)`` and retries with a 10x larger ridge
whenever the solution comes back non-finite (reference:
mjrl/baselines/linear_baseline.py / quadratic_baseline.py ``fit``). This
program runs float32, so the equivalent here is a Cholesky solve on the
normal equations with one round of iterative refinement, wrapped in the same fixed
escalating-ridge retry ladder — expressed with ``lax`` control flow so it
stays inside jit.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def _chol_solve(gram: jax.Array, rhs: jax.Array, reg: jax.Array) -> jax.Array:
    a = gram + reg * jnp.eye(gram.shape[0], dtype=gram.dtype)
    chol = jax.scipy.linalg.cho_factor(a)
    x = jax.scipy.linalg.cho_solve(chol, rhs)
    # One step of iterative refinement claws back most of the f32 error.
    x = x + jax.scipy.linalg.cho_solve(chol, rhs - a @ x)
    return x


def ridge_solve(
    features: jax.Array,
    targets: jax.Array,
    weights: jax.Array,
    reg_coef: float = 1e-5,
    max_retries: int = 10,
) -> jax.Array:
    """Solve ``argmin_w ||sqrt(W)(F w - y)||^2 + reg ||w||^2`` robustly.

    ``features (M, K)``, ``targets (M,)``, ``weights (M,)`` (0/1 validity
    mask or sample weights). Retries with ``reg *= 10`` while the solution is
    non-finite, up to ``max_retries`` times — the reference's escalation loop.
    """
    wf = weights[:, None] * features
    gram = features.T @ wf
    rhs = wf.T @ targets

    def cond(state):
        i, x, _ = state
        bad = jnp.logical_not(jnp.all(jnp.isfinite(x)))
        return jnp.logical_and(i < max_retries, bad)

    def body(state):
        i, _, reg = state
        reg = reg * 10.0
        return i + 1, _chol_solve(gram, rhs, reg), reg

    reg0 = jnp.asarray(reg_coef, gram.dtype)
    x0 = _chol_solve(gram, rhs, reg0)
    _, x, _ = jax.lax.while_loop(cond, body, (jnp.array(0), x0, reg0))
    return x

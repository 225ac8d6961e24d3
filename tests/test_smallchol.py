"""Scalarized tiny-Cholesky solve vs scipy oracle."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mjrl_tpu.ops import smallchol
from mjrl_tpu.ops.smallchol import chol_solve_small


def test_matches_direct_solve():
    rng = np.random.default_rng(0)
    # both unrolled strategies and the cho_solve fallback
    for n in (1, 3, 14, 23, 30, 41):
        a = rng.normal(size=(8, n, n)).astype(np.float32)
        A = a @ np.swapaxes(a, -1, -2) + n * np.eye(n, dtype=np.float32)
        b = rng.normal(size=(8, n)).astype(np.float32)
        x = np.asarray(chol_solve_small(jnp.asarray(A), jnp.asarray(b)))
        want = np.linalg.solve(A, b[..., None])[..., 0]
        np.testing.assert_allclose(x, want, rtol=2e-3, atol=2e-4)


def test_jit_and_vmap():
    rng = np.random.default_rng(1)
    n = 6
    a = rng.normal(size=(32, n, n)).astype(np.float32)
    A = a @ np.swapaxes(a, -1, -2) + n * np.eye(n, dtype=np.float32)
    b = rng.normal(size=(32, n)).astype(np.float32)
    f = jax.jit(jax.vmap(chol_solve_small))
    x = np.asarray(f(jnp.asarray(A), jnp.asarray(b)))
    np.testing.assert_allclose(x, np.linalg.solve(A, b[..., None])[..., 0], rtol=2e-3, atol=2e-4)


@pytest.mark.parametrize("n", [8, 14, 23])
def test_scalar_and_blocked_agree(n):
    rng = np.random.default_rng(n)
    a = rng.normal(size=(16, n, n)).astype(np.float32)
    A = jnp.asarray(a @ np.swapaxes(a, -1, -2) + n * np.eye(n, dtype=np.float32))
    b = jnp.asarray(rng.normal(size=(16, n)).astype(np.float32))
    xs = np.asarray(jax.jit(smallchol._chol_solve_scalar)(A, b))
    xb = np.asarray(jax.jit(smallchol._chol_solve_blocked)(A, b))
    np.testing.assert_allclose(xs, xb, rtol=1e-4, atol=1e-5)

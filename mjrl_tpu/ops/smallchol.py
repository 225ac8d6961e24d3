"""Batched tiny-SPD Cholesky solve, unrolled at trace time.

``jax.scipy.linalg.cho_factor/cho_solve`` on a (B, n, n) batch of tiny
matrices lowers to a library call per batch that XLA cannot fuse with the
surrounding physics. This implementation unrolls the n^3/3 Cholesky
recurrence at trace time over the individual matrix entries, each a
(B,)-shaped vector, so XLA fuses the resulting elementwise chains with their
neighbours. It serves the physics engine's per-env mass matrices and the
Newton Hessians (nv <= ~30, B = thousands of envs).

Falls back to ``cho_solve`` for n > MAX_UNROLL where trace size would blow
up.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

MAX_UNROLL = 40
# Largest n that takes the entry-wise unroll. On an H100 at B=1024 it beat
# the column-blocked variant at n = 14 and 23 and tied at n = 8 (PERF.md);
# the blocked variant keeps the unmeasured 24..MAX_UNROLL range.
SCALAR_MAX_N = 23


def chol_solve_small(A: jax.Array, b: jax.Array) -> jax.Array:
    """Solve ``A x = b`` for SPD ``A``: shapes (..., n, n) and (..., n).

    The batch dims are arbitrary. Two trace-time strategies (both exact):
    entries unstacked to (batch,)-shaped scalars for n <= SCALAR_MAX_N,
    column-blocked right-looking Cholesky (O(n) unrolled steps over shrinking
    (batch, n-j) column vectors) above that, which emits ~6n medium vector
    ops instead of ~n^3/3 tiny ones.
    """
    n = A.shape[-1]
    if n > MAX_UNROLL:
        chol = jax.scipy.linalg.cho_factor(A)
        return jax.scipy.linalg.cho_solve(chol, b)
    if n > SCALAR_MAX_N:
        return _chol_solve_blocked(A, b)

    return _chol_solve_scalar(A, b)


def _chol_solve_blocked(A: jax.Array, b: jax.Array) -> jax.Array:
    """Right-looking column Cholesky + column-oriented triangular solves,
    unrolled at trace time with static shrinking slices. ~6n vector ops of
    (batch, <=n) / one (batch, n-j, n-j) rank-1 update per column."""
    n = A.shape[-1]
    S = A
    cols = []  # column j: (batch..., n-j) = L[j:, j]
    for j in range(n):
        d = jnp.sqrt(jnp.maximum(S[..., 0, 0], 1e-12))
        col = S[..., :, 0] / d[..., None]  # (batch, n-j), col[...,0] = d
        cols.append(col)
        if j < n - 1:
            rest = col[..., 1:]
            S = S[..., 1:, 1:] - rest[..., :, None] * rest[..., None, :]
    # forward substitution L y = b (column-oriented saxpy)
    r = b
    ys = []
    for j in range(n):
        yj = r[..., 0] / cols[j][..., 0]
        ys.append(yj)
        if j < n - 1:
            r = r[..., 1:] - cols[j][..., 1:] * yj[..., None]
    # back substitution L^T x = y
    x = [None] * n
    y_arr = jnp.stack(ys, axis=-1)
    r = y_arr
    for j in range(n - 1, -1, -1):
        # x_j = (y_j - L[j+1:, j] . x[j+1:]) / L[j, j]
        if j < n - 1:
            tail = jnp.stack(x[j + 1 :], axis=-1)  # (batch, n-1-j)
            dot = jnp.sum(cols[j][..., 1:] * tail, axis=-1)
        else:
            dot = 0.0
        x[j] = (y_arr[..., j] - dot) / cols[j][..., 0]
    return jnp.stack(x, axis=-1)


def _chol_solve_scalar(A: jax.Array, b: jax.Array) -> jax.Array:
    n = A.shape[-1]
    a = [[A[..., i, j] for j in range(n)] for i in range(n)]
    # Cholesky: L lower-triangular, A = L L^T
    L = [[None] * n for _ in range(n)]
    for j in range(n):
        s = a[j][j]
        for k in range(j):
            s = s - L[j][k] * L[j][k]
        L[j][j] = jnp.sqrt(jnp.maximum(s, 1e-12))
        inv_d = 1.0 / L[j][j]
        for i in range(j + 1, n):
            s = a[i][j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            L[i][j] = s * inv_d

    # forward substitution L y = b
    y = [None] * n
    for i in range(n):
        s = b[..., i]
        for k in range(i):
            s = s - L[i][k] * y[k]
        y[i] = s / L[i][i]
    # back substitution L^T x = y
    x = [None] * n
    for i in range(n - 1, -1, -1):
        s = y[i]
        for k in range(i + 1, n):
            s = s - L[k][i] * x[k]
        x[i] = s / L[i][i]
    return jnp.stack(x, axis=-1)

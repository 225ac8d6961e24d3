"""Parity: batch-last SoA substep (physics/soa.py) vs the per-env engine.

The SoA path is the batched fast path; its contract is bit-for-bit-ish
(f32 reassociation only) agreement with engine.step on every supported
model. States are drawn from env resets plus a short warm rollout through
the reference engine so that contact branches are exercised.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mjrl_tpu import envs
from mjrl_tpu.physics import soa
from mjrl_tpu.physics.engine import PhysicsState, step as engine_step

# Substep compiles are expensive on the CPU test backend, so the default
# suite covers the two contact regimes (hopper: planar + foot contacts,
# ant: free joint + many limited hinges); MJRL_TPU_SLOW_TESTS=1 sweeps all.
_slow = pytest.mark.skipif(
    not os.environ.get("MJRL_TPU_SLOW_TESTS"),
    reason="set MJRL_TPU_SLOW_TESTS=1 for the full env sweep",
)
ENVS = [
    "hopper",
    "ant",
    "swimmer",  # cheap (nv=5, no contacts); covers the SoA fluid model
    pytest.param("walker2d", marks=_slow),
    pytest.param("half_cheetah", marks=_slow),
    pytest.param("humanoid", marks=_slow),
]


def _warm_states(env, B, key, n_warm=3):
    keys = jax.random.split(key, B)
    st, _ = jax.vmap(env.reset)(keys)
    k = key
    for i in range(n_warm):
        k, ka = jax.random.split(k)
        a = jax.random.uniform(
            ka, (B, env.spec.action_dim), minval=-1.0, maxval=1.0
        )
        st, *_ = jax.vmap(env.step)(st, a)
    return st


@pytest.mark.parametrize("name", ENVS)
def test_soa_matches_engine_one_substep(name):
    env = envs.make(name, horizon=32)
    model = env.model
    if not soa.soa_supported(model):
        pytest.skip(f"{name}: model not on the SoA fast path")
    B = 16
    key = jax.random.PRNGKey(0)
    st = _warm_states(env, B, key)
    ctrl = jax.random.uniform(
        jax.random.PRNGKey(1), (B, env.spec.action_dim), minval=-1.0, maxval=1.0
    )

    dt = model.dt / model.n_substeps

    # reference: one substep through the per-env engine (single-substep model)
    import copy

    m1 = copy.copy(model)
    m1.n_substeps = 1
    ref = jax.jit(
        jax.vmap(lambda s, c: engine_step(m1, s, c, f_ext_world=None))
    )
    # engine_step with n_substeps=1 advances by m1.dt; we want dt_sub
    m1.dt = dt
    out_ref = ref(st, ctrl)

    got_q, got_qd = jax.jit(
        lambda q, qd, c: soa.substep(model, q, qd, c, dt)
    )(st.q.T, st.qd.T, ctrl.T)

    np.testing.assert_allclose(got_q.T, out_ref.q, rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(got_qd.T, out_ref.qd, rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("name", ["hopper", pytest.param("ant", marks=_slow)])
def test_soa_multistep_matches_engine_frame(name):
    """A full control frame (n_substeps) stays within drift tolerance."""
    env = envs.make(name, horizon=32)
    model = env.model
    if not soa.soa_supported(model):
        pytest.skip(f"{name}: model not on the SoA fast path")
    B = 8
    st = _warm_states(env, B, jax.random.PRNGKey(2))
    ctrl = jax.random.uniform(
        jax.random.PRNGKey(3), (B, env.spec.action_dim), minval=-1.0, maxval=1.0
    )
    ref = jax.jit(jax.vmap(lambda s, c: engine_step(model, s, c)))(st, ctrl)
    got_q, got_qd = jax.jit(
        lambda q, qd, c: soa.multistep(model, q, qd, c, n_frames=1)
    )(st.q.T, st.qd.T, ctrl.T)
    np.testing.assert_allclose(got_q.T, ref.q, rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(got_qd.T, ref.qd, rtol=5e-3, atol=5e-3)


def test_soa_fori_loop_matches_unrolled():
    # hopper: the unrolled side of this test lowers n_frames*n_substeps
    # copies of the substep — on ant that alone is ~4 min of XLA:CPU
    # compile for a property (fori == unroll) that is model-independent
    env = envs.make("hopper", horizon=32)
    model = env.model
    B = 4
    st = _warm_states(env, B, jax.random.PRNGKey(4))
    ctrl = jnp.zeros((B, env.spec.action_dim))
    a = jax.jit(lambda q, qd, c: soa.multistep(model, q, qd, c, 2, unroll=True))(
        st.q.T, st.qd.T, ctrl.T
    )
    b = jax.jit(lambda q, qd, c: soa.multistep(model, q, qd, c, 2, unroll=False))(
        st.q.T, st.qd.T, ctrl.T
    )
    np.testing.assert_allclose(a[0], b[0], rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(a[1], b[1], rtol=1e-6, atol=1e-6)

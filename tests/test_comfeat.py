"""cinert/cvel/qfrc_actuator parity vs CPU MuJoCo on the humanoid asset.

These feed the humanoid's 376-dim gym observation (gymnasium humanoid_v4;
the reference trains the same task through old gym). cfrc_ext is not
value-compared (penalty contacts vs MuJoCo's constraint solver — same
rationale as tests/test_physics_mujoco.py), only shape/zero-row checked.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

mujoco = pytest.importorskip("mujoco")

from mjrl_tpu.envs.locomotion import _asset_path
from mjrl_tpu.physics import PhysicsState
from mjrl_tpu.physics import math3d as m3
from mjrl_tpu.physics.comfeat import body_links, com_features
from mjrl_tpu.physics.engine import compute_kinematics
from mjrl_tpu.physics.mjcf import load_mjcf

ASSET = _asset_path("humanoid.xml")


def _matched_state(mm, md, model, seed):
    rng = np.random.default_rng(seed)
    q = mm.qpos0.copy()
    q[2] += 3.0  # clear of the floor: keep MuJoCo constraint-free
    q[3:7] += rng.normal(scale=0.05, size=4)
    q[3:7] /= np.linalg.norm(q[3:7])
    for j in range(1, mm.njnt):
        adr = mm.jnt_qposadr[j]
        lo, hi = mm.jnt_range[j]
        q[adr] = 0.5 * (lo + hi) + rng.normal(scale=0.1)
    v_w = rng.normal(scale=0.3, size=3)
    w_b = rng.normal(scale=0.4, size=3)
    qd_j = rng.normal(scale=0.3, size=mm.nv - 6)
    md.qpos[:] = q
    md.qvel[:3] = v_w
    md.qvel[3:6] = w_b
    md.qvel[6:] = qd_j
    ctrl = rng.uniform(-0.4, 0.4, size=mm.nu)
    md.ctrl[:] = ctrl
    # mujoco free qvel is [v_world, w_body]; ours is [w_body, v_body]
    v_b = np.asarray(m3.quat_rotate_inv(jnp.asarray(q[3:7]), jnp.asarray(v_w)))
    state = PhysicsState(
        q=jnp.asarray(q, jnp.float32),
        qd=jnp.asarray(np.concatenate([w_b, v_b, qd_j]), jnp.float32),
    )
    return state, jnp.asarray(ctrl, jnp.float32)


@pytest.mark.parametrize("seed", [0, 3])
def test_cinert_cvel_qfrc_match_mujoco(seed):
    model = load_mjcf(ASSET)
    mm = mujoco.MjModel.from_xml_path(ASSET)
    md = mujoco.MjData(mm)
    state, ctrl = _matched_state(mm, md, model, seed)
    mujoco.mj_forward(mm, md)
    assert md.nefc == 0

    kin = compute_kinematics(model, state)
    cinert, cvel, qfrc_act, cfrc = jax.jit(
        lambda s, c: com_features(model, compute_kinematics(model, s), s, c)
    )(state, ctrl)

    links = body_links(model)
    assert links.size == mm.nbody - 1
    assert cinert.shape == (mm.nbody, 10)
    assert cvel.shape == (mm.nbody, 6)
    assert cfrc.shape == (mm.nbody, 6)
    np.testing.assert_allclose(np.asarray(cinert[0]), 0.0)

    np.testing.assert_allclose(
        np.asarray(cinert), md.cinert, rtol=2e-4, atol=2e-4
    )
    np.testing.assert_allclose(np.asarray(cvel), md.cvel, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(
        np.asarray(qfrc_act), md.qfrc_actuator, rtol=2e-4, atol=2e-4
    )


def test_humanoid_gym_observation_is_376_dim():
    from mjrl_tpu import envs

    env = envs.make("humanoid", horizon=16)
    assert env.spec.observation_dim == 376
    st, obs = env.reset(jax.random.PRNGKey(0))
    assert obs.shape == (376,)
    st2, obs2, r, done, info = env.step(st, jnp.zeros(env.spec.action_dim))
    assert obs2.shape == (376,)
    assert np.isfinite(np.asarray(obs2)).all()
    # compact mode preserved for small-policy experiments
    env_c = envs.make("humanoid", horizon=16, obs_mode="compact")
    assert env_c.spec.observation_dim == (env_c.model.nq - 2) + env_c.model.nv

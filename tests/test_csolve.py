"""Constraint-solver (csolve.py) parity vs CPU MuJoCo's own solver.

The oracle is ``mujoco.mj_forward``'s qacc — the full pipeline the reference
framework reaches through mujoco_py (SURVEY.md §2.2): pyramidal friction
cones, solref/solimp soft constraints, joint limits, margins. States are
generated by stepping MuJoCo itself (realistic contact depths).

Every formula in csolve.build_rows was calibrated against mujoco's efc_*
arrays; these tests lock the end-to-end qacc.
"""

import os

import jax
import jax.numpy as jnp
import mujoco
import numpy as np
import pytest

from mjrl_tpu.envs.locomotion import _ASSETS as ASSETS
from mjrl_tpu.physics import csolve
from mjrl_tpu.physics import math3d as m3
from mjrl_tpu.physics.bridge import model_from_mujoco
from mjrl_tpu.physics.engine import PhysicsState, step as engine_step

BALL_XML = """
<mujoco><option timestep="0.002"/>
<worldbody>
<geom name="floor" type="plane" size="5 5 .1" friction="0.5 0.005 0.0001"/>
<body name="ball" pos="0 0 0.09">
  <freejoint/>
  <geom name="b" type="sphere" size="0.1" friction="0.5 0.005 0.0001" mass="2"/>
</body>
</worldbody></mujoco>"""


def _to_ours_qvel(m, q, qvel):
    """mujoco free-joint qvel [v_world, w_body] -> ours [w_body, v_body]."""
    if m.njnt and m.jnt_type[0] == 0:  # free
        quat = jnp.asarray(q[3:7])
        v_b = np.asarray(m3.quat_rotate_inv(quat, jnp.asarray(qvel[0:3])))
        return np.concatenate([qvel[3:6], v_b, qvel[6:]]).astype(np.float32)
    return np.asarray(qvel, np.float32)


def _to_mj_qacc(m, q, qvel_ours, qacc_ours):
    """ours [dw_b, dv_b, ...] -> mujoco [dv_w, dw_b, ...]."""
    if m.njnt and m.jnt_type[0] == 0:
        quat = jnp.asarray(q[3:7])
        wb = qvel_ours[0:3]
        vb = qvel_ours[3:6]
        dv_w = np.asarray(
            m3.quat_rotate(
                quat, jnp.asarray((qacc_ours[3:6] + np.cross(wb, vb)).astype(np.float32))
            )
        )
        return np.concatenate([dv_w, qacc_ours[0:3], qacc_ours[6:]])
    return qacc_ours


BALL4_XML = BALL_XML.replace(
    'type="plane" size="5 5 .1"', 'type="plane" size="5 5 .1" condim="4"'
).replace('type="sphere" size="0.1"', 'type="sphere" size="0.1" condim="4"')


def test_condim4_spinning_ball_matches_mujoco():
    """Torsional friction (condim 4): spinning+sliding ball qacc parity."""
    m = mujoco.MjModel.from_xml_string(BALL4_XML)
    d = mujoco.MjData(m)
    d.qvel[0] = 0.3
    d.qvel[5] = 2.0  # spin about the contact normal
    mujoco.mj_forward(m, d)
    assert d.nefc == 6  # 2*(condim-1) pyramid rows
    model = model_from_mujoco(m)
    qd = _to_ours_qvel(m, d.qpos, d.qvel)
    ps = PhysicsState(q=jnp.asarray(d.qpos.astype(np.float32)), qd=jnp.asarray(qd))
    qacc = np.asarray(csolve.forward_qacc(model, ps, jnp.zeros(model.nu)))
    ours = _to_mj_qacc(m, d.qpos, qd, qacc)
    np.testing.assert_allclose(ours, d.qacc, atol=2e-3)
    # the spin must decelerate (torsional row active)
    assert d.qacc[5] < -1e-3 and ours[5] < -1e-3


def test_sliding_ball_matches_mujoco_exactly():
    """Friction cone saturated (sliding), spin-up torque, normal force."""
    m = mujoco.MjModel.from_xml_string(BALL_XML)
    d = mujoco.MjData(m)
    d.qvel[0] = 0.3
    mujoco.mj_forward(m, d)
    model = model_from_mujoco(m)
    qd = _to_ours_qvel(m, d.qpos, d.qvel)
    ps = PhysicsState(q=jnp.asarray(d.qpos.astype(np.float32)), qd=jnp.asarray(qd))
    qacc = np.asarray(csolve.forward_qacc(model, ps, jnp.zeros(model.nu)))
    ours = _to_mj_qacc(m, d.qpos, qd, qacc)
    np.testing.assert_allclose(ours, d.qacc, atol=1e-3)


@pytest.mark.parametrize("asset", ["hopper.xml", "walker2d.xml"])
def test_planar_contact_limit_qacc_matches(asset):
    xml = open(os.path.join(ASSETS, asset)).read().replace(
        'integrator="RK4"', 'integrator="Euler"'
    )
    m = mujoco.MjModel.from_xml_string(xml)
    d = mujoco.MjData(m)
    model = model_from_mujoco(m)
    rng = np.random.default_rng(3)
    checked = 0
    for K in (40, 80, 160, 300, 500, 800):
        mujoco.mj_resetData(m, d)
        d.ctrl[:] = rng.uniform(-0.3, 0.3, m.nu)
        for _ in range(K):
            mujoco.mj_step(m, d)
        mujoco.mj_forward(m, d)
        ps = PhysicsState(
            q=jnp.asarray(d.qpos.astype(np.float32)),
            qd=jnp.asarray(d.qvel.astype(np.float32)),
        )
        qacc = np.asarray(
            csolve.forward_qacc(model, ps, jnp.asarray(d.ctrl.astype(np.float32)))
        )
        scale = max(np.abs(d.qacc).max(), 1.0)
        assert np.abs(qacc - d.qacc).max() / scale < 5e-3, f"K={K}"
        checked += d.nefc
    assert checked > 10, "sweep never hit constrained states"


def test_ant_free_joint_contact_qacc_matches():
    xml = open(os.path.join(ASSETS, "ant.xml")).read().replace(
        'integrator="RK4"', 'integrator="Euler"'
    )
    m = mujoco.MjModel.from_xml_string(xml)
    d = mujoco.MjData(m)
    model = model_from_mujoco(m)
    rng = np.random.default_rng(7)
    ok = 0
    for K in (150, 400):
        mujoco.mj_resetData(m, d)
        d.ctrl[:] = rng.uniform(-0.3, 0.3, m.nu)
        for _ in range(K):
            mujoco.mj_step(m, d)
        mujoco.mj_forward(m, d)
        qd = _to_ours_qvel(m, d.qpos, d.qvel)
        ps = PhysicsState(q=jnp.asarray(d.qpos.astype(np.float32)), qd=jnp.asarray(qd))
        qacc = np.asarray(
            csolve.forward_qacc(model, ps, jnp.asarray(d.ctrl.astype(np.float32)))
        )
        ours = _to_mj_qacc(m, d.qpos, qd, qacc)
        scale = max(np.abs(d.qacc).max(), 1.0)
        assert np.abs(ours - d.qacc).max() / scale < 1e-2, f"K={K}"
        assert d.nefc > 0
        ok += 1
    assert ok == 2


def test_newton_mode_trajectory_tracks_mujoco():
    """engine.step with constraint_solver='newton': hopper dropped onto the
    floor tracks MuJoCo's Euler trajectory through the landing (the penalty
    model diverges here; the constraint solve is what makes this match)."""
    xml = open(os.path.join(ASSETS, "hopper.xml")).read()
    m = mujoco.MjModel.from_xml_string(xml)
    d = mujoco.MjData(m)
    model = model_from_mujoco(m)
    model.constraint_solver = "newton"
    ctrl = np.array([0.1, -0.1, 0.05], np.float32)
    d.ctrl[:] = ctrl
    state = PhysicsState(
        q=jnp.asarray(d.qpos.astype(np.float32)),
        qd=jnp.asarray(d.qvel.astype(np.float32)),
    )
    step = jax.jit(lambda s: engine_step(model, s, jnp.asarray(ctrl)))
    for t in range(120):  # ~1s: falls ~0.1 m, lands, settles
        mujoco.mj_step(m, d)
        state = step(state)
    np.testing.assert_allclose(np.asarray(state.q), d.qpos, atol=2e-2)
    assert np.abs(np.asarray(state.qd) - d.qvel).max() < 0.5


def test_limit_rows_match_efc():
    """Row-level lock: limit-row aref and D equal mujoco's efc arrays."""
    xml = open(os.path.join(ASSETS, "hopper.xml")).read()
    m = mujoco.MjModel.from_xml_string(xml)
    d = mujoco.MjData(m)
    d.qpos[:] = m.qpos0
    d.qpos[3] = -170 * np.pi / 180  # past the leg joint's limit
    d.qvel[:] = 0.1
    mujoco.mj_forward(m, d)
    lim = [i for i in range(d.nefc) if d.efc_type[i] == mujoco.mjtConstraint.mjCNSTR_LIMIT_JOINT]
    assert lim, "expected a violated joint limit"
    model = model_from_mujoco(m)
    from mjrl_tpu.physics.engine import compute_kinematics

    ps = PhysicsState(
        q=jnp.asarray(d.qpos.astype(np.float32)),
        qd=jnp.asarray(d.qvel.astype(np.float32)),
    )
    rows = csolve.build_rows(model, compute_kinematics(model, ps), ps)
    aref = np.asarray(rows.aref)
    D = np.asarray(rows.D)
    for i in lim:
        hit = np.where(np.abs(aref - d.efc_aref[i]) < 5e-3 * max(1, abs(d.efc_aref[i])))[0]
        assert hit.size, f"no row matches mj limit aref {d.efc_aref[i]}"
        assert np.any(np.abs(D[hit] - d.efc_D[i]) < 1e-2 * d.efc_D[i])


FRICTIONLOSS_XML = """
<mujoco><option timestep="0.002" gravity="0 0 0"/>
<worldbody>
<body name="arm" pos="0 0 1">
  <joint name="hinge" type="hinge" axis="0 1 0" frictionloss="{fl}"/>
  <geom type="capsule" fromto="0 0 0 0.5 0 0" size="0.04" mass="1"/>
</body>
</worldbody></mujoco>"""


def test_dt0_frictionloss_divergence_pinned():
    """Pins the DOCUMENTED dt==0 parity limitation (round-4 advisor).

    MuJoCo reports dof_frictionloss through constraint rows in d.qacc;
    our dt==0 mj_forward parity surface drops friction entirely (the
    regularized tanh force is dt>0/integration-only). This test pins both
    halves: (a) on a frictionloss model with qd != 0 the surfaces diverge
    by exactly the friction torque / inertia, and (b) zeroing
    frictionloss restores exact parity. See csolve.forward_qacc
    docstring.
    """
    fl = 2.5
    m = mujoco.MjModel.from_xml_string(FRICTIONLOSS_XML.format(fl=fl))
    d = mujoco.MjData(m)
    d.qvel[0] = 1.0
    mujoco.mj_forward(m, d)
    model = model_from_mujoco(m)
    ps = PhysicsState(
        q=jnp.asarray(d.qpos.astype(np.float32)),
        qd=jnp.asarray(d.qvel.astype(np.float32)),
    )
    ours = float(csolve.forward_qacc(model, ps, jnp.zeros(model.nu))[0])
    # (a) divergence is real and equals the friction deceleration
    inertia = float(m.dof_M0[0])
    assert abs(ours - d.qacc[0]) > 0.5 * fl / inertia, (
        "expected dt==0 frictionloss divergence vanished — if friction "
        "rows were added to the dt==0 surface, update the forward_qacc "
        "docstring and flip this test to assert parity"
    )
    np.testing.assert_allclose(ours, 0.0, atol=1e-5)  # no friction, no force
    np.testing.assert_allclose(d.qacc[0], -fl / inertia, rtol=1e-3)
    # (b) frictionloss-free model: exact parity at the same state
    m0 = mujoco.MjModel.from_xml_string(FRICTIONLOSS_XML.format(fl=0))
    d0 = mujoco.MjData(m0)
    d0.qvel[0] = 1.0
    mujoco.mj_forward(m0, d0)
    model0 = model_from_mujoco(m0)
    ours0 = float(csolve.forward_qacc(model0, ps, jnp.zeros(model0.nu))[0])
    np.testing.assert_allclose(ours0, d0.qacc[0], atol=1e-5)

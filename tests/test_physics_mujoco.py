"""Per-state parity vs CPU MuJoCo 3.x ground truth (SURVEY.md §4b).

The same Gymnasium MJCF assets (vendored under ``mjrl_tpu/envs/assets``) are
compiled by BOTH our loader and MuJoCo;
at random states we compare, to float tolerance:

- model compilation: sizes, masses, coms, principal inertias, qpos0,
- forward kinematics: world body positions/orientations,
- CRBA mass matrix (MuJoCo folds armature into qM; we add it at solve time),
- RNEA bias forces (gravity + Coriolis),
- smooth-region forward dynamics qacc (contact-free states, within joint
  limits), assembled from the same pieces on both sides,
- trajectory rollout on a contact-free model under MuJoCo's Euler
  integrator (which, like ours, integrates joint damping implicitly).

Contact forces are intentionally NOT compared: the engine uses a penalty
model, MuJoCo a soft-constraint solver (see physics/contact.py docstring).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

mujoco = pytest.importorskip("mujoco")

from mjrl_tpu.physics import PhysicsState, joint_subspaces
from mjrl_tpu.physics.engine import (
    actuation,
    compute_kinematics,
    crba,
    forward_kinematics,
    passive_forces,
    rnea_bias,
    step,
)
from mjrl_tpu.physics.mjcf import load_mjcf

from mjrl_tpu.envs.locomotion import _ASSETS as ASSETS  # noqa: E402

PLANAR = ["hopper.xml", "walker2d.xml", "half_cheetah.xml"]


def _load_pair(asset):
    path = os.path.join(ASSETS, asset)
    model = load_mjcf(path)
    mm = mujoco.MjModel.from_xml_path(path)
    return model, mm


def _random_smooth_state(model, mm, seed, scale=0.2):
    """Random state clipped inside joint limits, root lifted clear of the
    ground so no contacts are active."""
    rng = np.random.default_rng(seed)
    q = mm.qpos0.copy() + rng.normal(scale=scale, size=mm.nq)
    for j in range(mm.njnt):
        if mm.jnt_limited[j]:
            adr = mm.jnt_qposadr[j]
            lo, hi = mm.jnt_range[j]
            mid, half = 0.5 * (lo + hi), 0.5 * (hi - lo)
            q[adr] = np.clip(q[adr], mid - 0.8 * half, mid + 0.8 * half)
    # lift the root high above the floor
    for j in range(mm.njnt):
        if mm.jnt_type[j] == mujoco.mjtJoint.mjJNT_SLIDE and mm.jnt_axis[j][2] == 1:
            q[mm.jnt_qposadr[j]] += 3.0
        if mm.jnt_type[j] == mujoco.mjtJoint.mjJNT_FREE:
            q[mm.jnt_qposadr[j] + 2] += 3.0
    qd = rng.normal(scale=0.5, size=mm.nv)
    return q, qd


@pytest.mark.parametrize("asset", PLANAR)
def test_model_compilation_matches(asset):
    model, mm = _load_pair(asset)
    assert model.nq == mm.nq and model.nv == mm.nv and model.nu == mm.nu
    name2link = {n: i for i, n in enumerate(model.link_name)}
    for bi in range(1, mm.nbody):
        li = name2link[mm.body(bi).name]
        np.testing.assert_allclose(
            model.link_mass[li], mm.body_mass[bi], rtol=1e-5
        )
        np.testing.assert_allclose(
            model.link_com[li], mm.body_ipos[bi], atol=1e-6
        )
        ours = np.sort(np.linalg.eigvalsh(model.link_inertia_com[li]))
        theirs = np.sort(mm.body_inertia[bi])
        np.testing.assert_allclose(ours, theirs, rtol=1e-4, atol=1e-8)
    np.testing.assert_allclose(model.default_qpos, mm.qpos0, atol=1e-6)
    np.testing.assert_allclose(model.dt, mm.opt.timestep)


@pytest.mark.parametrize("asset", PLANAR)
def test_forward_kinematics_matches(asset):
    model, mm = _load_pair(asset)
    md = mujoco.MjData(mm)
    name2link = {n: i for i, n in enumerate(model.link_name)}
    for seed in range(3):
        q, _ = _random_smooth_state(model, mm, seed)
        md.qpos[:] = q
        mujoco.mj_forward(mm, md)
        pos, quat, _ = forward_kinematics(model, jnp.asarray(q))
        for bi in range(1, mm.nbody):
            li = name2link[mm.body(bi).name]
            np.testing.assert_allclose(
                np.asarray(pos[li]), md.xpos[bi], atol=1e-5
            )
            qo = np.asarray(quat[li])
            qm = md.xquat[bi]
            assert min(np.abs(qo - qm).max(), np.abs(qo + qm).max()) < 1e-5


@pytest.mark.parametrize("asset", PLANAR)
def test_mass_matrix_and_bias_match(asset):
    model, mm = _load_pair(asset)
    md = mujoco.MjData(mm)
    subs = joint_subspaces(model)
    for seed in range(3):
        q, qd = _random_smooth_state(model, mm, seed)
        md.qpos[:] = q
        md.qvel[:] = qd
        mujoco.mj_forward(mm, md)
        state = PhysicsState(q=jnp.asarray(q), qd=jnp.asarray(qd))
        kin = compute_kinematics(model, state, subs)
        M = np.asarray(crba(model, kin, subs)) + np.diag(model.dof_armature)
        Mmj = np.zeros((mm.nv, mm.nv))
        mujoco.mj_fullM(mm, md, Mmj)
        np.testing.assert_allclose(M, Mmj, rtol=1e-4, atol=1e-5)
        C = np.asarray(rnea_bias(model, kin, subs))
        np.testing.assert_allclose(C, md.qfrc_bias, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("asset", PLANAR)
def test_smooth_forward_dynamics_matches(asset):
    """qacc parity away from contacts/limits, including actuation + passive."""
    model, mm = _load_pair(asset)
    md = mujoco.MjData(mm)
    subs = joint_subspaces(model)
    rng = np.random.default_rng(42)
    for seed in range(3):
        q, qd = _random_smooth_state(model, mm, seed)
        ctrl = rng.uniform(-1, 1, size=mm.nu)
        md.qpos[:] = q
        md.qvel[:] = qd
        md.ctrl[:] = ctrl
        mujoco.mj_forward(mm, md)
        assert md.ncon == 0, "expected a contact-free test state"

        state = PhysicsState(
            q=jnp.asarray(q), qd=jnp.asarray(qd)
        )
        kin = compute_kinematics(model, state, subs)
        M = np.asarray(crba(model, kin, subs)) + np.diag(model.dof_armature)
        C = np.asarray(rnea_bias(model, kin, subs))
        tau = np.asarray(actuation(model, jnp.asarray(ctrl)))
        passive = np.asarray(passive_forces(model, state)) - model.dof_damping * qd
        qacc = np.linalg.solve(M, tau + passive - C)
        np.testing.assert_allclose(qacc, md.qacc, rtol=2e-3, atol=2e-3)


PENDULUM_XML = """
<mujoco>
  <compiler angle="radian"/>
  <option timestep="0.002" integrator="Euler"/>
  <worldbody>
    <body name="pole" pos="0 0 1">
      <joint name="hinge" type="hinge" axis="0 1 0" damping="0.3"/>
      <geom type="capsule" fromto="0 0 0 0 0 -0.6" size="0.045"/>
      <body name="tip" pos="0 0 -0.6">
        <joint name="hinge2" type="hinge" axis="0 1 0" damping="0.1"/>
        <geom type="sphere" size="0.08"/>
      </body>
    </body>
  </worldbody>
  <actuator><motor joint="hinge" gear="1"/></actuator>
</mujoco>
"""


def test_trajectory_matches_mujoco_euler():
    """100-step rollout parity on a contact-free double pendulum (MuJoCo's
    Euler integrator also treats joint damping implicitly)."""
    model = load_mjcf(PENDULUM_XML)
    mm = mujoco.MjModel.from_xml_string(PENDULUM_XML)
    md = mujoco.MjData(mm)
    md.qpos[:] = [1.2, -0.4]
    md.qvel[:] = [0.5, -0.1]
    md.ctrl[:] = [0.3]
    state = PhysicsState(
        q=jnp.asarray(md.qpos.copy()),
        qd=jnp.asarray(md.qvel.copy()),
    )
    subs = joint_subspaces(model)
    for t in range(100):
        mujoco.mj_step(mm, md)
        state = step(model, state, jnp.asarray([0.3]), subspaces=subs)
    np.testing.assert_allclose(np.asarray(state.q), md.qpos, atol=2e-4)
    np.testing.assert_allclose(np.asarray(state.qd), md.qvel, atol=2e-3)


def test_ant_free_joint_trajectory_matches():
    """3-D free-joint pipeline parity: airborne ant, joints inside their
    limit ranges (limits use penalties here vs constraints in MuJoCo, so the
    comparison window is the constraint-free phase)."""
    from mjrl_tpu.physics import math3d as m3

    path = os.path.join(ASSETS, "ant.xml")
    xml = open(path).read().replace('integrator="RK4"', 'integrator="Euler"')
    model = load_mjcf(xml)
    mm = mujoco.MjModel.from_xml_string(xml)
    md = mujoco.MjData(mm)
    rng = np.random.default_rng(0)
    q = mm.qpos0.copy()
    q[2] += 3.0
    for j in range(mm.njnt):
        if mm.jnt_limited[j]:
            lo, hi = mm.jnt_range[j]
            q[mm.jnt_qposadr[j]] = 0.5 * (lo + hi) + rng.normal(scale=0.02)
    v_w = rng.normal(scale=0.2, size=3)
    w_b = rng.normal(scale=0.3, size=3)
    qd_j = rng.normal(scale=0.1, size=mm.nv - 6)
    md.qpos[:] = q
    md.qvel[:3] = v_w
    md.qvel[3:6] = w_b
    md.qvel[6:] = qd_j
    # map mujoco free qvel [v_world, w_body] -> ours [w_body, v_body]
    v_b = np.asarray(m3.quat_rotate_inv(jnp.asarray(q[3:7]), jnp.asarray(v_w)))
    state = PhysicsState(
        q=jnp.asarray(q), qd=jnp.asarray(np.concatenate([w_b, v_b, qd_j]))
    )
    ctrl = rng.uniform(-0.3, 0.3, size=mm.nu)
    md.ctrl[:] = ctrl
    for _ in range(10):
        mujoco.mj_step(mm, md)
        state = step(model, state, jnp.asarray(ctrl))
    assert md.nefc == 0, "comparison window must stay constraint-free"
    np.testing.assert_allclose(np.asarray(state.q), md.qpos, atol=1e-3)

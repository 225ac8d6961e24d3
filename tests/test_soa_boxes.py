"""Narrow-phase parity for the round-3 SoA contact kinds + tendon forces.

The box collider kinds (sphere_box / capsule_box / box_box) and fixed
tendons were added to the SoA fast path for Adroit (physics/soa.py). Full
adroit dynamics is an XLA:CPU compile sink, so these tests compare the
GEOMETRY pass only — SoA ``_contact_candidates`` vs the engine's
``_collide_kind`` at identical FK poses — plus the tendon generalized
force, which is closed-form. The full-dynamics parity of the same code ran
on an accelerator (engine-vs-SoA max|dq| 1.5e-8 on adroit_hammer and
adroit_pen, see round-3 notes).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mjrl_tpu import envs
from mjrl_tpu.physics import soa
from mjrl_tpu.physics.contact import _collide_kind, _pair_groups
from mjrl_tpu.physics.engine import (
    Kinematics,
    PhysicsState,
    forward_kinematics,
)


@pytest.fixture(scope="module")
def hammer_env():
    return envs.make("adroit_hammer", horizon=8)


def _rand_states(model, B, key):
    kq, kv = jax.random.split(key)
    q = jnp.asarray(model.default_qpos)[None, :] + 0.05 * jax.random.normal(
        kq, (B, model.nq)
    )
    return q


def test_box_kinds_match_engine_narrow_phase(hammer_env):
    model = hammer_env.model
    assert soa.soa_supported(model)
    B = 3
    q = _rand_states(model, B, jax.random.PRNGKey(0))

    # engine side: per-env kinematics + per-kind collide
    def eng_one(qi):
        pos, quat, _ = forward_kinematics(model, qi)
        z = jnp.zeros(())
        # _collide_kind only reads pos/quat
        kin = Kinematics(pos=pos, quat=quat, origin=pos[0], cdof=z, cvel=z, qd=z)
        outs = {}
        for kind, tab in _pair_groups(model).kinds:
            depth, nrm, pts, li, lj, mu = _collide_kind(model, kin, kind, tab)
            outs[kind] = (depth, nrm, pts)
        return outs

    eng = jax.vmap(eng_one)(q)

    # soa side: batch-last FK + candidates, regrouped by kind in order
    pos, quat = soa._fk(model, q.T)
    soa._LANES = B  # _contact_candidates splats constants at lane width
    try:
        cands = soa._contact_candidates(model, pos, quat)
    finally:
        soa._LANES = 1
    by_kind = {}
    i = 0
    pts_per = {"box_plane": 8, "capsule_plane": 2, "capsule_box": 3,
               "box_box": 16}
    for kind, tab in _pair_groups(model).kinds:
        n = len(tab["gi"]) * pts_per.get(kind, 1)
        by_kind[kind] = cands[i : i + n]
        i += n
    assert i == len(cands)

    for kind in ("sphere_box", "capsule_box", "box_box", "capsule_capsule"):
        if kind not in by_kind:
            continue
        got_depth = np.stack([np.asarray(c.depth)[0] for c in by_kind[kind]], 1)
        got_nrm = np.stack(
            [np.asarray(c.n).T for c in by_kind[kind]], 1
        )  # (B, P, 3)
        got_pts = np.stack([np.asarray(c.pt).T for c in by_kind[kind]], 1)
        ref_depth, ref_nrm, ref_pts = (np.asarray(x) for x in eng[kind])
        if kind == "box_box":
            # candidate ORDER differs (physically irrelevant — contacts
            # are summed): the engine emits [all pairs side1; all pairs
            # side2], SoA interleaves per pair. Reorder the reference.
            P = ref_depth.shape[1] // 16
            perm = np.concatenate(
                [
                    np.r_[p * 8 : (p + 1) * 8, 8 * P + p * 8 : 8 * P + (p + 1) * 8]
                    for p in range(P)
                ]
            )
            ref_depth = ref_depth[:, perm]
            ref_nrm = ref_nrm[:, perm]
            ref_pts = ref_pts[:, perm]
        np.testing.assert_allclose(
            got_depth, ref_depth, rtol=1e-4, atol=1e-5, err_msg=f"{kind} depth"
        )
        # normals/points only matter where a contact is near-active
        active = ref_depth > -1e-3
        np.testing.assert_allclose(
            got_nrm[active], ref_nrm[active], rtol=1e-3, atol=1e-4,
            err_msg=f"{kind} normal",
        )
        np.testing.assert_allclose(
            got_pts[active], ref_pts[active], rtol=1e-3, atol=1e-4,
            err_msg=f"{kind} point",
        )


def test_tendon_forces_match_engine(hammer_env):
    from mjrl_tpu.physics.engine import tendon_forces

    model = hammer_env.model
    B = 4
    kq, kv = jax.random.split(jax.random.PRNGKey(3))
    q = jnp.asarray(model.default_qpos)[None, :] + 0.1 * jax.random.normal(
        kq, (B, model.nq)
    )
    qd = 0.5 * jax.random.normal(kv, (B, model.nv))

    ref = jax.vmap(
        lambda qi, qvi: tendon_forces(model, PhysicsState(q=qi, qd=qvi))
    )(q, qd)
    got = soa._tendon_forces(model, q.T, qd.T).T
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=1e-4,
                               atol=1e-5)

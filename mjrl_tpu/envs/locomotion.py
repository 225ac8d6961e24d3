"""Gym-style locomotion envs on the first-party physics engine.

The capability ladder of BASELINE.json (hopper -> walker2d/half_cheetah ->
ant; swimmer for the fluid model): each env compiles Gymnasium's MJCF asset,
vendored under ``envs/assets/`` with its MIT licence, through our loader
(tests verify the compiled model matches CPU MuJoCo bit-for-bit on
masses/kinematics/smooth dynamics), and reproduces the
gymnasium v4 task conventions — observation layout, reward terms, healthy
ranges/termination, reset noise, frame skip — which are the same tasks the
reference trains on through old gym (reference: mjrl/utils/gym_env.py).

Everything is a pure function: ``step`` unrolls ``frame_skip`` engine
substeps at trace time, so a policy step compiles into one fused XLA program
with the physics inside.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Tuple

import jax
import jax.numpy as jnp

from mjrl_tpu.envs.base import Env, StepResult, register
from mjrl_tpu.physics import PhysicsState, joint_subspaces
from mjrl_tpu.physics.engine import step as physics_step
from mjrl_tpu.physics.mjcf import load_mjcf
from mjrl_tpu.types import EnvSpec


_ASSETS = os.path.join(os.path.dirname(__file__), "assets")


def _asset_path(name: str) -> str:
    """Path of a vendored Gymnasium locomotion MJCF (``envs/assets/``)."""
    return os.path.join(_ASSETS, name)


class LocomotionEnv(Env):
    """Shared machinery for the planar + 3D locomotion tasks."""

    asset: str
    frame_skip: int
    forward_reward_weight: float = 1.0
    ctrl_cost_weight: float = 1e-3
    healthy_reward: float = 0.0
    reset_noise_scale: float = 5e-3
    reset_vel_noise: str = "uniform"  # 'uniform' | 'normal'
    exclude_positions: int = 1  # leading qpos entries dropped from obs
    clip_qvel_obs: Optional[float] = 10.0
    n_substeps: int = 1  # physics substeps per model dt (penalty stability)

    def __init__(
        self,
        horizon: int = 1000,
        asset_path: Optional[str] = None,
        constraint_solver: str = "penalty",
        n_substeps: Optional[int] = None,
    ):
        self.model = load_mjcf(asset_path or _asset_path(self.asset))
        # The class default n_substeps is tuned for PENALTY stability (the
        # explicit spring-damper needs a finer dt than MuJoCo). The newton
        # solve is impedance-implicit like MuJoCo's and is stable at the
        # model dt — pass n_substeps=1 to match MuJoCo's discretization and
        # save the substep multiplier.
        if n_substeps is not None:
            self.n_substeps = int(n_substeps)
        self.model.n_substeps = self.n_substeps
        # 'newton' = MuJoCo-parity soft-constraint contacts/limits
        # (physics/csolve.py); 'penalty' = spring-damper contacts
        self.model.constraint_solver = constraint_solver
        # Auto-tune penalty contact params to the model's scale: full body
        # weight on one contact compresses ~2mm; spring force saturates at
        # depth_cap; near-critical damping vs a quarter of the body mass.
        import numpy as _np

        total_mass = float(self.model.link_mass.sum())
        weight = total_mass * 9.81
        self.model.contact_stiffness = weight / 0.002
        self.model.contact_damping = 2.0 * float(
            _np.sqrt(self.model.contact_stiffness * total_mass / 4.0)
        )
        self.model.contact_depth_cap = 0.02
        # Per-dof critically-damped limit-penalty gains (k = w^2 M_jj,
        # c = 2 w M_jj). The scalar defaults (k=500, c=10) are explosively
        # unstable on light limbs: the limit damping integrates EXPLICITLY,
        # so dt*c/M_jj > 2 (ant's 0.03 kg-m^2 ankles) oscillates to blowup —
        # ants got kicked airborne at reset (gym ant's ankles start outside
        # their range) and died in ~16 steps. MuJoCo instead settles them
        # smoothly into range; with scaled gains so do we.
        from mjrl_tpu.physics.engine import scale_limit_penalties

        scale_limit_penalties(self.model, omega=60.0)
        self.subspaces = joint_subspaces(self.model)
        from mjrl_tpu.physics.dispatch import make_frame_stepper

        self._frame_step = make_frame_stepper(
            self.model, self.frame_skip, subspaces=self.subspaces
        )
        obs_dim = (self.model.nq - self.exclude_positions) + self.model.nv
        self.spec = EnvSpec(
            observation_dim=obs_dim,
            action_dim=self.model.nu,
            horizon=horizon,
        )

    # -- gym-v4 conventions --------------------------------------------------
    def _obs(self, ps: PhysicsState, action=None) -> jax.Array:
        qvel = ps.qd
        if self.clip_qvel_obs is not None:
            qvel = jnp.clip(qvel, -self.clip_qvel_obs, self.clip_qvel_obs)
        return jnp.concatenate([ps.q[self.exclude_positions :], qvel])

    def _healthy(self, ps: PhysicsState) -> jax.Array:
        return jnp.ones((), bool)

    # -- model-based acceleration hooks (ModelAccelNPG; reference:
    # mjrl/algos/model_accel's per-task reward functions) -------------------
    def _healthy_from_obs(self, obs: jax.Array) -> jax.Array:
        """Obs-space twin of ``_healthy`` for imagined transitions.

        Subclasses with termination MUST override this alongside
        ``_healthy``; otherwise model-based rollouts (ModelAccelNPG) would
        silently never terminate and pay healthy_reward unconditionally —
        wrong results with no error (round-4 advisor finding). A subclass
        that overrides ``_healthy`` without this twin fails loudly here.
        """
        if type(self)._healthy is not LocomotionEnv._healthy:
            raise NotImplementedError(
                f"{type(self).__name__} overrides _healthy (it terminates) "
                "but not _healthy_from_obs; model-based imagined rollouts "
                "would use a wrong always-healthy predicate. Override "
                "_healthy_from_obs to match _healthy in obs space."
            )
        return jnp.ones((), bool)

    def reward_from_obs(self, obs, action, next_obs) -> jax.Array:
        """Reward of an imagined transition, from observations alone.

        The root x position is excluded from gym observations, so the
        forward velocity is read from the observed qvel channel
        (``next_obs[nq - exclude_positions]``) instead of the positional
        finite difference ``step`` uses — the two agree up to the obs
        qvel clip and instantaneous-vs-frame-averaged velocity."""
        nq_obs = self.model.nq - self.exclude_positions
        x_velocity = next_obs[nq_obs]
        ctrl_cost = self.ctrl_cost_weight * jnp.sum(jnp.square(action))
        healthy = self._healthy_from_obs(next_obs)
        return (
            self.forward_reward_weight * x_velocity
            - ctrl_cost
            + self.healthy_reward * healthy.astype(x_velocity.dtype)
        )

    def terminated_from_obs(self, next_obs) -> jax.Array:
        return jnp.logical_not(self._healthy_from_obs(next_obs))

    def _x_pos(self, ps: PhysicsState) -> jax.Array:
        return ps.q[0]

    def reset(self, key: jax.Array) -> Tuple[PhysicsState, jax.Array]:
        kq, kv = jax.random.split(key)
        s = self.reset_noise_scale
        q = jnp.asarray(self.model.default_qpos) + jax.random.uniform(
            kq, (self.model.nq,), minval=-s, maxval=s
        )
        if self.reset_vel_noise == "normal":
            qd = s * jax.random.normal(kv, (self.model.nv,))
        else:
            qd = jax.random.uniform(kv, (self.model.nv,), minval=-s, maxval=s)
        ps = PhysicsState(q=q, qd=qd)
        return ps, self._obs(ps)

    def step(self, ps: PhysicsState, action: jax.Array) -> StepResult:
        x_before = self._x_pos(ps)
        q2, qd2 = self._frame_step(ps.q, ps.qd, action)
        ps = PhysicsState(q=q2, qd=qd2)
        x_after = self._x_pos(ps)
        dt = self.model.dt * self.frame_skip
        x_velocity = (x_after - x_before) / dt
        ctrl_cost = self.ctrl_cost_weight * jnp.sum(jnp.square(action))
        healthy = self._healthy(ps)
        # Blow-up guard: penalty physics can diverge under degenerate inputs
        # where MuJoCo's constraint solver cannot; a diverged state must
        # terminate with a sane reward or NaN/1e6-scale garbage poisons the
        # returns of the whole batch. (Real MuJoCo never reaches this — gym
        # has no equivalent check because it needs none.)
        sane = (
            jnp.all(jnp.isfinite(ps.q))
            & jnp.all(jnp.isfinite(ps.qd))
            & (jnp.max(jnp.abs(ps.qd)) < 1e4)
        )
        healthy = healthy & sane
        reward = (
            self.forward_reward_weight * x_velocity
            - ctrl_cost
            + self.healthy_reward * healthy.astype(x_velocity.dtype)
        )
        reward = jnp.where(sane, reward, 0.0)
        terminated = jnp.logical_not(healthy)
        info: Dict[str, jax.Array] = {"x_velocity": x_velocity}
        obs = self._obs(ps, action)
        # non-finite obs would ride through valid-masked losses as 0*nan=nan
        obs = jnp.where(jnp.isfinite(obs), obs, 0.0)
        return ps, obs, reward, terminated, info


class HopperEnv(LocomotionEnv):
    """Hopper-v4 conventions (gymnasium/envs/mujoco/hopper_v4.py semantics)."""

    asset = "hopper.xml"
    frame_skip = 4
    ctrl_cost_weight = 1e-3
    healthy_reward = 1.0
    reset_noise_scale = 5e-3

    def _healthy(self, ps: PhysicsState) -> jax.Array:
        state = jnp.concatenate([ps.q[2:], ps.qd])
        healthy_state = jnp.all(jnp.abs(state) < 100.0)
        healthy_z = ps.q[1] > 0.7
        healthy_angle = jnp.abs(ps.q[2]) < 0.2
        return healthy_state & healthy_z & healthy_angle

    def _healthy_from_obs(self, obs: jax.Array) -> jax.Array:
        # obs = q[1:] ++ clipped qd: obs[0]=z, obs[1]=angle, obs[2:]=rest
        healthy_state = jnp.all(jnp.abs(obs[1:]) < 100.0)
        return healthy_state & (obs[0] > 0.7) & (jnp.abs(obs[1]) < 0.2)


class Walker2dEnv(LocomotionEnv):
    """Walker2d-v4 conventions."""

    asset = "walker2d.xml"
    frame_skip = 4
    ctrl_cost_weight = 1e-3
    healthy_reward = 1.0
    reset_noise_scale = 5e-3

    def _healthy(self, ps: PhysicsState) -> jax.Array:
        z, angle = ps.q[1], ps.q[2]
        return (z > 0.8) & (z < 2.0) & (jnp.abs(angle) < 1.0)

    def _healthy_from_obs(self, obs: jax.Array) -> jax.Array:
        # obs = q[1:] ++ clipped qd: obs[0]=z, obs[1]=torso angle
        return (obs[0] > 0.8) & (obs[0] < 2.0) & (jnp.abs(obs[1]) < 1.0)


class HalfCheetahEnv(LocomotionEnv):
    """HalfCheetah-v4 conventions (no termination, ctrl cost 0.1)."""

    asset = "half_cheetah.xml"
    frame_skip = 5
    ctrl_cost_weight = 0.1
    healthy_reward = 0.0
    reset_noise_scale = 0.1
    reset_vel_noise = "normal"
    clip_qvel_obs = None
    n_substeps = 2  # dt=0.01 with ~1kg limbs needs a finer contact substep


class SwimmerEnv(LocomotionEnv):
    """Swimmer-v4 conventions (fluid-driven, ctrl cost 1e-4)."""

    asset = "swimmer.xml"
    frame_skip = 4
    ctrl_cost_weight = 1e-4
    healthy_reward = 0.0
    reset_noise_scale = 0.1
    exclude_positions = 2
    clip_qvel_obs = None


class AntEnv(LocomotionEnv):
    """Ant-v4 conventions (27-dim obs, no contact-force obs/cost)."""

    asset = "ant.xml"
    frame_skip = 5
    ctrl_cost_weight = 0.5
    healthy_reward = 1.0
    reset_noise_scale = 0.1
    reset_vel_noise = "normal"
    exclude_positions = 2
    clip_qvel_obs = None
    n_substeps = 4  # dt=0.01 with 0.04kg limbs: penalty contacts need ~2.5ms

    def _healthy(self, ps: PhysicsState) -> jax.Array:
        z = ps.q[2]
        finite = jnp.all(jnp.isfinite(ps.q)) & jnp.all(jnp.isfinite(ps.qd))
        return finite & (z > 0.2) & (z < 1.0)

    def _healthy_from_obs(self, obs: jax.Array) -> jax.Array:
        # obs = q[2:] ++ qd: obs[0]=z; finiteness checked over the obs
        finite = jnp.all(jnp.isfinite(obs))
        return finite & (obs[0] > 0.2) & (obs[0] < 1.0)


class HumanoidEnv(LocomotionEnv):
    """Humanoid-v4 task conventions on the 3-D humanoid model.

    Reward/termination follow gymnasium humanoid_v4 (forward_reward_weight
    1.25 on the CENTER-OF-MASS x velocity, healthy_reward 5.0, ctrl cost
    0.1, healthy z in (1.0, 2.0); the tiny v4 contact cost is omitted —
    contact forces here come from the penalty model). The default
    observation is gym's full 376-dim stack [qpos[2:], qvel, cinert, cvel,
    qfrc_actuator, cfrc_ext] (com-based features parity-tested vs CPU
    MuJoCo in tests/test_comfeat.py; cfrc_ext uses our penalty contact
    wrenches). ``obs_mode="compact"`` keeps the 45-dim [qpos[2:], qvel].
    """

    asset = "humanoid.xml"
    frame_skip = 5
    forward_reward_weight = 1.25
    ctrl_cost_weight = 0.1
    healthy_reward = 5.0
    reset_noise_scale = 1e-2
    exclude_positions = 2
    clip_qvel_obs = None
    n_substeps = 2  # dt=0.003 with ~0.5kg hands: finer contact substep

    def __init__(self, horizon: int = 1000, asset_path=None, obs_mode="gym"):
        super().__init__(horizon=horizon, asset_path=asset_path)
        self.obs_mode = obs_mode
        if obs_mode == "gym":
            from mjrl_tpu.physics.comfeat import body_links

            nb = body_links(self.model).size + 1  # + world row
            self.spec = EnvSpec(
                observation_dim=self.spec.observation_dim + 22 * nb + self.model.nv,
                action_dim=self.spec.action_dim,
                horizon=self.spec.horizon,
            )

    def _obs(self, ps: PhysicsState, action=None) -> jax.Array:
        base = super()._obs(ps)
        if self.obs_mode != "gym":
            return base
        from mjrl_tpu.physics.comfeat import com_features
        from mjrl_tpu.physics.contact import contact_forces
        from mjrl_tpu.physics.engine import compute_kinematics

        kin = compute_kinematics(self.model, ps)
        f_ext = contact_forces(self.model, kin) if self.model.contact_pairs else None
        cinert, cvel, qfrc_act, cfrc = com_features(
            self.model, kin, ps, action, f_ext_world=f_ext
        )
        return jnp.concatenate(
            [base, cinert.ravel(), cvel.ravel(), qfrc_act, cfrc.ravel()]
        )

    def _healthy(self, ps: PhysicsState) -> jax.Array:
        z = ps.q[2]
        return (z > 1.0) & (z < 2.0)

    def _healthy_from_obs(self, obs: jax.Array) -> jax.Array:
        # both obs modes lead with qpos[2:]: obs[0]=z
        return (obs[0] > 1.0) & (obs[0] < 2.0)

    def _x_pos(self, ps: PhysicsState) -> jax.Array:
        # gym humanoid measures forward progress of the mass center
        from mjrl_tpu.physics.engine import forward_kinematics

        pos, quat, _ = forward_kinematics(self.model, ps.q)
        import mjrl_tpu.physics.math3d as m3

        com = pos + m3.quat_rotate(quat, jnp.asarray(self.model.link_com))
        mass = jnp.asarray(self.model.link_mass)
        return jnp.sum(mass * com[:, 0]) / jnp.sum(mass)


register("humanoid", HumanoidEnv)
register("hopper", HopperEnv)
register("walker2d", Walker2dEnv)
register("half_cheetah", HalfCheetahEnv)
register("swimmer", SwimmerEnv)
register("ant", AntEnv)

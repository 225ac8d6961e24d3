"""Adroit dexterous-hand tasks (relocate / hammer / door / pen) on the
first-party engine.

These are the DAPG paper's environments (Rajeswaran et al., RSS 2018 —
"Learning Complex Dexterous Manipulation with Deep RL and Demonstrations"),
the workloads the reference library was built to train via BC + demo-
augmented NPG (reference: mjrl/algos/dapg.py + hand_dapg job scripts).
Models are the original ADROIT MJCF assets shipped with the installed
gymnasium-robotics wheel, compiled through the mujoco front-end bridge
(physics/bridge.py) into the pure-JAX engine: 30-dof hand+arm, affine
position servos, coupled-finger fixed tendons, capsule/box contact set.

Task semantics (observation layout, action scaling to [-1, 1], dense reward
shaping, success predicates, scene randomization on reset) follow the
original mj_envs/hand_dapg definitions, which the gymnasium-robotics v1
envs reproduce up to a documented sign change on the reach term
(gymnasium-robotics PR #220); ``reward_variant='dapg'`` (default) uses the
original signs. Scene randomization (MuJoCo-side per-episode mutation of
``body_pos``/``site_pos``) maps to per-env ``link_pos_delta`` offsets and
state-carried target vectors — pure data, no model mutation, so thousands
of randomized instances batch under ``vmap``.
"""

from __future__ import annotations

import os
from typing import Dict, NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from mjrl_tpu.envs.base import Env, StepResult, register
from mjrl_tpu.physics import PhysicsState
from mjrl_tpu.physics import math3d as m3
from mjrl_tpu.physics.engine import (
    compute_kinematics,
    scale_limit_penalties,
    site_positions,
    step as physics_step,
)
from mjrl_tpu.types import EnvSpec


def _adroit_asset(task: str) -> str:
    import gymnasium_robotics

    return os.path.join(
        os.path.dirname(gymnasium_robotics.__file__),
        "envs",
        "assets",
        "adroit_hand",
        f"adroit_{task}.xml",
    )


class AdroitState(NamedTuple):
    ps: PhysicsState
    link_delta: jax.Array  # (nlink, 3) per-episode body-pos offsets
    target: jax.Array  # task target vector (position or orientation)


class AdroitEnv(Env):
    """Shared machinery: model compilation, action scaling, site lookups."""

    task: str
    frame_skip: int = 5
    default_horizon: int = 200
    reward_variant: str = "dapg"  # 'dapg' (original signs) | 'gymnasium_v1'

    def __init__(
        self,
        horizon: Optional[int] = None,
        reward_variant: Optional[str] = None,
        constraint_solver: str = "penalty",
        use_soa: Optional[bool] = None,
    ):
        from mjrl_tpu.physics.bridge import load_mj_model, model_from_mujoco

        if reward_variant is not None:
            self.reward_variant = reward_variant
        mj = load_mj_model(_adroit_asset(self.task))
        self._apply_gain_overrides(mj)
        self.model = model_from_mujoco(mj)
        # 'newton' = MuJoCo-parity constraint solve for CONTACTS and joint
        # limits (engine csolve path — adroit cannot ride SoA: tendons +
        # box-box pairs). Tendon springs/limits remain penalty passive
        # forces in either mode (MuJoCo treats spring tendons passively
        # too; tendon-LIMIT rows are the approximation — documented).
        self.model.constraint_solver = constraint_solver
        # penalty-model tuning for gram-scale fingers + hectogram objects:
        # k from "object weight compresses ~2mm", response freq ~sqrt(k/m_tip)
        # kept below the 2ms substep's stability bound; limits per-dof scaled
        self.model.contact_stiffness = 1000.0
        self.model.contact_damping = 6.0
        self.model.contact_depth_cap = 0.01
        self.model.friction_vel = 0.01
        self.model.n_substeps = 1
        scale_limit_penalties(self.model, omega=60.0)
        from mjrl_tpu.physics.dispatch import make_frame_stepper

        # ``use_soa=False`` (config: env_kwargs.use_soa) forces the per-env
        # engine under vmap (dispatch.py already keeps tendon models there).
        self._frame_step = make_frame_stepper(
            self.model, self.frame_skip, with_link_delta=True, use_soa=use_soa
        )
        self._site = {n: i for i, n in enumerate(self.model.site_name)}
        self._link = {n: i for i, n in enumerate(self.model.link_name)}
        self._jnt_q = {
            n: self.model.link_qadr[i]
            for i, n in enumerate(self.model.jnt_name)
            if n
        }
        rng = np.asarray(self.model.act_ctrlrange, np.float64)
        self._act_mean = jnp.asarray(0.5 * (rng[:, 0] + rng[:, 1]), jnp.float32)
        self._act_rng = jnp.asarray(0.5 * (rng[:, 1] - rng[:, 0]), jnp.float32)
        self.spec = EnvSpec(
            observation_dim=self.obs_dim,
            action_dim=self.model.nu,
            horizon=horizon or self.default_horizon,
        )

    @staticmethod
    def _apply_gain_overrides(mj) -> None:
        """The env-level servo retuning done by mj_envs/gymnasium at
        construction: wrist servos kp=10, finger servos kp=1."""
        import mujoco

        def aid(name):
            return mujoco.mj_name2id(mj, mujoco.mjtObj.mjOBJ_ACTUATOR, name)

        w0, w1 = aid("A_WRJ1"), aid("A_WRJ0")
        f0, f1 = aid("A_FFJ3"), aid("A_THJ0")
        mj.actuator_gainprm[w0 : w1 + 1, :3] = np.array([10, 0, 0])
        mj.actuator_biasprm[w0 : w1 + 1, :3] = np.array([0, -10, 0])
        mj.actuator_gainprm[f0 : f1 + 1, :3] = np.array([1, 0, 0])
        mj.actuator_biasprm[f0 : f1 + 1, :3] = np.array([0, -1, 0])

    # -- helpers ---------------------------------------------------------------
    def _body_root_link(self, name: str) -> int:
        """First expanded link of a (possibly multi-joint) body — the link
        carrying the body's parent-frame offset, where link_pos_delta acts."""
        idx = self._link[name]
        while True:
            p = self.model.link_parent[idx]
            if p >= 0 and self.model.link_name[p].startswith(name + "__stage"):
                idx = p
            else:
                return idx

    def _scaled_ctrl(self, action: jax.Array) -> jax.Array:
        a = jnp.clip(action, -1.0, 1.0)
        return self._act_mean + a * self._act_rng

    def _kin(self, st: AdroitState):
        return compute_kinematics(
            self.model, st.ps, link_pos_delta=st.link_delta
        )

    def _sites(self, kin) -> jax.Array:
        return site_positions(self.model, kin)

    def _physics(self, st: AdroitState, ctrl: jax.Array) -> PhysicsState:
        # routed through the batched-physics dispatcher
        # (physics/dispatch.py; the per-env engine path is this exact loop)
        q, qd = self._frame_step(st.ps.q, st.ps.qd, ctrl, st.link_delta)
        return PhysicsState(q=q, qd=qd)

    def _zero_state(self) -> Tuple[jax.Array, jax.Array]:
        q = jnp.asarray(self.model.default_qpos)
        qd = jnp.zeros(self.model.nv)
        return q, qd

    def _guard(self, ps: PhysicsState, reward, terminated, obs):
        """Blow-up guard (same rationale as locomotion.py): the stiff
        30-dof hand sits near the penalty model's f32 stability edge, and a
        single diverged env poisons the whole batch's returns with NaN.
        A diverged state terminates with zero reward and sanitized obs."""
        sane = (
            jnp.all(jnp.isfinite(ps.q))
            & jnp.all(jnp.isfinite(ps.qd))
            & (jnp.max(jnp.abs(ps.qd)) < 1e4)
        )
        reward = jnp.where(sane, reward, 0.0)
        terminated = jnp.logical_or(terminated, jnp.logical_not(sane))
        obs = jnp.where(jnp.isfinite(obs), obs, 0.0)
        return reward, terminated, obs

    @property
    def obs_dim(self) -> int:
        raise NotImplementedError


class AdroitRelocateEnv(AdroitEnv):
    """Move the blue ball to the target location (mj_envs relocate-v0).

    ``curriculum`` (default 0.0 = reference behavior) enables a
    reverse-curriculum reset: each episode blends the ball's initial
    position toward the target by ``u ~ U(0, curriculum)`` — at u=1 the
    ball starts midair AT the target (instant success region; it free-
    falls unless caught), intermediate u starts it part-way. Rationale:
    relocate is unsolvable from scratch (grasp discovery never happens
    under Gaussian exploration — RSS-2018 uses 25 human demos, which are
    not redistributable in this environment); near-solved inits make the
    +10/+20 goal bonuses sampled from iteration 0 so the value function
    carries signal back to harder inits, the same mechanism as the hammer
    nail curriculum above. All difficulty levels batched; one compile."""

    task = "relocate"

    def __init__(self, *args, curriculum: float = 0.0, **kwargs):
        super().__init__(*args, **kwargs)
        self.curriculum = float(curriculum)

    @property
    def obs_dim(self) -> int:
        return (self.model.nq - 6) + 9  # qpos[:-6] + three 3-vectors

    def _obs(self, st: AdroitState) -> jax.Array:
        kin = self._kin(st)
        sites = self._sites(kin)
        palm = sites[self._site["S_grasp"]]
        obj = kin.pos[self._link["Object"]]
        target = st.target
        return jnp.concatenate(
            [st.ps.q[:-6], palm - obj, palm - target, obj - target]
        )

    def reset(self, key: jax.Array) -> Tuple[AdroitState, jax.Array]:
        kx, ky, kt = jax.random.split(key, 3)
        q, qd = self._zero_state()
        delta = jnp.zeros((self.model.nlink, 3))
        obj_root = self._body_root_link("Object")
        dx = jax.random.uniform(kx, (), minval=-0.15, maxval=0.15)
        dy = jax.random.uniform(ky, (), minval=-0.15, maxval=0.3)
        base = jnp.asarray(self.model.link_pos[obj_root])
        delta = delta.at[obj_root, 0].set(dx - base[0])
        delta = delta.at[obj_root, 1].set(dy - base[1])
        target = jax.random.uniform(
            kt,
            (3,),
            minval=jnp.array([-0.2, -0.2, 0.15]),
            maxval=jnp.array([0.2, 0.2, 0.35]),
        )
        if self.curriculum > 0.0:
            # fold_in (not split) keeps the spawn/target streams bit-exact
            # with the curriculum=0 reference behavior
            ku = jax.random.fold_in(key, 1)
            u = jax.random.uniform(ku, (), maxval=self.curriculum)
            spawn = jnp.stack([dx, dy, base[2]])  # world pos at table spawn
            init = (1.0 - u) * spawn + u * target
            delta = delta.at[obj_root].set(init - base)
        st = AdroitState(PhysicsState(q=q, qd=qd), delta, target)
        return st, self._obs(st)

    def step(self, st: AdroitState, action: jax.Array) -> StepResult:
        ps = self._physics(st, self._scaled_ctrl(action))
        st = st._replace(ps=ps)
        kin = self._kin(st)
        sites = self._sites(kin)
        palm = sites[self._site["S_grasp"]]
        obj = kin.pos[self._link["Object"]]
        target = st.target
        goal_dist = jnp.linalg.norm(obj - target)
        reach = jnp.linalg.norm(palm - obj)
        sign = -0.1 if self.reward_variant == "dapg" else 0.1
        lifted = obj[2] > 0.04
        reward = (
            sign * reach
            + jnp.where(
                lifted,
                1.0
                - 0.5 * jnp.linalg.norm(palm - target)
                - 0.5 * goal_dist,
                0.0,
            )
            + jnp.where(goal_dist < 0.1, 10.0, 0.0)
            + jnp.where(goal_dist < 0.05, 20.0, 0.0)
        )
        success = goal_dist < 0.1
        info: Dict[str, jax.Array] = {"success": success}
        obs = self._obs(st)
        reward, terminated, obs = self._guard(ps, reward, jnp.zeros((), bool), obs)
        return st, obs, reward, terminated, info


class AdroitHammerEnv(AdroitEnv):
    """Drive the nail into the board with the hammer (mj_envs hammer-v0).

    ``nail_init_max`` (default 0.0 = reference behavior) enables a
    reverse-curriculum reset: each episode initializes the nail already
    driven in by ``U(0, nail_init_max) * 0.081`` m of its 0.081 m
    success travel. Rationale: the paper-budget scratch campaign
    (runs/adroit_hammer_npg3, 2.05e8 samples) showed the strike event is
    NEVER sampled once by Gaussian exploration from the hold-aloft
    optimum — a pure exploration failure, not a sample-budget one.
    Episodes that start one tap from success make the +25/+75 drive-in
    bonuses reachable, and value bootstrapping propagates the strike
    backward to harder inits; annealing ``nail_init_max`` to 0 across
    resume stages restores the true task metric. Curriculum levels are
    per-episode data (a q init), so all levels batch under vmap."""

    task = "hammer"
    # success travel of the nail_dir slide joint: goal_dist 0.091 -> <0.01
    _NAIL_TRAVEL = 0.081

    def __init__(self, *args, nail_init_max: float = 0.0, **kwargs):
        super().__init__(*args, **kwargs)
        self.nail_init_max = float(nail_init_max)

    @property
    def obs_dim(self) -> int:
        return (self.model.nq - 6) + 6 + 3 + 3 + 3 + 3 + 1  # 46

    def _nail_impact(self, kin) -> jax.Array:
        """Touch-sensor stand-in: normal contact force magnitude on the nail
        link (reference sensor S_nail), clipped like the gym env does."""
        from mjrl_tpu.physics.contact import contact_forces

        if "nail" not in self._link:
            return jnp.zeros(())
        f = contact_forces(self.model, kin)[self._link["nail"]]
        return jnp.clip(jnp.linalg.norm(f[3:]), -1.0, 1.0)

    def _obs_parts(self, st: AdroitState):
        kin = self._kin(st)
        sites = self._sites(kin)
        palm = sites[self._site["S_grasp"]]
        obj = kin.pos[self._link["Object"]]
        obj_rot = m3.quat_to_euler(kin.quat[self._link["Object"]])
        nail = sites[self._site["S_target"]]
        return kin, sites, palm, obj, obj_rot, nail

    def _obs(self, st: AdroitState) -> jax.Array:
        kin, sites, palm, obj, obj_rot, nail = self._obs_parts(st)
        qv = jnp.clip(st.ps.qd, -1.0, 1.0)
        return jnp.concatenate(
            [
                st.ps.q[:-6],
                qv[-6:],
                palm,
                obj,
                obj_rot,
                nail,
                self._nail_impact(kin)[None],
            ]
        )

    def reset(self, key: jax.Array) -> Tuple[AdroitState, jax.Array]:
        q, qd = self._zero_state()
        delta = jnp.zeros((self.model.nlink, 3))
        board_root = self._body_root_link("nail_board")
        bz = jax.random.uniform(key, (), minval=0.1, maxval=0.25)
        base = jnp.asarray(self.model.link_pos[board_root])
        delta = delta.at[board_root, 2].set(bz - base[2])
        if self.nail_init_max > 0.0:
            # fold_in (not split) keeps the board-height stream bit-exact
            # with the nail_init_max=0 reference behavior
            kn = jax.random.fold_in(key, 1)
            depth = jax.random.uniform(
                kn, (), maxval=self.nail_init_max * self._NAIL_TRAVEL
            )
            q = q.at[self._jnt_q["nail_dir"]].set(depth)
        st = AdroitState(
            PhysicsState(q=q, qd=qd), delta, jnp.zeros(3)
        )
        return st, self._obs(st)

    def step(self, st: AdroitState, action: jax.Array) -> StepResult:
        ps = self._physics(st, self._scaled_ctrl(action))
        st = st._replace(ps=ps)
        kin, sites, palm, obj, obj_rot, nail = self._obs_parts(st)
        head = sites[self._site["tool"]]
        goal = sites[self._site["nail_goal"]]
        goal_dist = jnp.linalg.norm(nail - goal)
        sign = -0.1 if self.reward_variant == "dapg" else 0.1
        reward = (
            sign * jnp.linalg.norm(palm - obj)
            - jnp.linalg.norm(head - nail)
            - 10.0 * goal_dist
            - 1e-2 * jnp.linalg.norm(st.ps.qd)
            + jnp.where((obj[2] > 0.04) & (head[2] > 0.04), 2.0, 0.0)
            + jnp.where(goal_dist < 0.020, 25.0, 0.0)
            + jnp.where(goal_dist < 0.010, 75.0, 0.0)
        )
        success = goal_dist < 0.01
        qv = jnp.clip(st.ps.qd, -1.0, 1.0)
        obs = jnp.concatenate(
            [
                st.ps.q[:-6],
                qv[-6:],
                palm,
                obj,
                obj_rot,
                nail,
                self._nail_impact(kin)[None],
            ]
        )
        reward, terminated, obs = self._guard(ps, reward, jnp.zeros((), bool), obs)
        return st, obs, reward, terminated, {"success": success}


class AdroitDoorEnv(AdroitEnv):
    """Undo the latch and swing the door open (mj_envs door-v0)."""

    task = "door"

    @property
    def obs_dim(self) -> int:
        # qpos[1:-2] + latch + door + palm + handle + (palm-handle) + open flag
        return (self.model.nq - 3) + 1 + 1 + 3 + 3 + 3 + 1  # 39 for nq=30

    def _obs(self, st: AdroitState) -> jax.Array:
        kin = self._kin(st)
        sites = self._sites(kin)
        palm = sites[self._site["S_grasp"]]
        handle = sites[self._site["S_handle"]]
        q = st.ps.q
        door_pos = q[self._jnt_q["door_hinge"]]
        latch_pos = q[-1]
        door_open = jnp.where(door_pos > 1.0, 1.0, -1.0)
        return jnp.concatenate(
            [
                q[1:-2],
                latch_pos[None],
                door_pos[None],
                palm,
                handle,
                palm - handle,
                door_open[None],
            ]
        )

    def reset(self, key: jax.Array) -> Tuple[AdroitState, jax.Array]:
        kx, ky, kz = jax.random.split(key, 3)
        q, qd = self._zero_state()
        delta = jnp.zeros((self.model.nlink, 3))
        root = self._body_root_link("frame")
        base = jnp.asarray(self.model.link_pos[root])
        bx = jax.random.uniform(kx, (), minval=-0.3, maxval=-0.2)
        by = jax.random.uniform(ky, (), minval=0.25, maxval=0.35)
        bz = jax.random.uniform(kz, (), minval=0.252, maxval=0.35)
        delta = delta.at[root].set(jnp.stack([bx, by, bz]) - base)
        st = AdroitState(PhysicsState(q=q, qd=qd), delta, jnp.zeros(3))
        return st, self._obs(st)

    def step(self, st: AdroitState, action: jax.Array) -> StepResult:
        ps = self._physics(st, self._scaled_ctrl(action))
        st = st._replace(ps=ps)
        kin = self._kin(st)
        sites = self._sites(kin)
        palm = sites[self._site["S_grasp"]]
        handle = sites[self._site["S_handle"]]
        door_pos = st.ps.q[self._jnt_q["door_hinge"]]
        sign = -0.1 if self.reward_variant == "dapg" else 0.1
        reward = (
            sign * jnp.linalg.norm(palm - handle)
            - 0.1 * (door_pos - 1.57) ** 2
            - 1e-5 * jnp.sum(st.ps.qd**2)
            + jnp.where(door_pos > 0.2, 2.0, 0.0)
            + jnp.where(door_pos > 1.0, 8.0, 0.0)
            + jnp.where(door_pos > 1.35, 10.0, 0.0)
        )
        success = door_pos > 1.35
        obs = self._obs(st)
        reward, terminated, obs = self._guard(ps, reward, jnp.zeros((), bool), obs)
        return st, obs, reward, terminated, {"success": success}


class AdroitPenEnv(AdroitEnv):
    """Reorient the pen in-hand to a target orientation (mj_envs pen-v0)."""

    task = "pen"
    default_horizon = 100

    def __init__(self, horizon: Optional[int] = None, **kw):
        super().__init__(horizon=horizon, **kw)
        # static geometry: pen axis from its two sites (rigid -> constant
        # length); target sites give the nominal direction the sampled
        # orientation rotates
        sp = self.model.site_pos
        ot, ob = self._site["object_top"], self._site["object_bottom"]
        tt, tb = self._site["target_top"], self._site["target_bottom"]
        self._pen_axis_local = sp[ot] - sp[ob]
        self._pen_len = float(np.linalg.norm(self._pen_axis_local))
        self._tar_dir_local = (sp[tt] - sp[tb]) / max(
            float(np.linalg.norm(sp[tt] - sp[tb])), 1e-9
        )

    @property
    def obs_dim(self) -> int:
        return (self.model.nq - 6) + 3 + 6 + 3 + 3 + 3 + 3  # 45 for nq=30

    def _orien(self, kin) -> jax.Array:
        q_obj = kin.quat[self._link["Object"]]
        return m3.quat_rotate(q_obj, jnp.asarray(self._pen_axis_local)) / self._pen_len

    def _obs(self, st: AdroitState) -> jax.Array:
        kin = self._kin(st)
        sites = self._sites(kin)
        obj = kin.pos[self._link["Object"]]
        desired_pos = sites[self._site["eps_ball"]]
        obj_orien = self._orien(kin)
        desired_orien = st.target
        return jnp.concatenate(
            [
                st.ps.q[:-6],
                obj,
                st.ps.qd[-6:],
                obj_orien,
                desired_orien,
                obj - desired_pos,
                obj_orien - desired_orien,
            ]
        )

    def reset(self, key: jax.Array) -> Tuple[AdroitState, jax.Array]:
        kx, ky = jax.random.split(key)
        q, qd = self._zero_state()
        ex = jax.random.uniform(kx, (), minval=-1.0, maxval=1.0)
        ey = jax.random.uniform(ky, (), minval=-1.0, maxval=1.0)
        quat = m3.quat_from_zaxis_angle_deg(
            jnp.stack([ex, ey, jnp.zeros(())]) * (180.0 / jnp.pi)
        )
        desired = m3.quat_rotate(quat, jnp.asarray(self._tar_dir_local))
        st = AdroitState(
            PhysicsState(q=q, qd=qd),
            jnp.zeros((self.model.nlink, 3)),
            desired,
        )
        return st, self._obs(st)

    def step(self, st: AdroitState, action: jax.Array) -> StepResult:
        ps = self._physics(st, self._scaled_ctrl(action))
        st = st._replace(ps=ps)
        kin = self._kin(st)
        sites = self._sites(kin)
        obj = kin.pos[self._link["Object"]]
        desired_loc = sites[self._site["eps_ball"]]
        obj_orien = self._orien(kin)
        desired_orien = st.target
        goal_dist = jnp.linalg.norm(obj - desired_loc)
        similarity = jnp.dot(obj_orien, desired_orien)
        reward = (
            -goal_dist
            + similarity
            + jnp.where((goal_dist < 0.075) & (similarity > 0.9), 10.0, 0.0)
            + jnp.where((goal_dist < 0.075) & (similarity > 0.95), 50.0, 0.0)
            - jnp.where(obj[2] < 0.075, 5.0, 0.0)
        )
        success = (goal_dist < 0.075) & (similarity > 0.95)
        obs = self._obs(st)
        reward, terminated, obs = self._guard(ps, reward, jnp.zeros((), bool), obs)
        return st, obs, reward, terminated, {"success": success}


register("adroit_relocate", AdroitRelocateEnv)
register("adroit_hammer", AdroitHammerEnv)
register("adroit_door", AdroitDoorEnv)
register("adroit_pen", AdroitPenEnv)

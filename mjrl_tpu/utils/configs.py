"""Typed run configs + factory: config dict/JSON -> env/policy/baseline/agent.

Capability twin of the reference's job-script config plumbing (reference:
examples/policy_opt_job_script.py — a Python/JSON dict of hyperparameters
passed to ctors by name). Hyperparameter names match the reference
(SURVEY.md §5.6) so parity audits can diff configs side by side; the config
of record is serialized to ``job_dir/config.json``.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict, Optional, Tuple

from mjrl_tpu import envs
from mjrl_tpu.algos import DAPG, NPG, PPO, TRPO, BatchREINFORCE, ModelAccelNPG
from mjrl_tpu.models import (
    GaussianLinear,
    GaussianMLP,
    LinearBaseline,
    MLPBaseline,
    QuadraticBaseline,
    ZeroBaseline,
)

ALGOS = {
    "reinforce": BatchREINFORCE,
    "npg": NPG,
    "trpo": TRPO,
    "ppo": PPO,
    "dapg": DAPG,
    "model_npg": ModelAccelNPG,
}
BASELINES = {
    "zero": ZeroBaseline,
    "linear": LinearBaseline,
    "quadratic": QuadraticBaseline,
    "mlp": MLPBaseline,
}
POLICIES = {"mlp": GaussianMLP, "linear": GaussianLinear}


@dataclasses.dataclass
class RunConfig:
    """One training run. Field names follow the reference's hyperparameters."""

    env_name: str = "point_mass"
    env_kwargs: Dict[str, Any] = dataclasses.field(default_factory=dict)
    algorithm: str = "npg"
    seed: int = 0
    niter: int = 100
    # policy
    policy: str = "mlp"
    hidden_sizes: Tuple[int, ...] = (64, 64)
    init_log_std: float = 0.0
    min_log_std: float = -3.0
    # baseline
    baseline: str = "quadratic"
    baseline_kwargs: Dict[str, Any] = dataclasses.field(default_factory=dict)
    # sampling
    num_traj: int = 64
    num_samples: Optional[int] = None
    sample_mode: str = "trajectories"
    horizon: Optional[int] = None
    # algorithm hyperparameters (reference names)
    gamma: float = 0.995
    gae_lambda: Optional[float] = 0.97
    agent_kwargs: Dict[str, Any] = dataclasses.field(default_factory=dict)
    # demonstrations (DAPG stage 2 / BC warm start — reference:
    # mjrl/algos/dapg.py ctor demo_paths + hand_dapg job scripts, which load
    # a pickled list of path dicts and run BC before DAPG)
    demo_file: Optional[str] = None
    bc_init: bool = False
    bc_kwargs: Dict[str, Any] = dataclasses.field(default_factory=dict)
    # warm start from another run's latest checkpoint: carries policy
    # params/old_params/transforms + baseline_state into a FRESH train state
    # (optimizer/iteration/running_score reset). The cross-run analogue of
    # the reference's pickle-a-policy-and-hand-it-to-the-next-job-script
    # pattern (hand_dapg: expert pickle -> demo/eval scripts); here it also
    # powers staged curricula (e.g. hammer nail-depth anneal stages).
    init_policy_from: Optional[str] = None
    # observation normalization: install in_shift/in_scale transforms from a
    # random-policy rollout at init (the same transform machinery BC uses;
    # needed for wide-magnitude observation stacks like humanoid's 376-dim
    # cinert/cvel features, where raw-obs MLPs barely train)
    obs_norm: bool = False
    # parallelism: shard the env axis over a mesh of this many devices
    # (0 = no mesh)
    mesh_devices: int = 0
    # harness
    save_freq: int = 10
    evaluation_rollouts: int = 0
    plot_keys: Tuple[str, ...] = ("stoc_pol_mean", "running_score")

    def to_json(self, path: str) -> None:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            json.dump(dataclasses.asdict(self), f, indent=2, default=list)

    @classmethod
    def from_json(cls, path: str) -> "RunConfig":
        with open(path) as f:
            raw = json.load(f)
        return cls.from_dict(raw)

    @classmethod
    def from_dict(cls, raw: Dict[str, Any]) -> "RunConfig":
        fields = {f.name for f in dataclasses.fields(cls)}
        unknown = set(raw) - fields
        if unknown:
            raise ValueError(f"Unknown config keys: {sorted(unknown)}")
        cfg = cls(**raw)
        for name in ("hidden_sizes", "plot_keys"):
            setattr(cfg, name, tuple(getattr(cfg, name)))
        return cfg


def build(cfg: RunConfig):
    """Construct (env, policy, baseline, agent) from a config."""
    mesh = None
    if cfg.mesh_devices:
        from mjrl_tpu.parallel import make_mesh

        mesh = make_mesh(cfg.mesh_devices)
    env = envs.make(cfg.env_name, **cfg.env_kwargs)
    demo_batch = None
    if cfg.demo_file is not None:
        from mjrl_tpu.utils.demos import load_demo_pickle

        demo_batch = load_demo_pickle(cfg.demo_file)
    pol_cls = POLICIES[cfg.policy]
    pol_kwargs: Dict[str, Any] = dict(
        min_log_std=cfg.min_log_std, init_log_std=cfg.init_log_std
    )
    if cfg.policy == "mlp":
        pol_kwargs["hidden_sizes"] = cfg.hidden_sizes
    policy = pol_cls(env.spec, **pol_kwargs)
    baseline = BASELINES[cfg.baseline](env.spec, **cfg.baseline_kwargs)
    agent_kwargs = dict(cfg.agent_kwargs)
    if cfg.algorithm == "dapg":
        if demo_batch is None:
            raise ValueError("algorithm 'dapg' requires demo_file")
        agent_kwargs["demo_batch"] = demo_batch
    agent = ALGOS[cfg.algorithm](
        env,
        policy,
        baseline,
        num_traj=cfg.num_traj,
        num_samples=cfg.num_samples,
        sample_mode=cfg.sample_mode,
        horizon=cfg.horizon,
        gamma=cfg.gamma,
        gae_lambda=cfg.gae_lambda,
        mesh=mesh,
        **agent_kwargs,
    )
    return env, policy, baseline, agent


def policy_warm_start(cfg: RunConfig, agent, seed: int = 0):
    """Seed a fresh train state with another run's latest-checkpoint policy
    (+ transforms + baseline). Architectures must match; optimizer state,
    iteration, and running_score start fresh so the new run's metrics are
    its own."""
    import jax

    from mjrl_tpu.utils.checkpoint import CheckpointManager

    state = agent.init(jax.random.PRNGKey(seed))
    src = CheckpointManager(cfg.init_policy_from)
    restored = src.restore_latest(jax.device_get(state))
    if restored is None:
        raise FileNotFoundError(
            f"init_policy_from: no checkpoint under {cfg.init_policy_from}"
        )
    print(
        f"Policy warm start from {cfg.init_policy_from} "
        f"iteration {int(restored.iteration)}"
    )
    return state.replace(
        params=restored.params,
        old_params=jax.tree.map(jax.numpy.copy, restored.params),
        transforms=restored.transforms,
        baseline_state=restored.baseline_state,
    )


def obs_norm_init(agent, state, key, scale_min: float = 1e-2):
    """Set policy in_shift/in_scale from a random-policy rollout batch.

    One-shot (not running) statistics keep the policy stationary for the
    on-policy ratio machinery; masked over valid steps. ``scale_min`` guards
    constant observation channels.
    """
    import jax
    import jax.numpy as jnp

    batch = jax.jit(agent._sample_batch_inner)(state, key)
    obs = batch.observations.reshape(-1, batch.observations.shape[-1])
    w = batch.valid.reshape(-1).astype(obs.dtype)[:, None]
    n = jnp.maximum(w.sum(), 1.0)
    mean = (obs * w).sum(0) / n
    var = (jnp.square(obs - mean) * w).sum(0) / n
    scale = jnp.maximum(jnp.sqrt(var), scale_min)
    transforms = {**state.transforms, "in_shift": mean, "in_scale": scale}
    return state.replace(transforms=transforms)


def warm_start(cfg: RunConfig, agent, policy, seed: int = 0, state=None):
    """BC warm start (DAPG stage 1): returns the agent's initial state with
    policy params/transforms fit to the demos (reference: BC.train() before
    DAPG iterations in the hand_dapg job scripts). ``state`` (optional)
    starts BC from an existing train state — e.g. the result of
    ``policy_warm_start`` when a config combines ``init_policy_from`` with
    ``bc_init`` — instead of a fresh ``agent.init``."""
    import jax

    from mjrl_tpu.algos.bc import BC
    from mjrl_tpu.utils.demos import load_demo_pickle

    if cfg.demo_file is None:
        raise ValueError("bc_init requires demo_file")
    demo_batch = load_demo_pickle(cfg.demo_file)
    bc = BC(demo_batch, policy, **cfg.bc_kwargs)
    if state is None:
        state = agent.init(jax.random.PRNGKey(seed))
    params, transforms, metrics = jax.jit(bc.train)(
        state.params, state.transforms, jax.random.fold_in(jax.random.PRNGKey(seed), 1)
    )
    print(
        f"BC warm start: loss {float(metrics['loss_before']):.5f} -> "
        f"{float(metrics['loss_after']):.5f}"
    )
    return state.replace(
        params=params,
        old_params=jax.tree.map(jax.numpy.copy, params),
        transforms=transforms,
    )

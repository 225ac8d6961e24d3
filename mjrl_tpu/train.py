"""CLI: ``python -m mjrl_tpu.train --output <dir> --config <cfg.json>``.

Capability twin of the reference's job script (reference:
examples/policy_opt_job_script.py): build env/policy/baseline/agent from a
JSON config, run ``train_agent``. Inline overrides: ``--set key=value``.
"""

from __future__ import annotations

import argparse
import json
import os

from mjrl_tpu.utils.configs import (
    RunConfig,
    build,
    obs_norm_init,
    policy_warm_start,
    warm_start,
)
from mjrl_tpu.utils.runtime import enable_compile_cache
from mjrl_tpu.utils.train_agent import train_agent


def run_job(cfg: RunConfig, output: str, max_retries: int = 3):
    """Build env/policy/baseline/agent from a config and train into
    ``output``; returns the final agent state. Reentrant: safe to call
    several times in one process. ``max_retries`` is passed to
    ``train_agent`` (0 makes a device error fail the run at once)."""
    cfg.to_json(os.path.join(output, "config.json"))
    _, policy, _, agent = build(cfg)
    init_state = None
    if cfg.init_policy_from:
        init_state = policy_warm_start(cfg, agent, seed=cfg.seed)
    if cfg.bc_init:
        # threads a preceding init_policy_from state through so BC
        # fine-tunes the restored policy rather than a fresh init
        init_state = warm_start(
            cfg, agent, policy, seed=cfg.seed, state=init_state
        )
    if cfg.obs_norm:
        import jax

        init_state = obs_norm_init(
            agent,
            init_state if init_state is not None else agent.init(
                jax.random.PRNGKey(cfg.seed)
            ),
            jax.random.fold_in(jax.random.PRNGKey(cfg.seed), 2),
        )
    return train_agent(
        output,
        agent,
        seed=cfg.seed,
        niter=cfg.niter,
        save_freq=cfg.save_freq,
        evaluation_rollouts=cfg.evaluation_rollouts,
        plot_keys=cfg.plot_keys,
        init_state=init_state,
        max_retries=max_retries,
    )


def load_config(config_path=None, overrides=()) -> RunConfig:
    raw = {}
    if config_path:
        with open(config_path) as f:
            raw = json.load(f)
    for kv in overrides:
        k, _, v = kv.partition("=")
        try:
            val = json.loads(v)
        except json.JSONDecodeError:
            val = v
        # dotted paths override inside dict-valued fields, e.g.
        # env_kwargs.curriculum=0.5 (the reference passes env_kwargs
        # through its job scripts the same way)
        node, parts = raw, k.split(".")
        for i, part in enumerate(parts[:-1]):
            if node.get(part) is None:
                node[part] = {}
            node = node[part]
            if not isinstance(node, dict):
                raise SystemExit(
                    f"cannot apply override {k!r}: "
                    f"{'.'.join(parts[: i + 1])!r} is "
                    f"{type(node).__name__}, not a dict"
                )
        node[parts[-1]] = val
    return RunConfig.from_dict(raw)


def main() -> None:
    p = argparse.ArgumentParser(description="mjrl_tpu policy optimization job")
    p.add_argument("--output", required=True, help="job directory")
    p.add_argument("--config", default=None, help="JSON config path")
    p.add_argument(
        "--set",
        nargs="*",
        default=[],
        metavar="KEY=VALUE",
        help="config overrides, JSON-parsed values (e.g. niter=50)",
    )
    args = p.parse_args()
    enable_compile_cache()
    run_job(load_config(args.config, args.set), args.output)


if __name__ == "__main__":
    main()

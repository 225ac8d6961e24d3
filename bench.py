"""Benchmark: fused NPG iteration throughput on the local accelerator.

Prints ONE JSON line ``{"metric", "value", "unit", "device", ...}``.

The timed work is the full fused training iteration on ant (on-device
physics rollout of 1024 ants x 100 control steps, GAE, CG natural-gradient
update, MLP-baseline fit) on the first-party engine. ``device`` names the
platform, device kind and count as JAX reports them and, on a GPU, the
card's name and power limit from ``nvidia-smi``.

Step accounting — BOTH definitions are reported (they differ because rows
whose episode terminates before the window ends are frozen/invalid for the
remainder of the window):

- ``value`` / ``valid_steps_per_sec``: VALID transitions per second — what
  mjrl counts over its variable-length paths (the training logs'
  ``steps_per_sec`` column uses the same definition).
- ``computed_steps_per_sec``: physics steps actually executed per second
  (num_envs x horizon x iters / dt), the hardware-utilization view.

Weak-scaling mode (BASELINE.json: >=80% scaling efficiency 1 -> N)::

    python bench.py --devices 4

uses the first ``N`` devices JAX sees and measures the SAME fused iteration
twice: a 1-device mesh at ``base_envs`` envs and an ``N``-device mesh at
``N x base_envs`` envs (weak scaling: work per device constant).
``efficiency = stepsN / (N * steps1)``. With ``JAX_PLATFORMS=cpu`` the
devices are ``N`` virtual CPU devices; that number validates the harness and
the sharding, not speed.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

_OUT_PATH = None


def _emit(obj) -> None:
    """Print the one-line JSON; append to --out as JSONL when given."""
    line = json.dumps(obj)
    print(line)
    if _OUT_PATH:
        with open(_OUT_PATH, "a") as f:
            f.write(line + "\n")


# On the CPU platform the weak-scaling mesh needs N virtual devices, which
# must be requested before the XLA backend initializes. Peek at argv rather
# than waiting for argparse.
if "--devices" in sys.argv and os.environ.get("JAX_PLATFORMS") == "cpu":
    _n = sys.argv[sys.argv.index("--devices") + 1]
    _flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in _flags:
        os.environ["XLA_FLAGS"] = (
            _flags + f" --xla_force_host_platform_device_count={_n}"
        )


def _device_record() -> dict:
    import jax

    dev = jax.devices()[0]
    rec = {
        "platform": dev.platform,
        "kind": dev.device_kind,
        "count": len(jax.devices()),
    }
    if dev.platform == "gpu":
        from mjrl_tpu.utils.runtime import gpu_card

        rec["card"] = gpu_card()
    return rec


def _build_agent(
    env_name: str,
    num_envs: int,
    horizon: int,
    mesh=None,
    solver: str = "penalty",
    n_substeps=None,
    sample_mode: str = "trajectories",
):
    from mjrl_tpu import envs
    from mjrl_tpu.algos import NPG
    from mjrl_tpu.models import GaussianMLP, MLPBaseline

    env_kwargs = {}
    if solver != "penalty":
        env_kwargs["constraint_solver"] = solver
    if n_substeps is not None:
        env_kwargs["n_substeps"] = n_substeps
    env = envs.make(env_name, horizon=horizon, **env_kwargs)
    policy = GaussianMLP(env.spec, hidden_sizes=(64, 64))
    baseline = MLPBaseline(env.spec, epochs=2, batch_size=1024)
    agent = NPG(
        env,
        policy,
        baseline,
        normalized_step_size=0.05,
        num_traj=num_envs,
        # samples mode: window length = horizon arg; episode horizon stays
        # the env's own (auto-reset handles termination)
        num_samples=num_envs * horizon if sample_mode == "samples" else None,
        horizon=env.spec.horizon if sample_mode == "samples" else horizon,
        sample_mode=sample_mode,
        mesh=mesh,
    )
    return agent


def _time_iters(agent, num_envs: int, horizon: int, iters: int):
    """Returns (computed_steps_per_sec, valid_steps_per_sec)."""
    import jax
    import jax.numpy as jnp

    state = agent.init(jax.random.PRNGKey(0))
    step = agent.jitted_train_step

    # Warmup: compile + 2 steady-state iterations.
    for i in range(3):
        state, metrics = step(state, jax.random.PRNGKey(i))
    jax.block_until_ready((state, metrics))

    # No host sync inside the window: sample counts stay on device and are
    # read once after it.
    sample_counts = []
    t0 = time.perf_counter()
    for i in range(iters):
        state, metrics = step(state, jax.random.PRNGKey(100 + i))
        sample_counts.append(metrics["num_samples"])
    jax.block_until_ready((state, sample_counts))
    dt = time.perf_counter() - t0
    valid = float(jnp.stack(sample_counts).sum())
    return num_envs * horizon * iters / dt, valid / dt


def bench_single_chip(args) -> None:
    num_envs, horizon = args.base_envs, args.horizon
    agent = _build_agent(
        args.env,
        num_envs,
        horizon,
        solver=args.solver,
        n_substeps=args.n_substeps,
        sample_mode=args.sample_mode,
    )
    computed, valid = _time_iters(agent, num_envs, horizon, args.iters)
    tag = "" if args.solver == "penalty" else f"_{args.solver}"
    _emit(
        {
            "metric": f"valid_env_steps_per_sec_{args.env}_npg_fused_iter{tag}",
            "value": round(valid, 1),
            "unit": "env-steps/s",
            "device": _device_record(),
            "valid_steps_per_sec": round(valid, 1),
            "computed_steps_per_sec": round(computed, 1),
            "solver": args.solver,
            "sample_mode": args.sample_mode,
        }
    )


def bench_weak_scaling(args) -> None:
    import jax

    from mjrl_tpu.parallel.mesh import make_mesh

    n = args.devices
    devices = jax.devices()
    if len(devices) < n:
        raise SystemExit(f"need {n} devices, JAX sees {len(devices)}")

    mesh1 = make_mesh(devices=devices[:1])
    computed1, valid1 = _time_iters(
        _build_agent(args.env, args.base_envs, args.horizon, mesh=mesh1),
        args.base_envs,
        args.horizon,
        args.iters,
    )
    meshN = make_mesh(devices=devices[:n])
    computedN, validN = _time_iters(
        _build_agent(args.env, n * args.base_envs, args.horizon, mesh=meshN),
        n * args.base_envs,
        args.horizon,
        args.iters,
    )
    efficiency = computedN / (n * computed1)
    _emit(
        {
            "metric": f"weak_scaling_efficiency_1_to_{n}_devices_{args.env}",
            "value": round(efficiency, 4),
            "unit": "fraction",
            "device": _device_record(),
            "devices": n,
            "base_envs_per_device": args.base_envs,
            "computed_steps_per_sec_1dev": round(computed1, 1),
            "computed_steps_per_sec_Ndev": round(computedN, 1),
            "valid_steps_per_sec_1dev": round(valid1, 1),
            "valid_steps_per_sec_Ndev": round(validN, 1),
        }
    )


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--devices", type=int, default=0,
                   help="weak-scaling mode: run 1-device and N-device meshes "
                        "(envs scale with devices) and report efficiency")
    p.add_argument("--env", default="ant")
    p.add_argument("--base-envs", type=int, default=None)
    p.add_argument("--horizon", type=int, default=None,
                   help="steps per env per iteration (episodes mode: the "
                        "episode horizon; samples mode: the window length)")
    p.add_argument("--iters", type=int, default=None)
    p.add_argument("--solver", default="penalty",
                   choices=["penalty", "newton"],
                   help="constraint physics: penalty fast path or "
                        "MuJoCo-parity Newton (the physics-faithful row)")
    p.add_argument("--n-substeps", type=int, default=None,
                   help="physics substeps per control dt (default: env's "
                        "own; newton runs use 1 = MuJoCo discretization)")
    p.add_argument("--sample-mode", default="trajectories",
                   choices=["trajectories", "samples"],
                   help="episodes (padded) vs auto-reset windows")
    p.add_argument("--out", default=None,
                   help="also append the JSON line to this file")
    args = p.parse_args()
    global _OUT_PATH
    _OUT_PATH = args.out

    from mjrl_tpu.utils.runtime import enable_compile_cache

    enable_compile_cache()
    if args.devices:
        # Small defaults: the weak-scaling pair runs two programs.
        args.base_envs = args.base_envs or 64
        args.horizon = args.horizon or 25
        args.iters = args.iters or 3
        bench_weak_scaling(args)
    else:
        args.base_envs = args.base_envs or 1024
        args.horizon = args.horizon or 100
        args.iters = args.iters or 10
        bench_single_chip(args)


if __name__ == "__main__":
    main()

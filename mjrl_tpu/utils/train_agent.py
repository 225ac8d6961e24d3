"""The training harness: host loop around the fused device train step.

Capability twin of the reference's ``train_agent`` (reference:
mjrl/utils/train_agent.py): per-iteration ``agent.train_step`` -> optional
deterministic evaluation rollouts -> best-policy tracking -> periodic
checkpoint + ``log.csv`` + ``train_curves.png`` -> tabulate table print, with
resume from the latest checkpoint.

Because the whole iteration is one jitted program, the host's only jobs are
feeding PRNG keys, reading back metric scalars (one device->host transfer
per iteration), logging, and checkpointing. Wall-clock accounting brackets
``block_until_ready`` so ``steps_per_sec`` (env-steps/s, the north-star
metric) is honest; the reference's per-phase timers (``time_sampling`` etc.)
collapse into ``time_step`` since the phases are fused. Set
``profile_dir`` to capture a ``jax.profiler`` trace of a few iterations
(SURVEY.md §5.1).
"""

from __future__ import annotations

import os
import time
from typing import Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from mjrl_tpu.algos.base import BatchREINFORCE
from mjrl_tpu.samplers.rollout import rollout_statistics
from mjrl_tpu.utils.checkpoint import CheckpointManager
from mjrl_tpu.utils.logger import DataLog
from mjrl_tpu.utils.plots import make_train_plots

try:
    from tabulate import tabulate
except ImportError:  # pragma: no cover
    tabulate = None


def train_agent(
    job_name: str,
    agent: BatchREINFORCE,
    seed: int = 0,
    niter: int = 101,
    save_freq: int = 10,
    evaluation_rollouts: int = 0,
    plot_keys: Sequence[str] = ("stoc_pol_mean",),
    resume: bool = True,
    print_table: bool = True,
    profile_dir: Optional[str] = None,
    profile_iters: int = 3,
    max_retries: int = 3,
    retry_backoff_s: float = 5.0,
    init_state=None,
) -> None:
    os.makedirs(job_name, exist_ok=True)
    logdir = os.path.join(job_name, "logs")
    logger = DataLog(logdir)
    ckpt = CheckpointManager(job_name)

    # init_state lets a warm start (e.g. BC on demos, DAPG stage 1) seed the
    # run; a checkpoint restore still wins so resume keeps RL progress.
    state = init_state if init_state is not None else agent.init(
        jax.random.PRNGKey(seed)
    )
    start_iter = 0
    if resume:
        restored = ckpt.restore_latest(jax.device_get(state))
        if restored is not None:
            state = restored
            start_iter = int(state.iteration)
            print(f"Resuming {job_name} from iteration {start_iter}")
            # Reload prior metrics so save_log doesn't overwrite log.csv
            # with only post-resume rows (reference:
            # _load_latest_policy_and_logs reload + shrink semantics).
            prev_csv = os.path.join(logdir, "log.csv")
            if os.path.exists(prev_csv):
                logger.read_log(prev_csv)
                logger.shrink_to(start_iter)

    if agent.mesh is not None:
        # the step returns the state replicated over the mesh; placing it
        # so from the start keeps the second iteration from recompiling
        from mjrl_tpu.parallel.mesh import replicated

        state = jax.device_put(state, replicated(agent.mesh))
    train_step = agent.jitted_train_step
    eval_fn = None
    if evaluation_rollouts > 0:
        from mjrl_tpu.samplers.rollout import sample_episodes

        def _eval(state, key):
            # Always FULL deterministic episodes, `evaluation_rollouts` of
            # them (reference: eval_mode=True sample_paths) — the training
            # sampler's windows would mis-measure in samples mode.
            batch = sample_episodes(
                agent.env,
                agent.policy,
                state.params,
                state.transforms,
                key,
                evaluation_rollouts,
                agent.horizon,
                eval_mode=True,
            )
            return rollout_statistics(batch)

        eval_fn = jax.jit(_eval)

    best_perf = -np.inf
    best_state = None
    base_key = jax.random.PRNGKey(seed)

    # Cumulative VALID env-step accounting — the metric-of-record axis.
    # `num_samples` is the per-iteration count of valid (non-padded)
    # transitions, which is what the reference counts when it reports
    # "return @ N env steps" (variable-length paths); padded batch slots
    # are excluded. On resume, recover the running total from the reloaded
    # log history so the column stays monotone across restarts.
    total_env_steps = 0.0
    if start_iter > 0 and "total_env_steps" in logger.log and logger.log["total_env_steps"]:
        total_env_steps = float(logger.log["total_env_steps"][-1])
    elif start_iter > 0 and "num_samples" in logger.log:
        total_env_steps = float(sum(logger.log["num_samples"]))

    for i in range(start_iter, niter):
        if profile_dir is not None and i == start_iter + 1:
            jax.profiler.start_trace(profile_dir)
        t0 = time.time()
        key = jax.random.fold_in(base_key, i)
        # Failure recovery (SURVEY.md §5.3): device errors retry with
        # backoff from the in-memory state; a hard crash restarts from the
        # latest checkpoint via `resume` on relaunch. The device_get waits
        # for the step, so errors surface inside the try.
        for attempt in range(max_retries + 1):
            try:
                new_state, metrics = train_step(state, key)
                # one device->host transfer for all metrics
                metrics = jax.device_get(metrics)
                state = new_state
                break
            except jax.errors.JaxRuntimeError:
                if attempt == max_retries:
                    raise
                # The error surfaced at the device_get — by then the
                # agent may already hold a poisoned sampler carry from the
                # failed step's async outputs; drop it so the retry
                # re-initializes instead of reusing poisoned arrays.
                agent.reset_sampler_carry()
                print(
                    f"device error at iter {i}; retry "
                    f"{attempt + 1}/{max_retries}"
                )
                time.sleep(retry_backoff_s * (attempt + 1))
        t_step = time.time() - t0
        if profile_dir is not None and i == start_iter + 1 + profile_iters:
            jax.profiler.stop_trace()

        row = {k: float(v) for k, v in metrics.items()}
        row["iteration"] = i
        row["time_step"] = t_step
        row["steps_per_sec"] = row.get("num_samples", 0.0) / max(t_step, 1e-9)
        total_env_steps += row.get("num_samples", 0.0)
        row["total_env_steps"] = total_env_steps

        if eval_fn is not None:
            stats = jax.block_until_ready(
                eval_fn(state, jax.random.fold_in(base_key, 10_000_000 + i))
            )
            row["eval_score"] = float(stats.mean)

        logger.log_dict(row)

        perf = row.get("eval_score", row["running_score"])
        if perf > best_perf:
            best_perf = perf
            # Snapshot on device: an async copy, where a device_get here
            # would be a synchronous full-pytree readback every time the
            # score improves.
            best_state = jax.tree.map(jnp.copy, state)

        if i % save_freq == 0 or i == niter - 1:
            ckpt.save(i + 1, state)
            if best_state is not None:
                # one readback at save points only
                ckpt.save_best(jax.device_get(best_state))
                best_state = None
            logger.save_log(logdir)
            make_train_plots(log=logger, keys=plot_keys, save_loc=logdir)

        if print_table:
            items = sorted(row.items())
            if tabulate is not None:
                print(tabulate(items, headers=[f"iter {i}", "value"],
                               tablefmt="simple", floatfmt=".4f"))
            else:
                print(f"iter {i}: " + " ".join(f"{k}={v:.4f}" for k, v in items))

    ckpt.wait()
    logger.save_log(logdir)
    make_train_plots(log=logger, keys=plot_keys, save_loc=logdir)
    logger.close()
    ckpt.close()
    return state

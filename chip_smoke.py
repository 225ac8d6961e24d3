"""Smoke run of the training path on the GPU: ``python chip_smoke.py``.

Drives ant NPG (``GaussianMLP`` (64, 64), ``MLPBaseline``) through
``mjrl_tpu.train.run_job``, the route of ``python -m mjrl_tpu.train``, in
one process:

- (a) penalty contacts, episode mode, 1024 envs x 100 steps, 3 iterations;
- (b) Newton contacts, samples mode, ``n_substeps=1``, 256 envs x 512-step
  windows, 2 iterations;
- physics parity: the batched SoA control step on the GPU against the
  per-env reference engine on the CPU, at 1024 envs, for the penalty and
  the Newton model (compiled in the background while (a) and (b) train).

For (a) and (b) it prints compile seconds, per-iteration seconds, valid and
computed env-steps/s and peak device memory; before the last line, the
card's name and power limit from ``nvidia-smi``. The last line is one JSON
object, ``{"ok": true, "device": {...}}``. Any failure exits non-zero.

``--devices 4`` runs only the sharded path: (a) at 4 x 1024 envs over a
4-device mesh, then the same program on a 1-device mesh, and compares the
first iteration's statistics (both sample from the same per-env keys).
"""

from __future__ import annotations

import argparse
import csv
import json
import os
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import jax
import numpy as np


def check_device() -> None:
    """Refuse to run without a GPU, and check the package's precision."""
    backend = jax.default_backend()
    if backend != "gpu":
        raise SystemExit(f"chip_smoke needs a GPU; JAX's backend is {backend!r}")
    import mjrl_tpu  # noqa: F401  (sets the matmul precision)

    prec = jax.config.jax_default_matmul_precision
    if prec != "float32":
        raise SystemExit(f"matmul precision is {prec!r}, expected 'float32'")


class CompileClock:
    """Sums JAX's trace, lowering and backend-compile durations in the
    thread that created it (background compiles are not counted)."""

    _EVENTS = (
        "/jax/core/compile/jaxpr_trace_duration",
        "/jax/core/compile/jaxpr_to_mlir_module_duration",
        "/jax/core/compile/backend_compile_duration",
    )

    def __init__(self) -> None:
        self.seconds = 0.0
        self._thread = threading.get_ident()
        jax.monitoring.register_event_duration_secs_listener(self._on_event)

    def _on_event(self, event: str, duration: float, **_) -> None:
        if event in self._EVENTS and threading.get_ident() == self._thread:
            self.seconds += duration


def ant_config(newton: bool, num_envs: int, steps: int, niter: int,
               mesh_devices: int = 0):
    """Configuration (a) (penalty, episodes) or (b) (Newton, samples)."""
    from mjrl_tpu.utils.configs import RunConfig

    env_kwargs = {"horizon": steps}
    if newton:
        env_kwargs.update(constraint_solver="newton", n_substeps=1)
    return RunConfig(
        env_name="ant",
        env_kwargs=env_kwargs,
        algorithm="npg",
        hidden_sizes=(64, 64),
        baseline="mlp",
        baseline_kwargs={"epochs": 2, "batch_size": 1024},
        num_traj=num_envs,
        num_samples=num_envs * steps if newton else None,
        sample_mode="samples" if newton else "trajectories",
        horizon=steps,
        agent_kwargs={"normalized_step_size": 0.05},
        niter=niter,
        mesh_devices=mesh_devices,
    )


def _read_log(job_dir: str):
    with open(os.path.join(job_dir, "logs", "log.csv")) as f:
        rows = list(csv.DictReader(f))
    return [{k: float(v) for k, v in r.items() if v != ""} for r in rows]


def train_phase(name: str, cfg, clock: CompileClock) -> dict:
    """Train ``cfg`` through ``run_job``; check and report what came out."""
    from mjrl_tpu.train import run_job

    c0 = clock.seconds
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as job_dir:
        state = run_job(cfg, job_dir, max_retries=0)
        state = jax.block_until_ready(state)
        wall = time.perf_counter() - t0
        rows = _read_log(job_dir)
    if len(rows) != cfg.niter:
        raise SystemExit(f"{name}: {len(rows)} log rows, expected {cfg.niter}")
    for r in rows:
        bad = [k for k, v in r.items() if not np.isfinite(v)]
        if bad:
            raise SystemExit(f"{name}: non-finite metrics {bad} at iter {r['iteration']}")
    for leaf in jax.tree_util.tree_leaves(state):
        if not np.all(np.isfinite(np.asarray(leaf))):
            raise SystemExit(f"{name}: non-finite value in the final train state")
    computed = cfg.num_traj * cfg.horizon
    if any(r["num_samples"] <= 0 or r["num_samples"] > computed for r in rows):
        raise SystemExit(f"{name}: num_samples outside (0, {computed}]")
    steady = rows[1:]
    iter_s = float(np.mean([r["time_step"] for r in steady]))
    valid = float(np.mean([r["num_samples"] for r in steady]))
    stats = jax.devices()[0].memory_stats() or {}
    out = {
        "phase": name,
        "compile_s": clock.seconds - c0,
        "first_iter_s": rows[0]["time_step"],
        "iter_s": [r["time_step"] for r in rows],
        "steady_iter_s": iter_s,
        "valid_env_steps_per_s": valid / iter_s,
        "computed_env_steps_per_s": computed / iter_s,
        "peak_bytes_in_use_process": stats.get("peak_bytes_in_use"),
        "phase_wall_s": wall,
        "stoc_pol_mean": [r["stoc_pol_mean"] for r in rows],
        "num_samples": [r["num_samples"] for r in rows],
    }
    print(json.dumps(out))
    return out


# One control step of SoA (GPU) vs the per-env engine (CPU), from the same
# states. The reference engine is pinned to MuJoCo by
# tests/test_physics_mujoco.py. The two routes sum in different orders and
# the GPU's transcendental functions differ from the CPU's in the last bits;
# contacts amplify that over the 20 (penalty) or 5 (Newton) substeps of a
# control step, and Newton's fixed 10 iterations amplify it where a contact
# sits at the edge of its margin. Each array must satisfy
# ``max|gpu - cpu| <= atol + rtol * max|cpu|`` (tools/device_parity_check.py's
# form). The bounds sit about 3x above the worst deviation measured on an
# H100 over 1024 envs x 5 steps in two runs (PERF.md): penalty q 1.3e-6,
# qd 2.5e-4 at |qd| ~14; Newton q 2.2e-5, qd 1.7e-3 at |qd| ~13.
PARITY_TOL = {
    "penalty": {"q": (1e-5, 1e-5), "qd": (1e-4, 5e-5)},
    "newton": {"q": (1e-4, 1e-4), "qd": (1e-4, 4e-4)},
}


class PhysicsParity:
    """SoA step on the GPU vs the engine on the CPU for one ant model.

    Built (traced) in the calling thread; ``start`` hands the two XLA
    compiles to ``pool`` so they overlap the training phases.
    """

    def __init__(self, newton: bool, num_envs: int = 1024, steps: int = 5):
        from mjrl_tpu import envs
        from mjrl_tpu.physics.dispatch import make_frame_stepper, soa_eligible

        self.solver = "newton" if newton else "penalty"
        kw = {"constraint_solver": "newton", "n_substeps": 1} if newton else {}
        env = envs.make("ant", horizon=steps + 1, **kw)
        if not soa_eligible(env.model):
            raise SystemExit("ant must take the SoA route")
        self.cpu, self.gpu = jax.devices("cpu")[0], jax.devices()[0]
        keys = jax.device_put(
            jax.random.split(jax.random.PRNGKey(0), num_envs), self.cpu
        )
        with jax.default_device(self.cpu):
            ps, _ = jax.jit(jax.vmap(env.reset))(keys)
            self.actions = [
                jax.random.uniform(
                    jax.random.PRNGKey(100 + i),
                    (num_envs, env.spec.action_dim), minval=-1.0, maxval=1.0,
                )
                for i in range(steps)
            ]
        self.q, self.qd = ps.q, ps.qd
        args = (self.q, self.qd, self.actions[0])
        ref = make_frame_stepper(
            env.model, env.frame_skip, subspaces=env.subspaces, use_soa=False
        )
        self._ref = jax.jit(jax.vmap(ref)).lower(*args)
        self._fast = jax.jit(jax.vmap(env._frame_step)).lower(
            *jax.device_put(args, self.gpu)
        )
        self.num_envs = num_envs

    def start(self, pool) -> None:
        self._ref = pool.submit(self._ref.compile)
        self._fast = pool.submit(self._fast.compile)

    def check(self) -> dict:
        ref, fast = self._ref.result(), self._fast.result()
        q, qd = self.q, self.qd
        worst = {"q": 0.0, "qd": 0.0}
        report = []
        for i, a in enumerate(self.actions):
            rq, rqd = jax.device_get(ref(q, qd, a))
            fq, fqd = jax.device_get(fast(*jax.device_put((q, qd, a), self.gpu)))
            row = {"step": i}
            for k, r, f in (("q", rq, fq), ("qd", rqd, fqd)):
                atol, rtol = PARITY_TOL[self.solver][k]
                if not np.all(np.isfinite(f)):
                    raise SystemExit(f"parity: non-finite {k} from the GPU route")
                d = float(np.abs(f - r).max())
                bound = atol + rtol * float(np.abs(r).max())
                row[k] = {"max_abs_diff": d, "bound": bound}
                worst[k] = max(worst[k], d / bound)
            report.append(row)
            q, qd = jax.device_put((rq, rqd), self.cpu)
        out = {"phase": f"parity_{self.solver}", "num_envs": self.num_envs,
               "steps": report, "worst_diff_over_bound": worst}
        print(json.dumps(out))
        if max(worst.values()) > 1.0:
            raise SystemExit(
                f"parity: GPU SoA step differs from the engine: {worst}"
            )
        return out


def sharded_phase(clock: CompileClock, n: int, envs_per_device: int = 1024,
                  steps: int = 100) -> None:
    if len(jax.devices()) < n:
        raise SystemExit(f"--devices {n}: JAX sees {len(jax.devices())} devices")
    rows = {}
    for mesh_devices in (n, 1):
        cfg = ant_config(False, n * envs_per_device, steps, 3,
                         mesh_devices=mesh_devices)
        rows[mesh_devices] = train_phase(f"sharded_{mesh_devices}dev", cfg, clock)
    # Both programs sample the first iteration from the same per-env keys
    # and params, but the GPU rounds a 1024-row and a 4096-row matmul
    # differently and contacts amplify that over 100 steps, so some
    # episodes end at other steps (on H100s: 277,941 vs 277,451 valid
    # samples, PERF.md). The statistics must still agree; later iterations
    # follow different CG solves and are checked for finiteness only.
    a, b = rows[n], rows[1]
    for key, rtol in (("num_samples", 1e-2), ("stoc_pol_mean", 2e-2)):
        x, y = a[key][0], b[key][0]
        if abs(x - y) > rtol * abs(y):
            raise SystemExit(f"sharded: first-iteration {key} {x} vs {y}")


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--devices", type=int, default=1, choices=[1, 4],
                   help="4: run only the env axis sharded over four GPUs")
    args = p.parse_args()

    check_device()
    from mjrl_tpu.utils.runtime import enable_compile_cache, gpu_card

    print(f"compile cache: {enable_compile_cache()}")
    clock = CompileClock()
    if args.devices > 1:
        sharded_phase(clock, args.devices)
    else:
        parity = [PhysicsParity(newton=False), PhysicsParity(newton=True)]
        # the parity programs compile while (a) and (b) train; the Newton
        # one alone takes minutes
        with ThreadPoolExecutor(max_workers=2) as pool:
            for case in parity:
                case.start(pool)
            train_phase("a_penalty_episodes", ant_config(False, 1024, 100, 3), clock)
            train_phase("b_newton_samples", ant_config(True, 256, 512, 2), clock)
            for case in parity:
                case.check()
    print(f"card: {gpu_card()}")
    dev = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices()),
    }}))


if __name__ == "__main__":
    main()

"""Checkpoint/resume: the full train state as one ``.npz`` per step, atomically.

The reference checkpoints by pickling whole Python objects
(``best_policy.pickle``, ``policy_{i}.pickle``/``baseline_{i}.pickle`` every
``save_freq`` iterations; resume scans ``iterations/`` for the newest pair —
reference: mjrl/utils/train_agent.py) and silently loses optimizer state on
resume. Here the ENTIRE ``AgentState`` pytree (policy params + old params +
transforms + baseline + optimizer state + iteration + running_score) is
saved: resume-exact (SURVEY.md §5.4). A ``best`` checkpoint mirrors the
reference's ``best_policy.pickle``.

Layout under the job directory: ``iterations/<step>/state.npz`` and
``best/state.npz``. The leaves are stored in ``jax.tree_util`` flatten order;
restoring needs a template pytree of the same structure (a fresh
``agent.init`` state), so no Python object is ever unpickled. Each write goes
to a temporary directory first and is moved into place with ``os.replace``,
so a crash mid-save never leaves a partial checkpoint under its final name.
"""

from __future__ import annotations

import os
import shutil
import tempfile
from typing import Any, List, Optional

import jax
import numpy as np

_FILE = "state.npz"


def _write(path: str, state: Any) -> None:
    leaves = jax.tree_util.tree_leaves(jax.device_get(state))
    parent = os.path.dirname(path)
    tmp = tempfile.mkdtemp(prefix=".tmp-", dir=parent)
    try:
        np.savez(
            os.path.join(tmp, _FILE),
            **{f"leaf_{i}": np.asarray(x) for i, x in enumerate(leaves)},
        )
        if os.path.isdir(path):
            shutil.rmtree(path)
        os.replace(tmp, path)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise


def _read(path: str, template: Any) -> Any:
    leaves, treedef = jax.tree_util.tree_flatten(template)
    with np.load(os.path.join(path, _FILE)) as data:
        if len(data.files) != len(leaves):
            raise ValueError(
                f"checkpoint {path} holds {len(data.files)} leaves, "
                f"template has {len(leaves)}"
            )
        out = []
        for i, ref in enumerate(leaves):
            x = data[f"leaf_{i}"]
            if np.shape(ref) != x.shape:
                raise ValueError(
                    f"checkpoint {path} leaf {i}: shape {x.shape}, "
                    f"template {np.shape(ref)}"
                )
            out.append(x.astype(np.asarray(ref).dtype, copy=False))
    return jax.tree_util.tree_unflatten(treedef, out)


class CheckpointManager:
    def __init__(self, directory: str, max_to_keep: int = 5):
        self._dir = os.path.abspath(directory)
        self._iters = os.path.join(self._dir, "iterations")
        os.makedirs(self._iters, exist_ok=True)
        self._max_to_keep = max_to_keep

    def _steps(self) -> List[int]:
        return sorted(
            int(d)
            for d in os.listdir(self._iters)
            if d.isdigit() and os.path.isfile(os.path.join(self._iters, d, _FILE))
        )

    def save(self, step: int, state: Any) -> None:
        _write(os.path.join(self._iters, str(step)), state)
        for old in self._steps()[: -self._max_to_keep]:
            shutil.rmtree(os.path.join(self._iters, str(old)))

    def save_best(self, state: Any) -> None:
        """The reference's ``best_policy.pickle`` equivalent."""
        _write(os.path.join(self._dir, "best"), state)

    def latest_step(self) -> Optional[int]:
        steps = self._steps()
        return steps[-1] if steps else None

    def restore(self, step: int, template: Any) -> Any:
        return _read(os.path.join(self._iters, str(step)), template)

    def restore_latest(self, template: Any) -> Optional[Any]:
        step = self.latest_step()
        if step is None:
            return None
        return self.restore(step, template)

    def restore_best(self, template: Any) -> Any:
        return _read(os.path.join(self._dir, "best"), template)

    def wait(self) -> None:
        """Saves are synchronous; kept so callers need not know that."""

    def close(self) -> None:
        """Nothing is held open between saves."""

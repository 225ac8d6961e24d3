"""Training-curve plots (reference: mjrl/utils/make_train_plots.py).

Renders ``train_curves.png`` from logged keys with matplotlib's Agg backend.
matplotlib is optional: without it the plot is skipped with one printed line.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

from mjrl_tpu.utils.logger import DataLog


def make_train_plots(
    log: Optional[DataLog] = None,
    log_path: Optional[str] = None,
    keys: Sequence[str] = ("stoc_pol_mean",),
    save_loc: str = ".",
    sample_key: str = "num_samples",
    x_scale: float = 1.0,
    y_scale: float = 1.0,
) -> None:
    if log is None:
        assert log_path is not None
        log = DataLog()
        log.read_log(log_path)
    data = log.log
    keys = [k for k in keys if k in data and data[k]]
    if not keys:
        return
    try:
        import matplotlib
    except ImportError:
        print("matplotlib not installed; skipping train_curves.png")
        return
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    ncols = min(2, len(keys))
    nrows = -(-len(keys) // ncols)
    fig, axes = plt.subplots(
        nrows, ncols, figsize=(6 * ncols, 3.5 * nrows), squeeze=False
    )
    for i, k in enumerate(keys):
        ax = axes[i // ncols][i % ncols]
        ys = [y * y_scale for y in data[k]]
        ax.plot([x * x_scale for x in range(len(ys))], ys)
        ax.set_xlabel("iteration")
        ax.set_title(k)
        ax.grid(True, alpha=0.3)
    for j in range(len(keys), nrows * ncols):
        axes[j // ncols][j % ncols].axis("off")
    fig.tight_layout()
    os.makedirs(save_loc, exist_ok=True)
    fig.savefig(os.path.join(save_loc, "train_curves.png"), dpi=100)
    plt.close(fig)

"""Before/after registration plots (the matplotlib analogue of demo/demo.m
+ readpoints.m: model in red, data in blue, pre vs post alignment).

Port of goicp_tpu/pipeline/visualize.py (numpy and matplotlib)."""

from __future__ import annotations

import numpy as np


def plot_registration(model: np.ndarray, data: np.ndarray, R: np.ndarray,
                      t: np.ndarray, out_path: str) -> bool:
    """Write a two-panel 3D scatter PNG. Returns False when matplotlib is
    unavailable (headless-safe)."""
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except Exception:
        return False

    moved = data @ np.asarray(R).T + np.asarray(t).reshape(1, 3)
    fig = plt.figure(figsize=(10, 5))
    for i, (d, title) in enumerate(((data, "Initial Pose"),
                                    (moved, "Result"))):
        ax = fig.add_subplot(1, 2, i + 1, projection="3d")
        ax.scatter(model[:, 0], model[:, 1], model[:, 2], s=2, c="r",
                   label="model")
        ax.scatter(d[:, 0], d[:, 1], d[:, 2], s=2, c="b", label="data")
        ax.set_title(title)
        ax.set_box_aspect((1, 1, 1))
    fig.tight_layout()
    fig.savefig(out_path, dpi=120)
    plt.close(fig)
    return True

"""Training and validation curves of an `engine.ARTrainingInfo`
(reference: ar_training_info.plots, train_predict_state.py:449); the body
of the JAX package's `ARTrainingInfo.plots`
(`deepsphere_weather_tpu/engine/training.py:88-130`)."""

from __future__ import annotations

from pathlib import Path

import matplotlib
matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402
import numpy as np  # noqa: E402

__all__ = ["plot_training_info"]


def plot_training_info(info, exp_dir, ylim=None) -> Path:
    """Write `figs/training_info/loss_curves.png` and, when validation
    recorded per-iteration losses, `per_leadtime_loss.png` under
    `exp_dir`; returns that directory."""
    fig_dir = Path(exp_dir) / "figs" / "training_info"
    fig_dir.mkdir(parents=True, exist_ok=True)

    fig, ax = plt.subplots(figsize=(8, 5))
    ax.plot(info.iterations, info.training_total_loss, label="training",
            lw=0.8)
    if info.validation_total_loss:
        ax.plot(info.validation_iterations, info.validation_total_loss,
                label="validation", lw=1.2)
    for ev in info.ar_growth_events:
        ax.axvline(ev, color="gray", ls="--", lw=0.6)
    ax.set_xlabel("weight update")
    ax.set_ylabel("total loss")
    if ylim:
        ax.set_ylim(ylim)
    ax.legend()
    ax.set_title("AR training")
    fig.tight_layout()
    fig.savefig(fig_dir / "loss_curves.png", dpi=120)
    plt.close(fig)

    if info.per_iteration_loss:
        fig, ax = plt.subplots(figsize=(8, 5))
        arr = np.full((len(info.per_iteration_loss),
                       max(len(x) for x in info.per_iteration_loss)), np.nan)
        for i, row in enumerate(info.per_iteration_loss):
            arr[i, : len(row)] = row
        for j in range(arr.shape[1]):
            ax.plot(info.validation_iterations, arr[:, j],
                    label=f"AR iter {j}", lw=0.9)
        ax.set_xlabel("weight update")
        ax.set_ylabel("per-leadtime validation loss")
        ax.legend(fontsize=7)
        fig.tight_layout()
        fig.savefig(fig_dir / "per_leadtime_loss.png", dpi=120)
        plt.close(fig)
    return fig_dir

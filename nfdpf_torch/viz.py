"""Visualization: tracking overlays, ESS curves, reconstruction grids.

Counterpart of ``nfdpf_tpu/viz.py``: the same five diagnostic views, on the
filter's stacked histories (numpy arrays or CPU tensors, images HWC in
[0, 1]).  Every function saves to files (headless, the Agg backend) and
returns the figure.  matplotlib is imported when a function draws, not when
the module is imported: the port runs where matplotlib is absent, with its
plots off (``available``).
"""

from __future__ import annotations

import importlib.util
import os
from typing import Optional, Sequence

import numpy as np


def available() -> bool:
    """True when matplotlib can be imported, so the plots can be drawn."""
    return importlib.util.find_spec("matplotlib") is not None


def _pyplot():
    """matplotlib's pyplot on the Agg backend; ImportError without matplotlib."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _np(x) -> np.ndarray:
    return np.asarray(x)


def _quiver(ax, pos_x, pos_y, vel_x, vel_y, color):
    """Velocity arrows with the reference's arrow geometry
    (`plot.py:25-26`: xy scale-units, scale 1/20, scaled heads)."""
    hs = 1.5
    ax.quiver(pos_x, pos_y, vel_x, vel_y, color=color,
              scale_units="xy", scale=1.0 / 20.0, width=0.003,
              headlength=5 * hs, headwidth=1 * hs, headaxislength=4.5 * hs)


def plot_obs_tracking(
    images,          # (T, H, W, 3)
    particles,       # (T, N, >=2) — velocity quivers drawn when dim >= 4
    weights,         # (T, N)
    true_state,      # (T, >=2) — velocity quiver drawn when dim >= 4
    predictions,     # (T, >=2)
    out_dir: str,
    steps: Optional[Sequence[int]] = None,
    width: int = 128,
):
    """Per-step overlay: observation + weight-scaled/weight-alpha particle
    scatter, truth (red) and prediction (blue), with velocity quiver arrows
    for any input that carries velocities (`plot.py:6-74`).  Every timestep
    is rendered by default, as in the reference's `for t in range(seq_len)`
    (`plot.py:35`)."""
    plt = _pyplot()
    images, particles = _np(images), _np(particles)
    weights, true_state, predictions = _np(weights), _np(true_state), _np(predictions)
    os.makedirs(out_dir, exist_ok=True)
    half = width / 2.0
    if steps is None:
        steps = range(images.shape[0])
    figs = []
    for t in steps:
        fig, ax = plt.subplots(figsize=(4, 4))
        ax.imshow(images[t], extent=[-half, half, half, -half])
        w = weights[t]
        # weight-scaled size + min-max-normalized alpha (`plot.py:55-56`)
        wspan = w.max() - w.min()
        alpha = (w - w.min()) / wspan if wspan > 0 else np.full_like(w, 0.5)
        ax.scatter(particles[t, :, 0], particles[t, :, 1],
                   s=200 * w / w.max(), c="yellow", alpha=alpha,
                   label="particles")
        if particles.shape[-1] >= 4:
            _quiver(ax, particles[t, :, 0], particles[t, :, 1],
                    particles[t, :, 2], particles[t, :, 3], "black")
        ax.scatter([true_state[t, 0]], [true_state[t, 1]], c="red", marker="x",
                   s=80, label="truth")
        if true_state.shape[-1] >= 4:
            _quiver(ax, true_state[t, 0], true_state[t, 1],
                    true_state[t, 2], true_state[t, 3], "red")
        ax.scatter([predictions[t, 0]], [predictions[t, 1]], c="blue",
                   marker="+", s=80, label="prediction")
        if predictions.shape[-1] >= 4:
            _quiver(ax, predictions[t, 0], predictions[t, 1],
                    predictions[t, 2], predictions[t, 3], "blue")
        ax.set_xlim(-half, half)
        ax.set_ylim(half, -half)
        ax.set_title(f"t={t}", fontsize=9)
        ax.legend(loc="upper right", fontsize=6)
        fig.savefig(os.path.join(out_dir, f"tracking_step_{t:03d}.png"),
                    dpi=100, bbox_inches="tight")
        figs.append(fig)
        plt.close(fig)
    return figs


def plot_state_tracking(true_state, predictions, out_path: str, width: int = 128):
    """Whole-trajectory overlay (`plot.py:76-134`)."""
    plt = _pyplot()
    true_state, predictions = _np(true_state), _np(predictions)
    half = width / 2.0
    fig, ax = plt.subplots(figsize=(5, 5))
    ax.plot(true_state[:, 0], true_state[:, 1], "r-x", label="truth",
            markersize=4)
    ax.plot(predictions[:, 0], predictions[:, 1], "b-+", label="prediction",
            markersize=4)
    ax.set_xlim(-half, half)
    ax.set_ylim(half, -half)
    ax.set_title("trajectory")
    ax.legend()
    fig.savefig(out_path, dpi=100, bbox_inches="tight")
    plt.close(fig)
    return fig


def plot_ess_tracking(weights, out_path: str):
    """ESS over time, per batch element + mean (`plot.py:137-158`).

    weights: (B, T, N) or (T, N).
    """
    plt = _pyplot()
    weights = _np(weights)
    if weights.ndim == 2:
        weights = weights[None]
    ess = 1.0 / np.sum(weights**2, axis=-1)             # (B, T)
    fig, ax = plt.subplots(figsize=(6, 3))
    for b in range(min(ess.shape[0], 8)):
        ax.plot(ess[b], alpha=0.3, color="gray")
    ax.plot(ess.mean(axis=0), color="C0", label="mean ESS")
    ax.axhline(0.5 * weights.shape[-1], color="red", linestyle="--",
               label="resampling threshold")
    ax.set_xlabel("step")
    ax.set_ylabel("ESS")
    ax.legend()
    fig.savefig(out_path, dpi=100, bbox_inches="tight")
    plt.close(fig)
    return fig


def plot_motion_model(particles_before, particles_after, true_state,
                      out_path: str, width: int = 128):
    """Before/after motion-update scatter (`plot.py:161-224`)."""
    plt = _pyplot()
    pb, pa = _np(particles_before), _np(particles_after)
    true_state = _np(true_state)
    half = width / 2.0
    fig, ax = plt.subplots(figsize=(5, 5))
    ax.scatter(pb[:, 0], pb[:, 1], s=4, c="gray", alpha=0.4, label="before")
    ax.scatter(pa[:, 0], pa[:, 1], s=4, c="C0", alpha=0.4, label="after")
    ax.scatter([true_state[0]], [true_state[1]], c="red", marker="x", s=80,
               label="truth")
    ax.set_xlim(-half, half)
    ax.set_ylim(half, -half)
    ax.legend()
    fig.savefig(out_path, dpi=100, bbox_inches="tight")
    plt.close(fig)
    return fig


def plot_obs(images, reconstructions, out_path: str,
             steps: Sequence[int] = (0, 19, 29, 39)):
    """AE reconstruction grid at selected steps (`plot.py:226-243`).

    images/reconstructions: (B, T, H, W, 3).
    """
    plt = _pyplot()
    images, reconstructions = _np(images), _np(reconstructions)
    steps = [s for s in steps if s < images.shape[1]]
    fig, axes = plt.subplots(2, len(steps), figsize=(2 * len(steps), 4))
    if len(steps) == 1:
        axes = axes.reshape(2, 1)
    for col, t in enumerate(steps):
        axes[0, col].imshow(np.clip(images[0, t], 0, 1))
        axes[0, col].set_title(f"obs t={t}", fontsize=8)
        axes[1, col].imshow(np.clip(reconstructions[0, t], 0, 1))
        axes[1, col].set_title(f"recon t={t}", fontsize=8)
        for r in (0, 1):
            axes[r, col].axis("off")
    fig.savefig(out_path, dpi=100, bbox_inches="tight")
    plt.close(fig)
    return fig

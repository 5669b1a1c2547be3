"""Plotting: loss curves, per-frame error curves, trajectory snapshots.

Port of ``dynamicpdb_tpu/analysis/plotting.py``: headless matplotlib
(imported only when a function runs, so the package imports without it),
every function saves to a file and returns its path.
"""
from __future__ import annotations

import os

import numpy as np


def _plt():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def plot_loss_curves(history: list[dict], out_path: str, keys=None):
    """history = Experiment.train() records or utils.logging.read_metrics."""
    plt = _plt()
    keys = keys or [
        k for k in history[0] if k not in ("step", "time", "steps_per_sec")
    ]
    steps = [h["step"] for h in history]
    fig, axes = plt.subplots(1, len(keys), figsize=(4 * len(keys), 3), dpi=120)
    if len(keys) == 1:
        axes = [axes]
    for ax, k in zip(axes, keys):
        ax.plot(steps, [h.get(k, np.nan) for h in history])
        ax.set_title(k)
        ax.set_xlabel("step")
    fig.tight_layout()
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    fig.savefig(out_path)
    plt.close(fig)
    return out_path


def plot_rot_trans_curves(per_frame_metrics: dict, out_path: str):
    """Per-frame rotation/translation error curves with RefAsPred baselines
    (plot_curve_merged equivalent, train:157-195)."""
    plt = _plt()
    fig, (ax1, ax2) = plt.subplots(1, 2, figsize=(8, 3), dpi=120)
    for key, ax, title in (
        ("rot", ax1, "rotation error (deg)"),
        ("trans", ax2, "translation MAE (A)"),
    ):
        if key in per_frame_metrics:
            ax.plot(per_frame_metrics[key], label="pred")
        if f"ref_{key}" in per_frame_metrics:
            ax.plot(per_frame_metrics[f"ref_{key}"], "--", label="RefAsPred")
        ax.set_title(title)
        ax.set_xlabel("frame")
        ax.legend()
    fig.tight_layout()
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    fig.savefig(out_path)
    plt.close(fig)
    return out_path


def plot_ca_trace(atom37: np.ndarray, out_path: str, stride: int = 1):
    """3D C-alpha traces for a [F, N, 37, 3] trajectory."""
    plt = _plt()
    fig = plt.figure(figsize=(5, 5), dpi=120)
    ax = fig.add_subplot(projection="3d")
    frames = np.asarray(atom37)[::stride]
    for i, frame in enumerate(frames):
        ca = frame[:, 1]
        ax.plot(ca[:, 0], ca[:, 1], ca[:, 2], alpha=0.3 + 0.7 * i / max(len(frames) - 1, 1))
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    fig.savefig(out_path)
    plt.close(fig)
    return out_path


def plot_sample_grid(samples, out_path: str, true_bb: np.ndarray | None = None,
                     cols: int = 4):
    """Comparison grid of sampled backbones (plot_sample_grid equivalent,
    reference plotting.py:199-222): one 3D CA trace per panel, optional
    ground truth overlaid in grey on every panel.

    samples: [S, N, 3] CA coords (or [S, N, 37, 3] atom37)."""
    plt = _plt()
    samples = np.asarray(samples)
    if samples.ndim == 4:
        samples = samples[:, :, 1]
    S = len(samples)
    rows = (S + cols - 1) // cols
    fig = plt.figure(figsize=(3 * cols, 3 * rows), dpi=110)
    for i, ca in enumerate(samples):
        ax = fig.add_subplot(rows, cols, i + 1, projection="3d")
        if true_bb is not None:
            gt = np.asarray(true_bb)
            gt = gt[:, 1] if gt.ndim == 3 else gt
            ax.plot(gt[:, 0], gt[:, 1], gt[:, 2], color="grey", alpha=0.5,
                    lw=1)
        ax.plot(ca[:, 0], ca[:, 1], ca[:, 2], lw=1.5)
        ax.set_title(f"sample {i}", fontsize=8)
        ax.set_axis_off()
    fig.tight_layout()
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    fig.savefig(out_path)
    plt.close(fig)
    return out_path


def viz_frames(rigids, out_path: str, scale: float = 2.0, stride: int = 1,
               title: str = ""):
    """Rigid-frame glyphs: translation scatter + rotation axes as 3D quivers
    (viz_frames/create_cones equivalent, reference plotting.py:62-99,
    241-246). rigids: [N, 7] tensor-7 (quat + trans) or [F, N, 7]."""
    import torch

    from dynamicpdb_tpu_torch.ops.so3 import quat_to_rotmat

    plt = _plt()
    rigids = np.asarray(rigids)
    if rigids.ndim == 3:
        rigids = rigids[-1]
    rigids = rigids[::stride]
    rot = quat_to_rotmat(torch.as_tensor(rigids[:, :4])).numpy()
    trans = rigids[:, 4:]
    fig = plt.figure(figsize=(5, 5), dpi=120)
    ax = fig.add_subplot(projection="3d")
    ax.plot(trans[:, 0], trans[:, 1], trans[:, 2], color="grey", alpha=0.6)
    colors = ("tab:red", "tab:green", "tab:blue")
    for axis in range(3):
        v = rot[:, :, axis] * scale
        ax.quiver(trans[:, 0], trans[:, 1], trans[:, 2],
                  v[:, 0], v[:, 1], v[:, 2], color=colors[axis],
                  arrow_length_ratio=0.25, linewidth=0.8)
    if title:
        ax.set_title(title)
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    fig.savefig(out_path)
    plt.close(fig)
    return out_path


def write_traj_animation(atom37_traj, out_path: str, stride: int = 1,
                         fps: int = 8):
    """Animated CA-trace trajectory (write_traj equivalent, reference
    plotting.py:274-319) saved as GIF via matplotlib.animation."""
    import matplotlib.animation as animation

    plt = _plt()
    frames = np.asarray(atom37_traj)[::stride]
    ca = frames[:, :, 1] if frames.ndim == 4 else frames
    lim_lo = ca.reshape(-1, 3).min(0) - 2
    lim_hi = ca.reshape(-1, 3).max(0) + 2
    fig = plt.figure(figsize=(5, 5), dpi=100)
    ax = fig.add_subplot(projection="3d")

    def draw(i):
        ax.clear()
        ax.plot(ca[i, :, 0], ca[i, :, 1], ca[i, :, 2], lw=1.5)
        ax.set_xlim(lim_lo[0], lim_hi[0])
        ax.set_ylim(lim_lo[1], lim_hi[1])
        ax.set_zlim(lim_lo[2], lim_hi[2])
        ax.set_title(f"frame {i * stride}")
        return []

    anim = animation.FuncAnimation(fig, draw, frames=len(ca))
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    anim.save(out_path, writer=animation.PillowWriter(fps=fps))
    plt.close(fig)
    return out_path

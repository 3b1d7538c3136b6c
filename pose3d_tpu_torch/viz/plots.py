"""Matplotlib plots of 3D poses (counterpart of
``pose3d_tpu/viz/plots.py``).

Plot coordinates are (x, z, −y), a camera-space pose seen with the
vertical axis up, with NaN/Inf guards and an equal-aspect box;
``visualize_comparison`` is the image | predicted | ground-truth triptych
of the training previews. matplotlib (Agg) and PIL are imported inside
the functions, so the module imports without them.
"""

from __future__ import annotations

import io
from typing import Sequence

import numpy as np

from pose3d_tpu_torch.core.config import CONNECTIONS_H36M


def pyplot():
    """matplotlib.pyplot on the Agg backend."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _plot_pose_on_axis(ax, joints_3d, connections, title):
    """Scatter and bones, each bone drawn only when finite."""
    j = np.asarray(joints_3d, dtype=np.float64).copy()
    j = np.stack([j[:, 0], j[:, 2], -j[:, 1]], axis=1)

    finite = np.isfinite(j).all()
    if finite:
        ax.scatter(j[:, 0], j[:, 1], j[:, 2], color="red", s=50)
        for s, e in connections:
            seg = j[[s, e]]
            if np.isfinite(seg).all():
                ax.plot(seg[:, 0], seg[:, 1], seg[:, 2], color="blue",
                        linewidth=2)
    else:
        ax.text(0, 0, 0, "Invalid pose\n(NaN/Inf values)", ha="center",
                va="center", fontsize=12)

    ax.set_xlabel("X")
    ax.set_ylabel("Y")
    ax.set_zlabel("Z")
    ax.set_title(title)

    if finite:
        rng = j.max(axis=0) - j.min(axis=0)
        if np.isfinite(rng).all() and (rng > 0).all():
            half = rng.max() / 2.0
            mid = (j.max(axis=0) + j.min(axis=0)) * 0.5
            ax.set_xlim(mid[0] - half, mid[0] + half)
            ax.set_ylim(mid[1] - half, mid[1] + half)
            ax.set_zlim(mid[2] - half, mid[2] + half)
            return
    ax.set_xlim(-1, 1)
    ax.set_ylim(-1, 1)
    ax.set_zlim(-1, 1)


def visualize_3d_pose(joints_3d, title: str = "3D Pose",
                      connections: Sequence = CONNECTIONS_H36M):
    """One 3D pose figure."""
    fig = pyplot().figure(figsize=(10, 10))
    ax = fig.add_subplot(111, projection="3d")
    _plot_pose_on_axis(ax, joints_3d, connections, title)
    return fig


def visualize_comparison(image, pred_joints, gt_joints,
                         title: str = "Pose Comparison",
                         connections: Sequence = CONNECTIONS_H36M):
    """Triptych: input image | predicted 3D pose | ground-truth 3D pose.
    ``image``: [H, W, 3] float in [0, 1] or uint8 (CHW is accepted)."""
    fig = pyplot().figure(figsize=(18, 6))

    ax0 = fig.add_subplot(1, 3, 1)
    img = np.asarray(image)
    if img.ndim == 3 and img.shape[0] in (1, 3) and img.shape[-1] not in (1, 3):
        img = np.transpose(img, (1, 2, 0))
    if img.dtype != np.uint8:
        img = np.clip(img, 0, 1)
    ax0.imshow(img)
    ax0.set_title("Input Image")
    ax0.axis("off")

    ax1 = fig.add_subplot(1, 3, 2, projection="3d")
    _plot_pose_on_axis(ax1, pred_joints, connections, "Predicted 3D Pose")
    ax2 = fig.add_subplot(1, 3, 3, projection="3d")
    _plot_pose_on_axis(ax2, gt_joints, connections, "Ground Truth 3D Pose")

    fig.suptitle(title)
    return fig


def fig_to_image(fig):
    """Matplotlib figure → RGB PIL image."""
    from PIL import Image

    buf = io.BytesIO()
    fig.savefig(buf, format="png")
    buf.seek(0)
    return Image.open(buf).convert("RGB")

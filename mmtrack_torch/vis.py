"""Tracking visualization and debugging artifacts, a copy of
mmtrack_tpu/vis.py (tests/test_torch_host_tools.py holds its images
bit-equal to the JAX module's).

Rebuild of the reference's debug surface (ViPT/lib/vis/visdom_cus.py
dashboards, plotting.py curves, lib/test/tracker/vis_utils.py CE-token
overlays) for headless runs: annotated frames, score-map heatmaps, CE-pruned
token masks and metric curves are written as PNGs with an HTML index instead
of a visdom server. `plot_curves` imports matplotlib when it is called, so
a machine without it runs the rest.
"""

from __future__ import annotations

import os

import cv2
import numpy as np


def draw_box(frame: np.ndarray, box_xywh, color=(0, 0, 255), label: str | None = None) -> np.ndarray:
    """Annotated copy of an (H, W, 3+) frame (uses the RGB triplet)."""
    im = np.ascontiguousarray(frame[..., :3][..., ::-1].copy())  # to BGR
    x, y, w, h = [int(round(float(v))) for v in box_xywh]
    cv2.rectangle(im, (x, y), (x + w, y + h), color, 2)
    if label:
        cv2.putText(im, label, (max(x, 2), max(y - 4, 12)),
                    cv2.FONT_HERSHEY_SIMPLEX, 0.5, color, 1)
    return im


def overlay_mask(frame: np.ndarray, mask: np.ndarray,
                 color=(0, 0, 255), alpha: float = 0.4) -> np.ndarray:
    """Blend a binary segmentation mask over the frame (the mask-tracker
    analog of draw_box; LWL/STM `segmentation` outputs)."""
    im = np.ascontiguousarray(frame[..., :3][..., ::-1].copy())
    m = np.asarray(mask, bool)
    overlay = im.copy()
    overlay[m] = color
    return (im * (1 - alpha) + overlay * alpha).astype(np.uint8)


def score_map_heatmap(score_map: np.ndarray, size: tuple[int, int] | None = None) -> np.ndarray:
    """(S, S) score map -> JET heatmap image (visdom 'heatmap' pane analog)."""
    s = np.asarray(score_map, np.float32)
    s = (s - s.min()) / max(s.max() - s.min(), 1e-9)
    im = cv2.applyColorMap((s * 255).astype(np.uint8), cv2.COLORMAP_JET)
    if size is not None:
        im = cv2.resize(im, size, interpolation=cv2.INTER_NEAREST)
    return im


def ce_token_mask(removed_indexes: list[np.ndarray], grid: int) -> np.ndarray:
    """Visualize candidate-elimination pruning (gen_visualization analog,
    lib/test/tracker/vis_utils.py): 1 = kept, fading gray = pruned stage."""
    mask = np.ones((grid * grid,), np.float32)
    for stage, removed in enumerate(removed_indexes):
        mask[np.asarray(removed, np.int64).reshape(-1)] = 0.7 - 0.2 * stage
    return mask.reshape(grid, grid)


class TrackingVisualizer:
    """Per-sequence debug dump: frame overlays + score maps + HTML index
    (replaces the interactive visdom loop, basetracker.py:59-83)."""

    def __init__(self, out_dir: str, every: int = 1):
        self.out_dir = out_dir
        self.every = every
        self._entries: list[str] = []
        os.makedirs(out_dir, exist_ok=True)

    def add_frame(self, idx: int, frame: np.ndarray, box_xywh,
                  score_map: np.ndarray | None = None,
                  gt_box=None, score: float | None = None,
                  mask: np.ndarray | None = None) -> None:
        if idx % self.every:
            return
        if mask is not None:
            blended = overlay_mask(frame, mask)
            im = draw_box(blended[..., ::-1], box_xywh,
                          label=None if score is None else f"{score:.3f}")
        else:
            im = draw_box(frame, box_xywh,
                          label=None if score is None else f"{score:.3f}")
        if gt_box is not None:
            im = cv2.rectangle(im, (int(gt_box[0]), int(gt_box[1])),
                               (int(gt_box[0] + gt_box[2]), int(gt_box[1] + gt_box[3])),
                               (0, 255, 0), 1)
        name = f"frame_{idx:05d}.jpg"
        cv2.imwrite(os.path.join(self.out_dir, name), im)
        row = f'<td><img src="{name}" height="200"></td>'
        if score_map is not None:
            hname = f"score_{idx:05d}.png"
            cv2.imwrite(os.path.join(self.out_dir, hname),
                        score_map_heatmap(score_map, (200, 200)))
            row += f'<td><img src="{hname}" height="200"></td>'
        self._entries.append(f"<tr><td>{idx}</td>{row}</tr>")

    def write_index(self) -> str:
        path = os.path.join(self.out_dir, "index.html")
        with open(path, "w") as f:
            f.write("<html><body><table border=1>\n"
                    "<tr><th>frame</th><th>overlay</th><th>score map</th></tr>\n"
                    + "\n".join(self._entries) + "\n</table></body></html>\n")
        return path


def plot_curves(curves: dict[str, np.ndarray], xlabel: str, ylabel: str,
                out_path: str, x: np.ndarray | None = None) -> str:
    """Success/precision plot PNG (plotting.py analog)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(6, 4.5))
    for name, y in curves.items():
        xs = x if x is not None else np.linspace(0, 1, len(y))
        ax.plot(xs, y, label=f"{name} [{float(np.mean(y)):.3f}]")
    ax.set_xlabel(xlabel)
    ax.set_ylabel(ylabel)
    ax.grid(True, alpha=0.3)
    ax.legend()
    fig.tight_layout()
    fig.savefig(out_path, dpi=120)
    plt.close(fig)
    return out_path

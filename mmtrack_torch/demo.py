"""Demo: run any recipe of the registry over a sequence and dump
visualizations, port of tools/demo.py (the reference's per-tracker
test.py / run.sh entries, RGBE/benchmark.py:25-49).

    python -m mmtrack_torch.demo --tracker vipt_deep_rgbt --out /tmp/demo
    python -m mmtrack_torch.demo --tracker siamfc --frames 30 --dashboard --pause

By default a synthetic multi-modal sequence is generated; --rgb_dir /
--x_dir / --init_box give a real one. Frames, boxes and score maps go to
<out>/index.html (vis.py::TrackingVisualizer). --dashboard serves the live
debug UI (vis_server.py) on localhost and prints its URL; --pause starts
it paused, so each frame waits for a step (Space / ArrowRight in the
page, or POST {"action": "step"} to /control). The device defaults to
the card (pass --device cpu to run on the CPU); recipes run on seeded
weights.
"""

from __future__ import annotations

import argparse
import os

import torch


def main(argv=None) -> int:
    from mmtrack_torch.utils.optouts import refuse

    refuse("mmtrack_torch.demo")
    p = argparse.ArgumentParser()
    p.add_argument("--tracker", default="vipt_deep_rgbt")
    p.add_argument("--out", default="./workspace/demo")
    p.add_argument("--frames", type=int, default=20)
    p.add_argument("--rgb_dir", default=None, help="directory of RGB frames")
    p.add_argument("--x_dir", default=None, help="directory of X-modality frames")
    p.add_argument("--init_box", default=None, help="x,y,w,h for real sequences")
    p.add_argument("--dtype", default="rgbrgb")
    p.add_argument("--dashboard", action="store_true",
                   help="serve the live interactive debug UI "
                        "(pause/step, score-map heatmaps) on localhost")
    p.add_argument("--pause", action="store_true",
                   help="start the dashboard paused (step frame-by-frame)")
    p.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    args = p.parse_args(argv)

    from mmtrack_torch.data.composition import get_x_frame
    from mmtrack_torch.data.synthetic import make_synthetic_sequence
    from mmtrack_torch.registry import build_tracker
    from mmtrack_torch.utils.device import require_cuda, set_f32_precision
    from mmtrack_torch.vis import TrackingVisualizer

    device = torch.device(args.device)
    if device.type == "cuda":
        require_cuda()
        set_f32_precision()
    if args.rgb_dir:
        rgbs = sorted(os.path.join(args.rgb_dir, f) for f in os.listdir(args.rgb_dir))
        xs = (sorted(os.path.join(args.x_dir, f) for f in os.listdir(args.x_dir))
              if args.x_dir else [None] * len(rgbs))
        frames = [get_x_frame(r, x, args.dtype) for r, x in zip(rgbs, xs)]
        init_box = [float(v) for v in args.init_box.split(",")]
        gt = None
    else:
        arr, gt = make_synthetic_sequence(n_frames=args.frames)
        frames = list(arr)
        init_box = gt[0].tolist()

    tracker = build_tracker(args.tracker, device=device)
    vis = TrackingVisualizer(args.out)
    dash = None
    if args.dashboard:
        from mmtrack_torch.vis_server import DebugDashboard

        dash = DebugDashboard(pause_mode=args.pause)
    try:
        tracker.initialize(frames[0], {"init_bbox": init_box})
        vis.add_frame(0, frames[0], init_box, gt_box=None if gt is None else gt[0])
        for t in range(1, len(frames)):
            out = tracker.track(frames[t])
            vis.add_frame(t, frames[t], out["target_bbox"],
                          gt_box=None if gt is None else gt[t],
                          score=out.get("best_score"), mask=out.get("segmentation"))
            if dash is not None:
                dash.register((frames[t], out["target_bbox"], out.get("segmentation")),
                              "tracking", 1, "Tracking")
                if out.get("score_map") is not None:
                    dash.register(out["score_map"], "heatmap", 1, "Score Map")
                dash.register({"frame": t, "score": round(float(out.get("best_score", 0)), 4)},
                              "info_dict", 1, "Status")
                dash.wait_if_paused()
            print(f"frame {t}: box={['%.1f' % v for v in out['target_bbox']]} "
                  f"score={out.get('best_score', 0):.3f}", flush=True)
    finally:
        if dash is not None:
            dash.close()
    print("visualization:", vis.write_index())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

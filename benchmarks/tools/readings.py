"""The readings that the limits of `correct` are set from, many seeds in
one process on the card:

    python3 -m benchmarks.tools.readings --workloads <cell> [...] --seeds <n> [...]
        [--seconds 2] [--control] [--fault NAME] [--out FILE]

For each cell and seed, one run of the harness's own path
(`run.run_cell`: set-up, a window of --seconds, the check against the
reference), its numbers the lower reading. With --control also the
control: the reference computed in fp8 on the same frames or steps (the
upper reading). With --fault the program runs with one planted fault
(FAULTS); its numbers must fail a limit. One JSON line per cell and seed,
on standard output and appended to --out.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from benchmarks import run as bench_run


# Each fault replaces one function of the program through `put`
# (setattr, or a test's monkeypatch.setattr).

def _state_unchanged(put=setattr):
    from mmtrack_torch.trackers import vipt_tracker as vt

    orig = vt.vipt_track_step

    def broken(rt, model, state, frames, crop=vt.crop_resize_normalized):
        _, boxes, scores = orig(rt, model, state, frames, crop)
        return state, boxes, scores

    put(vt, "vipt_track_step", broken)


def _half_batch_track(put=setattr):
    from mmtrack_torch.trackers import vipt_tracker as vt

    orig = vt.vipt_track_step

    def broken(rt, model, state, frames, crop=vt.crop_resize_normalized):
        h = frames.shape[0] // 2
        _, b, s = orig(rt, model, {k: v[:h] for k, v in state.items()}, frames[:h], crop)
        b, s = torch.cat([b, b]), torch.cat([s, s])
        return {"box": b, "template": state["template"]}, b, s

    put(vt, "vipt_track_step", broken)


def _answer_altered(put=setattr):
    from mmtrack_torch.trackers import vipt_tracker as vt

    orig = vt.vipt_step_from_crop

    def broken(rt, model, template, prev_box, search, rf, img_h, img_w):
        box, score = orig(rt, model, template, prev_box, search, rf, img_h, img_w)
        grow = torch.zeros_like(box)          # lane 0's box 1.2 times as large, same centre
        grow[0] = torch.stack([-0.1 * box[0, 2], -0.1 * box[0, 3], 0.2 * box[0, 2],
                               0.2 * box[0, 3]])
        return box + grow, score

    put(vt, "vipt_step_from_crop", broken)


def _half_batch_train(put=setattr):
    from mmtrack_torch.train import train_step as ts

    orig = ts.batch_to_device

    def broken(batch, device):
        out = orig(batch, device)
        return {k: v[: v.shape[0] // 2] for k, v in out.items()}

    put(ts, "batch_to_device", broken)


def _crop_shifted(put=setattr):
    """Every search crop cut one pixel to the right of the box the step
    was given (the box is kept for the map back)."""
    from mmtrack_torch.trackers import vipt_tracker as vt

    orig = vt.vipt_track_step

    def broken(rt, model, state, frames, crop=vt.crop_resize_normalized):
        def shifted(frames, boxes, *args):
            one = torch.zeros_like(boxes)             # device ops only: the step is captured
            one[:, 0] = 1.0
            return crop(frames, boxes + one, *args)

        return orig(rt, model, state, frames, shifted)

    put(vt, "vipt_track_step", broken)


def _stale_frame_track(put=setattr):
    """Each step of a chunk tracks the previous frame's pixels (the
    chunk's first frame twice)."""
    from mmtrack_torch.trackers import vipt_tracker as vt

    orig = vt.vipt_track_scan_batched

    def broken(rt, model, state, frames, crop=vt.crop_resize_normalized):
        return orig(rt, model, state, torch.cat([frames[:1], frames[:-1]]), crop)

    put(vt, "vipt_track_scan_batched", broken)


def _stale_frame_online(put=setattr):
    """Each frame tracks the previous call's planes (a staging buffer
    swapped one frame late)."""
    from mmtrack_torch.parallel import batched_eval as be

    orig = be.BatchedViPTTracker.track_split
    last = {}

    def broken(self, rgb, idx):
        prev = last.get("planes", (rgb, idx))
        last["planes"] = (rgb.copy(), idx.copy())
        return orig(self, *prev)

    put(be.BatchedViPTTracker, "track_split", broken)


def _compose_swapped(put=setattr):
    """The device compose appends the colormap's three channels in
    reverse order (RGB for BGR)."""
    from mmtrack_torch.parallel import batched_eval as be

    orig = be.compose_rgb_index_device

    def broken(rgb, idx, lut):
        return orig(rgb, idx, lut.flip(-1))

    put(be, "compose_rgb_index_device", broken)


FAULTS = {"state_unchanged": _state_unchanged, "half_batch_track": _half_batch_track,
          "answer_altered": _answer_altered, "half_batch_train": _half_batch_train,
          "crop_shifted": _crop_shifted, "stale_frame_track": _stale_frame_track,
          "stale_frame_online": _stale_frame_online, "compose_swapped": _compose_swapped}
# the faults each mode of cell can have
MODE_FAULTS = {"track": ["state_unchanged", "half_batch_track", "answer_altered",
                         "crop_shifted", "stale_frame_track"],
               "online": ["state_unchanged", "answer_altered", "crop_shifted",
                          "stale_frame_online", "compose_swapped"],
               "train": ["half_batch_train"]}


def _stats(a) -> dict:
    a = np.asarray(a)
    return {"mean": float(a.mean()), "p50": float(np.median(a)),
            "p90": float(np.quantile(a, 0.9)), "p99": float(np.quantile(a, 0.99)),
            "max": float(a.max()), "n": int(a.size), "raw": [float(v) for v in a]}


def reading(name: str, seed: int, seconds: float, control: bool, device=None) -> dict:
    """One run of the cell through the harness's path, with its numbers,
    limits and (with `control`) the control's numbers."""
    device = device or torch.device("cuda", 0)
    out = bench_run.run_cell(name, seed, seconds, False, device, control=control)
    if out["leaked"]:
        raise RuntimeError(f"the run loaded {out['leaked']}")
    checked = out["checked"]
    line = {"workload": name, "seed": seed, "metrics": out["work"]["metrics"],
            "attempted": out["work"]["attempted"], "memory_peak_bytes": out["memory"],
            "check_s": out["check_s"], "numbers": checked["numbers"],
            "limits": out["spec"]["limits"]["limits"]}
    for key in ("per_frame", "control_per_frame"):
        if key in checked:
            line[key] = {k: _stats(v) for k, v in checked[key].items()}
    for key in ("control", "left_out", "worst_leaves", "losses", "ref_losses"):
        if key in checked:
            line[key] = checked[key]
    del out
    torch.cuda.empty_cache()
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workloads", nargs="+", required=True)
    ap.add_argument("--seeds", nargs="+", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--fault", choices=sorted(FAULTS))
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    bench_run._cache_dirs()
    if args.fault:
        FAULTS[args.fault]()
    for name in args.workloads:
        for seed in args.seeds:
            try:
                line = reading(name, seed, args.seconds, args.control)
            except Exception as e:  # noqa: BLE001  (a failed seed is a reading too)
                line = {"workload": name, "seed": seed, "error": repr(e)[:2000]}
                torch.cuda.empty_cache()
            line["fault"] = args.fault
            text = json.dumps(line)
            print(text, flush=True)
            if args.out:
                with open(args.out, "a") as f:
                    f.write(text + "\n")
    print(torch.__version__, torch.version.cuda, torch.cuda.get_device_name(0), file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

"""Batched OPE: evaluate many sequences in lockstep on one card, port of
mmtrack_tpu/eval/batched_ope.py.

The replacement for the reference's process-pool eval parallelism
(test_rgbt_mgpus.py:180-190): sequences are bucketed by frame resolution,
B of them advance together through the batched track step
(mmtrack_torch.parallel.batched_eval), and each sequence's trajectory is
cut to its own length on the host. Protocol-identical output files.

Disk-backed 'rgbcolormap' batches (DepthTrack, CDTB) stream planes rather
than composed frames: RGB + the JET-index plane at 4 B/px by default
(bit-identical to the host-composed frames), or with MMTRACK_STREAM=yuv420
the raw 4:2:0 planes + index at 2.5 B/px (decode-grade, needs the native
decoder). The next frame is decoded on a thread while the card steps the
current one. Under `utils/profiling.py::tracing()` each streamed step is
one chunk of spans: `ope.decode_wait` (the host waits for the decode
thread), `ope.upload` and `ope.compose` (host and device), `track.replay`
(the graph's submission) and `ope.read` (the boxes to the host).
"""

from __future__ import annotations

import os
import threading
import time
from collections import defaultdict

import numpy as np

from mmtrack_torch.data.composition import get_x_frame
from mmtrack_torch.eval.datasets import EvalSequence
from mmtrack_torch.eval.ope import result_path, save_result
from mmtrack_torch.parallel.batched_eval import BatchedViPTTracker
from mmtrack_torch.utils import profiling


def _frame(seq: EvalSequence, i: int, loaders=None):
    i = min(i, len(seq) - 1)  # finished sequences idle on their last frame
    if loaders is not None and seq.name in loaders:
        return loaders[seq.name](i)
    return get_x_frame(seq.rgb_frames[i], seq.x_frames[i], seq.dtype,
                       depth_clip=seq.depth_clip)


def bucket_sequences(sequences: list[EvalSequence], loaders=None) -> dict:
    """Group sequences by (H, W, C) of their first frame."""
    buckets = defaultdict(list)
    for seq in sequences:
        shape = _frame(seq, 0, loaders).shape
        buckets[shape].append(seq)
    return dict(buckets)


def _can_split_stream(seqs: list[EvalSequence], loaders) -> bool:
    """True when every sequence is a disk-backed 'rgbcolormap' pair — the
    4 B/px rgb+JET-index streaming path (track_split) applies."""
    if loaders:
        return False
    return all(s.dtype == "rgbcolormap"
               and s.rgb_frames[0] and s.x_frames[0]
               and isinstance(s.rgb_frames[0], str) for s in seqs)


def _can_yuv_stream(seqs: list[EvalSequence]) -> bool:
    """Opt-in minimum-byte wire format (MMTRACK_STREAM=yuv420): raw 4:2:0
    planes at 2.5 B/px, device-side chroma upsample + BT.601 + colormap.
    Decode-grade (≤1 LSB of the cv2 decode) but NOT bit-exact — hence
    opt-in; every source must be a plain 4:2:0 JPEG with dims % 16 == 0,
    and the native decoder must load (data/native_io.py::decoder)."""
    if os.environ.get("MMTRACK_STREAM", "") != "yuv420":
        return False
    from mmtrack_torch.data.native_io import decode_pair_yuv_index

    for s in seqs:
        try:
            import cv2
            probe = cv2.imread(s.rgb_frames[0])
            H, W = probe.shape[:2]
            y = np.zeros((H, W), np.uint8)
            cb = np.zeros((H // 2, W // 2), np.uint8)
            if not decode_pair_yuv_index(s.rgb_frames[0], s.x_frames[0], y,
                                         cb, cb.copy(),
                                         np.zeros((H, W), np.uint8),
                                         clip=s.depth_clip):
                return False
        except Exception:
            return False
    return True


def _decode_split(seqs: list[EvalSequence], t: int,
                  rgb: np.ndarray, idx: np.ndarray) -> None:
    """Fill (B,H,W,3)+(B,H,W) staging buffers for frame t (native fused
    decoder, cv2 fallback; data/native_io.py)."""
    from mmtrack_torch.data.native_io import decode_pair_rgb_index

    for k, s in enumerate(seqs):
        i = min(t, len(s) - 1)
        decode_pair_rgb_index(s.rgb_frames[i], s.x_frames[i],
                              rgb[k], idx[k], clip=s.depth_clip)


def _decode_yuv(seqs: list[EvalSequence], t: int, y: np.ndarray,
                cb: np.ndarray, cr: np.ndarray, idx: np.ndarray) -> None:
    """Fill raw 4:2:0 + index staging buffers for frame t (sources already
    qualified by _can_yuv_stream)."""
    from mmtrack_torch.data.native_io import decode_pair_yuv_index

    for k, s in enumerate(seqs):
        i = min(t, len(s) - 1)
        if not decode_pair_yuv_index(s.rgb_frames[i], s.x_frames[i], y[k], cb[k],
                                     cr[k], idx[k], clip=s.depth_clip):
            raise IOError(f"raw 4:2:0 decode failed for {s.rgb_frames[i]}")


def run_batch(tracker: BatchedViPTTracker, seqs: list[EvalSequence],
              loaders=None) -> list[dict]:
    """Track a same-resolution batch in lockstep; returns per-seq results.

    Disk-backed rgbcolormap batches stream rgb + JET-index planes (4 B/px,
    device-side colormap; parallel/batched_eval.py::track_split) with the
    next frame decoded on a thread while the device steps the current one.
    Everything else takes the host-composed full-frame path.

    Each result names the wire its frames took: 'rgb_index', 'yuv420' or
    'frames' (host-composed). A raw 4:2:0 decode that fails after the
    batch qualified raises."""
    B = len(seqs)
    max_len = max(len(s) for s in seqs)
    frames0 = np.stack([_frame(s, 0, loaders) for s in seqs])
    boxes0 = np.stack([s.gt[0] for s in seqs]).astype(np.float32)
    split = _can_split_stream(seqs, loaders)

    t0 = time.perf_counter()
    tracker.initialize(frames0, boxes0)
    all_boxes = np.zeros((max_len, B, 4))
    all_scores = np.zeros((max_len - 1, B))
    all_boxes[0] = boxes0
    if split and max_len > 1:
        H, W = frames0.shape[1:3]
        if _can_yuv_stream(seqs):
            bufs = [(tracker.host_buffer((B, H, W)),
                     tracker.host_buffer((B, H // 2, W // 2)),
                     tracker.host_buffer((B, H // 2, W // 2)),
                     tracker.host_buffer((B, H, W))) for _ in range(2)]
            decode, step, wire = _decode_yuv, tracker.track_yuv, "yuv420"
        else:
            bufs = [(tracker.host_buffer((B, H, W, 3)),
                     tracker.host_buffer((B, H, W))) for _ in range(2)]
            decode, step, wire = _decode_split, tracker.track_split, "rgb_index"
        decode(seqs, 1, *bufs[1])
        errs: list = []

        def _decode_guard(*a):
            try:
                decode(*a)
            except Exception as e:  # surface on join, not as stale frames
                errs.append(e)

        th = None
        for t in range(1, max_len):
            s = t % 2
            if th is not None:
                with profiling.span("ope.decode_wait"):
                    th.join()
                if errs:
                    raise errs[0]
            if t + 1 < max_len:  # decode t+1 while the device steps t
                th = threading.Thread(target=_decode_guard,
                                      args=(seqs, t + 1, *bufs[(t + 1) % 2]))
                th.start()
            else:
                th = None
            b, sc = step(*bufs[s])
            all_boxes[t] = b
            all_scores[t - 1] = sc
    else:
        wire = "frames"
        for t in range(1, max_len):
            frames = np.stack([_frame(s, t, loaders) for s in seqs])
            b, sc = tracker.track(frames)
            all_boxes[t] = b
            all_scores[t - 1] = sc
    elapsed = time.perf_counter() - t0

    results = []
    n_frames_total = sum(len(s) - 1 for s in seqs)
    for k, seq in enumerate(seqs):
        n = len(seq)
        results.append({
            "name": seq.name,
            "boxes": all_boxes[:n, k],
            "confidences": all_scores[:n - 1, k],
            "elapsed": elapsed * (n - 1) / max(n_frames_total, 1),
            "fps": n_frames_total / max(elapsed, 1e-9),  # aggregate per card
            "wire": wire,
        })
    return results


def run_dataset_batched(tracker_factory, sequences: list[EvalSequence],
                        results_root: str, dataset: str, config_name: str,
                        batch_size: int = 8, loaders=None,
                        verbose: bool = True) -> list[dict]:
    """Bucketed, batched, resume-aware dataset evaluation."""
    todo = [s for s in sequences if not os.path.exists(
        result_path(results_root, dataset, config_name, s.name))]
    if verbose:
        for s in sequences:
            if s not in todo:
                print(f"-1 {s.name}")
    outputs = []
    for shape, bucket in bucket_sequences(todo, loaders).items():
        for i in range(0, len(bucket), batch_size):
            chunk = bucket[i:i + batch_size]
            tracker = tracker_factory()
            results = run_batch(tracker, chunk, loaders)
            for seq, res in zip(chunk, results):
                save_result(result_path(results_root, dataset, config_name,
                                        seq.name), res,
                            fmt=seq.save_fmt, delimiter=seq.save_delimiter)
                if verbose:
                    print(f"{seq.name} , fps:{res['fps']:.2f}")
            outputs += results
    return outputs

"""Lockstep tracking: B sequences advance a chunk of T frames per call
through the program's chunked scan (one CUDA graph per chunk shape), and
each chunk's boxes and scores are copied to the host. One chunk is in
flight ahead: the host launches chunk k + 1 (its graph launch takes
milliseconds of host time for some thousand kernels) before it waits for
chunk k's boxes, as an offline evaluator keeps the card fed; the state
passes from chunk to chunk on the device.

Frames come from a pool made on the device (traffic.render), cut into
`sequences` clips of 1 + `sequence_frames` frames: a batch of B sequences
is initialised on its first frame (the program's template crop) and
tracked for `sequence_frames` frames, then the next batch starts; the
clips cycle. The warm-up (capture, one replay) runs on the first clip and
the window starts on a clip's first frame. Every chunk's answers and its
input boxes are kept on the host; after the window a seeded sample of the
frames, as many of every lane, is recomputed by the reference from the
program's previous box. The sample is drawn from the first
`check.first_frames` frames of each sequence: random weights steer a box
to the image's border within some fifty frames, where it shrinks to the
10-pixel margin and every cell of the score map clips to one box, which
any precision reads alike.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from benchmarks import compare, system, traffic, weights
from benchmarks.reference import vipt as ref
from benchmarks.seeds import rng


class Cell:
    unit = "frames"

    def __init__(self, cfg, traffic_p, seed, device):
        self.cfg, self.p, self.seed, self.device = cfg, traffic_p, seed, device

    # -------------------------------------------------------------- set-up
    def setup(self) -> None:
        from mmtrack_torch.trackers.vipt_tracker import make_track_scan, vipt_track_scan_batched

        cfg, p, dev = self.cfg, self.p, self.device
        if dev.type == "cuda":
            system.load_kernels()
        self.params = weights.make(cfg, self.seed, dev)
        self.model = system.model(cfg, dev)
        system.load(self.model, self.params)
        self.rt = system.runtime(cfg)
        frames, boxes = traffic.render(p, cfg["model"]["channels"], self.seed, dev)
        n = p["sequence_frames"] + 1
        self.seqs = frames.reshape(p["sequences"], n, *frames.shape[1:])  # (S, 1+L, B, H, W, C)
        self.init_boxes = boxes.reshape(p["sequences"], n, *boxes.shape[1:])[:, 0].clone()
        del frames
        self.per_seq = p["sequence_frames"] // p["chunk"]
        if dev.type == "cuda":
            self.scan = make_track_scan(self.rt, self.model, dev)
        else:
            self.scan = torch.inference_mode()(
                lambda s, f: vipt_track_scan_batched(self.rt, self.model, s, f))
        self.init_host = self.init_boxes.cpu().numpy()
        pin = dev.type == "cuda"
        T, B = p["chunk"], p["lanes"]
        self.host = [(torch.empty((T, B, 4), pin_memory=pin), torch.empty((T, B), pin_memory=pin))
                     for _ in range(2)]
        self.k, self.pending = 0, None
        self.records = []
        for _ in range(p["warm_chunks"]):           # capture, then one replay
            self._chunk(record=False)
        self._drain(record=False)
        self.k = -(-self.k // self.per_seq) * self.per_seq   # the window starts a clip

    def _chunks(self, seq: int) -> torch.Tensor:
        """(chunks, T, B, H, W, C) of sequence `seq`'s tracked frames."""
        T = self.p["chunk"]
        return self.seqs[seq, 1:].reshape(self.per_seq, T, *self.seqs.shape[2:])

    def _launch(self) -> tuple:
        """Start the next chunk: its copies and graph replay, and the copy of
        its boxes and scores to pinned host buffers, all on the stream."""
        seq, j = divmod(self.k, self.per_seq)
        seq %= self.p["sequences"]
        prev = None                                  # the last box of the chunk before
        if j == 0:                                   # the next batch of sequences
            from mmtrack_torch.trackers.vipt_tracker import vipt_init_state

            with torch.profiler.record_function("bench.init"), torch.inference_mode():
                self.state = vipt_init_state(self.rt, self.seqs[seq, 0].contiguous(),
                                             self.init_boxes[seq])
            prev = self.init_host[seq]
        with torch.profiler.record_function("bench.scan"):
            self.state, boxes, scores = self.scan(self.state, self._chunks(seq)[j])
        hb, hs = self.host[self.k % 2]
        hb.copy_(boxes, non_blocking=True)
        hs.copy_(scores, non_blocking=True)
        done = None
        if self.device.type == "cuda":
            done = torch.cuda.Event()
            done.record()
        self.k += 1
        return (seq, j), prev, hb, hs, done

    def _finish(self, launched: tuple, record: bool) -> None:
        """Wait for a launched chunk's boxes on the host and keep them."""
        c, prev, hb, hs, done = launched
        with torch.profiler.record_function("bench.read_boxes"):
            if done is not None:
                done.synchronize()
        b, s = hb.numpy().copy(), hs.numpy().copy()
        prev = self.last_box if prev is None else prev
        if record:
            self.records.append((c, prev, b, s, c[1] == 0))
        self.last_box = b[-1]

    def _chunk(self, record: bool = True) -> None:
        """Launch a chunk, then read the one launched before it: the host
        launches chunk k + 1's graph while the card runs chunk k."""
        launched = self._launch()
        if self.pending is not None:
            self._finish(self.pending, record)
        self.pending = launched

    def _drain(self, record: bool = True) -> None:
        if self.pending is not None:
            self._finish(self.pending, record)
            self.pending = None

    # -------------------------------------------------------------- window
    def window(self, seconds: float) -> dict:
        self.records = []
        t0 = time.perf_counter()
        while True:
            self._chunk()
            if time.perf_counter() - t0 >= seconds:
                break
        self._drain()
        elapsed = time.perf_counter() - t0
        n = len(self.records) * self.p["chunk"] * self.p["lanes"]
        return {"attempted": n, "metrics": {"track_fps": n / elapsed}}

    def traced_work(self, share: float = 1.0) -> dict:
        start = len(self.records)
        for _ in range(max(1, round(self.p["trace"]["chunks"] * share))):
            self._chunk()
        self._drain()
        steps = (len(self.records) - start) * self.p["chunk"]
        t, s = self.cfg["template"], self.cfg["search"]
        crops = []                           # (boxes, factor, size) of each crop launch
        for _, prev, b, _, init in self.records[start:]:
            if init:
                crops.append((prev, t["factor"], t["size"]))
            crops += [(box, s["factor"], s["size"]) for box in [prev, *b[:-1]]]
        return {"attempted": steps * self.p["lanes"], "steps": steps, "batch": self.p["lanes"],
                "frames": steps * self.p["lanes"], "crops": crops}

    def release(self) -> None:
        del self.scan, self.model, self.state
        if self.device.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.empty_cache()

    # -------------------------------------------------------------- check
    def samples(self):
        """(chunk, t, lane, prev box, box, score) of a seeded sample, as
        many frames of every lane, from the first `first_frames` frames of
        each sequence (each tracked frame once, though the clips cycle)."""
        B, T, first = self.p["lanes"], self.p["chunk"], self.p["check"]["first_frames"]
        lanes = [{} for _ in range(B)]
        for c, prev, b, s, _ in self.records:
            for t in range(b.shape[0]):
                if c[1] * T + t >= first:
                    break
                p_t = prev if t == 0 else b[t - 1]
                for lane in range(B):
                    lanes[lane].setdefault((c, t), (c, t, lane, p_t[lane], b[t, lane],
                                                    s[t, lane]))
        lanes = [list(rows.values()) for rows in lanes]
        g = rng(self.seed, "check")
        each = min(self.p["check"]["samples"] // B, len(lanes[0]))
        return [rows[i] for rows in lanes for i in sorted(g.choice(len(rows), each, replace=False))]

    def check(self, control: bool = False) -> dict:
        dev, T = self.device, self.p["chunk"]
        rows = self.samples()

        def blocks():
            z_all = torch.stack([ref.template(self.cfg, self.seqs[q, 0], self.init_boxes[q])
                                 for q in range(self.p["sequences"])])   # (S, B, ...)
            blk = self.p["check"]["block"]
            for i in range(0, len(rows), blk):
                part = rows[i:i + blk]
                yield (torch.stack([z_all[c[0], lane] for c, t, lane, *_ in part]),
                       torch.stack([self.seqs[c[0], 1 + c[1] * T + t, lane]
                                    for c, t, lane, *_ in part]),
                       torch.tensor(np.stack([r[3] for r in part]), device=dev),
                       torch.tensor(np.stack([r[4] for r in part]), device=dev),
                       torch.tensor(np.array([r[5] for r in part]), device=dev))

        return dict(compare.judge_frames(self.params, self.cfg, blocks(), [r[2] for r in rows],
                                         control), compared=len(rows))

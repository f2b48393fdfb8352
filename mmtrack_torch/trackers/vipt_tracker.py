"""ViPT tracker runtime, port of mmtrack_tpu/trackers/vipt_tracker.py.

The step is batched natively: frames (B, H, W, C) uint8 and boxes (B, 4)
advance B sequences at once (the JAX package vmaps a single-sequence
step). One step: batched search crop around the previous boxes (the crop
kernel on CUDA), ViPTrack forward, Hann window on the centre heatmap,
`cal_bbox` decode, map back to image coordinates and clip with a 10 px
margin (ViPT lib/test/tracker/vipt.py:64-110).

A chunk of T frames runs as `vipt_track_scan_batched` (the JAX package's
`lax.scan` of the step): on any device a plain loop of the step, and on
the card `make_track_scan` replays the whole chunk as one CUDA graph, the
counterpart of the jitted scan with its state donated (bench.py:378).
The step's constants (mean and std, the CE template mask, the Hann
window) are made once per runtime, device and channel count and shared by
both, so the step copies nothing from the host and can be captured.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch

from mmtrack_torch.data.processing import sample_target_np
from mmtrack_torch.models.heads import cal_bbox
from mmtrack_torch.models.vipt import ViPTrack, ce_keep_schedule, generate_ctr_mask
from mmtrack_torch.ops.box import clip_box
from mmtrack_torch.ops.crop import crop_resize_normalized
from mmtrack_torch.ops.window import hann2d

# ImageNet statistics for both modality triplets (PreprocessorMM,
# ViPT lib/test/tracker/data_utils.py:15-24).
MEAN_6CH = np.array([0.485, 0.456, 0.406] * 2, np.float32)
STD_6CH = np.array([0.229, 0.224, 0.225] * 2, np.float32)


@dataclass(frozen=True)
class ViPTRuntime:
    """Static runtime hyperparameters; the same fields as the JAX package's."""
    template_factor: float = 2.0
    template_size: int = 128
    search_factor: float = 4.0
    search_size: int = 256
    stride: int = 16
    margin: float = 10.0
    ce_template_range: str = "CTR_POINT"
    ce_loc: tuple[int, ...] = (3, 6, 9)
    ce_keep_ratio: tuple[float, ...] = (0.7, 0.7, 0.7)

    @property
    def feat_sz(self) -> int:
        return self.search_size // self.stride

    @property
    def ce_keep_lens(self) -> tuple[int, ...]:
        n = (self.search_size // self.stride) ** 2
        return ce_keep_schedule(n, self.ce_loc, self.ce_keep_ratio)

    @classmethod
    def from_config(cls, cfg) -> "ViPTRuntime":
        return cls(
            template_factor=cfg.TEST.TEMPLATE_FACTOR,
            template_size=cfg.TEST.TEMPLATE_SIZE,
            search_factor=cfg.TEST.SEARCH_FACTOR,
            search_size=cfg.TEST.SEARCH_SIZE,
            stride=cfg.MODEL.BACKBONE.STRIDE,
            ce_template_range=cfg.MODEL.BACKBONE.CE_TEMPLATE_RANGE,
            ce_loc=tuple(cfg.MODEL.BACKBONE.CE_LOC),
            ce_keep_ratio=tuple(cfg.MODEL.BACKBONE.CE_KEEP_RATIO),
        )


# The step's constants are made once, as ordinary tensors even when the
# first call runs under inference mode, so a later step with autograd on
# can still use them.
@functools.lru_cache(maxsize=None)
def _stats(c: int, device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """The crop's mean and std for c channels on `device`."""
    with torch.inference_mode(False):
        return (torch.from_numpy(MEAN_6CH[:c]).to(device),
                torch.from_numpy(STD_6CH[:c]).to(device))


@functools.lru_cache(maxsize=None)
def _head_constants(rt: ViPTRuntime, device: torch.device):
    """The CE template mask and the Hann window of `rt` on `device`."""
    with torch.inference_mode(False):
        return (generate_ctr_mask(rt.template_size // rt.stride, rt.ce_template_range,
                                  device=device),
                hann2d(rt.feat_sz, rt.feat_sz, device=device))


def vipt_init_state(rt: ViPTRuntime, frames: torch.Tensor, init_boxes: torch.Tensor) -> dict:
    """Tracker state from the first frames (ViPTTrack.initialize,
    vipt.py:41-62): {'box' (B, 4) xywh, 'template' (B, T, T, C) f32
    normalised}. The template stays f32; the patch embed casts it on every
    step, as in the JAX package."""
    mean, std = _stats(frames.shape[-1], frames.device)
    boxes = init_boxes.to(device=frames.device, dtype=torch.float32)
    template, _ = crop_resize_normalized(frames, boxes, rt.template_factor,
                                         rt.template_size, mean, std)
    return {"box": boxes, "template": template}


def vipt_step_from_crop(rt: ViPTRuntime, model: ViPTrack, template: torch.Tensor,
                        prev_box: torch.Tensor, search: torch.Tensor,
                        resize_factor: torch.Tensor, img_h: float, img_w: float):
    """Forward + window + decode + map-back + clip from normalised search
    crops (vipt.py:71-110). Returns (boxes (B, 4), scores (B,)). The CENTER
    head's map is Hann-windowed and decoded; the CORNER and MLP heads'
    boxes and scores are taken as they are (JAX vipt_tracker.py:97-106)."""
    box_mask_z, window = _head_constants(rt, search.device)
    out = model(template, search, box_mask_z, rt.ce_keep_lens)
    if getattr(model, "head_type", "CENTER") == "CENTER":
        bbox, score = cal_bbox(window[None] * out["score_map"], out["size_map"],
                               out["offset_map"])
    else:
        bbox, score = out["pred_boxes"], out["max_score"]

    rf = resize_factor[:, None]
    pred = bbox * rt.search_size / rf                                  # (cx, cy, w, h)
    half_side = torch.full_like(resize_factor, 0.5 * rt.search_size) / resize_factor
    cx_prev = prev_box[:, 0] + 0.5 * prev_box[:, 2]
    cy_prev = prev_box[:, 1] + 0.5 * prev_box[:, 3]
    cx = pred[:, 0] + (cx_prev - half_side)
    cy = pred[:, 1] + (cy_prev - half_side)
    new_box = torch.stack([cx - 0.5 * pred[:, 2], cy - 0.5 * pred[:, 3],
                           pred[:, 2], pred[:, 3]], dim=1)
    return clip_box(new_box, img_h, img_w, margin=rt.margin), score


def vipt_track_step(rt: ViPTRuntime, model: ViPTrack, state: dict, frames: torch.Tensor):
    """One tracked frame for each of B sequences.
    Returns (new_state, boxes (B, 4), scores (B,))."""
    H, W, c = frames.shape[1], frames.shape[2], frames.shape[3]
    mean, std = _stats(c, frames.device)
    search, resize_factor = crop_resize_normalized(frames, state["box"], rt.search_factor,
                                                   rt.search_size, mean, std)
    boxes, scores = vipt_step_from_crop(rt, model, state["template"], state["box"], search,
                                        resize_factor, float(H), float(W))
    return {"box": boxes, "template": state["template"]}, boxes, scores


def vipt_track_scan_batched(rt: ViPTRuntime, model: ViPTrack, state: dict,
                            frames: torch.Tensor):
    """Track a chunk of frames (T, B, H, W, C) uint8 for B sequences in
    lockstep: `vipt_track_step` once per frame, on any device.
    Returns (final_state, boxes (T, B, 4), scores (T, B)).

    The loop that the JAX package's lax.scan runs; on the card
    `make_track_scan` replays the same steps as one CUDA graph and is held
    against this loop."""
    boxes, scores = [], []
    for t in range(frames.shape[0]):
        state, box, score = vipt_track_step(rt, model, state, frames[t])
        boxes.append(box)
        scores.append(score)
    return state, torch.stack(boxes), torch.stack(scores)


def vipt_track_scan(rt: ViPTRuntime, model: ViPTrack, state: dict, frames: torch.Tensor):
    """Track one sequence over a chunk of frames (T, H, W, C): the batched
    scan at B=1 with the batch axis squeezed from the state, the frames and
    the results. `state` is one sequence's ({'box' (4,), 'template'
    (T, T, C)}). Returns (final_state, boxes (T, 4), scores (T,))."""
    final, boxes, scores = vipt_track_scan_batched(
        rt, model, {k: v[None] for k, v in state.items()}, frames[:, None])
    return {k: v[0] for k, v in final.items()}, boxes[:, 0], scores[:, 0]


SCAN_WARMUP_STEPS = 1   # eager steps before a capture (make_track_scan)


class _ChunkGraph:
    """One CUDA graph of T tracking steps over static buffers.

    The chunk, the box and the template live in buffers allocated once;
    every call copies into them (never reallocates them, so the addresses
    that the graph baked in, TMA descriptors included, stay valid) and
    replays. The outputs live in the graph's private memory pool."""

    def __init__(self, rt: ViPTRuntime, model: ViPTrack, state: dict, frames: torch.Tensor,
                 device: torch.device):
        self.frames = torch.empty(frames.shape, dtype=torch.uint8, device=device)
        self.box = torch.empty(state["box"].shape, dtype=torch.float32, device=device)
        self.template = torch.empty(state["template"].shape, dtype=torch.float32,
                                    device=device)
        self._load(state, frames)
        static = {"box": self.box, "template": self.template}
        # Warm up on the capture stream first: library handles, the
        # convolutions' algorithm choice, the kernel library's build and
        # its one-time function attributes, and the step's constants are
        # made here, outside the capture.
        stream = torch.cuda.Stream(device)
        stream.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(stream):
            for _ in range(SCAN_WARMUP_STEPS):
                vipt_track_step(rt, model, static, self.frames[0])
        torch.cuda.current_stream(device).wait_stream(stream)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph, stream=stream):
            final, self.boxes, self.scores = vipt_track_scan_batched(rt, model, static,
                                                                     self.frames)
        self.final_box = final["box"]

    def _load(self, state: dict, frames: torch.Tensor) -> None:
        for dst, src in ((self.frames, frames), (self.box, state["box"]),
                         (self.template, state["template"])):
            if src.shape != dst.shape:
                raise ValueError(f"track scan captured for {tuple(dst.shape)}, "
                                 f"got {tuple(src.shape)}")
            dst.copy_(src)

    def __call__(self, state: dict, frames: torch.Tensor):
        self._load(state, frames)
        self.graph.replay()
        return {"box": self.final_box, "template": self.template}, self.boxes, self.scores


def make_track_scan(rt: ViPTRuntime, model: ViPTrack, device) -> Callable:
    """`vipt_track_scan_batched` on the card as one CUDA graph per chunk
    shape: the counterpart of jax.jit(partial(vipt_track_scan_batched, rt,
    model), donate_argnums=(1,)) (bench.py:378).

    Returns scan(state, frames) -> (final_state, boxes (T, B, 4), scores
    (T, B)), the arguments and results of `vipt_track_scan_batched`. The
    first call for a (T, B, H, W, C) warms up SCAN_WARMUP_STEPS eager steps
    and captures the T steps, each reading frame t of a static chunk
    buffer; every call copies the chunk (host or device) and the state into
    the static buffers and replays. A failed capture raises: there is no
    eager fallback.

    Donation: the results alias buffers that the next call of the same
    shape overwrites (passing the returned state back in is fine), as the
    jitted scan's donated state is gone after the call; clone what must
    outlive it. The launch counters of the kernel wrappers count at
    capture (and warm-up), not at replay.

    The CPU has no graphs: a CPU device raises (call
    `vipt_track_scan_batched` there)."""
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"make_track_scan captures CUDA graphs and needs a CUDA device, got "
                         f"{device}; on the CPU call vipt_track_scan_batched")
    if device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    graphs: dict[tuple, _ChunkGraph] = {}

    @torch.inference_mode()
    def scan(state: dict, frames: torch.Tensor):
        key = tuple(frames.shape)
        if key not in graphs:
            graphs[key] = _ChunkGraph(rt, model, state, frames, device)
        return graphs[key](state, frames)

    return scan


def as_frames(frames, device) -> torch.Tensor:
    """numpy or torch uint8 frames -> a contiguous tensor on `device`."""
    if isinstance(frames, np.ndarray):
        frames = torch.from_numpy(np.ascontiguousarray(frames))
    return frames.to(device).contiguous()


class ViPTTracker:
    """Single-sequence facade with the reference BaseTracker API
    (initialize/track). `model` must already hold its weights; it is moved
    to `device`.

    host_preproc=True swaps the crop kernel for the bit-exact host cv2
    twin (data/processing.py::sample_target_np, byte-identical to the
    reference's sample_target incl. cv2's fixed-point uint8 resize),
    normalised in numpy f32, and uploads the normalised crop instead of
    the frame (mmtrack_tpu/trackers/vipt_tracker.py:174-236). Use it for
    parity-critical evaluation; the device crop is about one intensity
    level off cv2's fixed-point rounding."""

    def __init__(self, model: ViPTrack, device, runtime: Optional[ViPTRuntime] = None,
                 host_preproc: bool = False):
        self.device = torch.device(device)
        self.model = model.to(self.device).eval()
        self.rt = runtime or ViPTRuntime()
        self.host_preproc = host_preproc
        self.state = None

    def _host_crop(self, image: np.ndarray, box, factor: float, size: int):
        """(1, S, S, C) normalised f32 crop on the device and its resize
        factor."""
        crop, rf, _ = sample_target_np(np.asarray(image), np.asarray(box, np.float64),
                                       factor, size)
        c = crop.shape[-1]
        normalized = (crop.astype(np.float32) / 255.0 - MEAN_6CH[:c]) / STD_6CH[:c]
        return torch.from_numpy(normalized[None]).to(self.device), rf

    @torch.inference_mode()
    def initialize(self, image: np.ndarray, info: dict) -> None:
        box = torch.tensor(np.asarray(info["init_bbox"], np.float32)[None])
        if self.host_preproc:
            template, _ = self._host_crop(image, info["init_bbox"], self.rt.template_factor,
                                          self.rt.template_size)
            self.state = {"box": box.to(self.device), "template": template}
        else:
            self.state = vipt_init_state(self.rt, as_frames(image[None], self.device), box)

    @torch.inference_mode()
    def track(self, image: np.ndarray, info: dict | None = None) -> dict:
        if self.host_preproc:
            H, W = image.shape[0], image.shape[1]
            prev = self.state["box"][0].cpu().numpy().astype(np.float64)
            search, rf = self._host_crop(image, prev, self.rt.search_factor,
                                         self.rt.search_size)
            rf = torch.tensor([rf], dtype=torch.float32, device=self.device)
            box, score = vipt_step_from_crop(self.rt, self.model, self.state["template"],
                                             self.state["box"], search, rf, float(H), float(W))
            self.state = {"box": box, "template": self.state["template"]}
        else:
            self.state, box, score = vipt_track_step(self.rt, self.model, self.state,
                                                     as_frames(image[None], self.device))
        return {"target_bbox": box[0].cpu().numpy().tolist(),
                "best_score": float(score[0])}

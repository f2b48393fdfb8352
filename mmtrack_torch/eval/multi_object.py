"""Multi-object tracking wrapper: one tracker per object, merged per-frame
reporting; the port's own copy of mmtrack_tpu/eval/multi_object.py
(:43-222), numpy only.

Rebuild of the DeT pytracking multi-object protocol driver
(RGBD/models/DeT/pytracking/evaluation/multi_object_wrapper.py:7-180),
used by `run_sequence(multiobj_mode='parallel')` for VOT2020-style
multi-object sequences. The TraX loop stays single-object
(mmtrack_torch/eval/vot.py); the multi-object driver lives at the
evaluation layer.

Semantics mirrored from the reference:

  - ``info`` dicts carry ``object_ids`` (all objects in the sequence),
    ``init_object_ids`` (objects to initialize now; mid-sequence entries
    create trackers on the fly, wrapper:158-175), an ``init_bbox`` dict
    keyed by object id, and optionally a LABELED ``init_mask`` (pixel
    value == int(object id));
  - per-object infos get ``init_other`` with every other object's init
    data (wrapper:39-52);
  - merged output: every key becomes ``{object_id: value}``, except
    ``segmentation`` which is merged into one labeled map: argmax over
    the per-object soft masks where the max exceeds
    ``segmentation_threshold``, else background 0 (wrapper:63-93);
  - a tracker class may override merging wholesale via a
    ``merge_results`` attribute (wrapper:95-101).

The mask trackers (trackers/lwl_tracker.py, stm_tracker.py) report
``segmentation`` as an (H, W) bool map, which the merge takes as the soft
mask when no ``segmentation_soft`` is given.
"""

from __future__ import annotations

import time
from collections import OrderedDict

import numpy as np


class MultiObjectWrapper:
    """Drives one tracker instance per object id.

    ``tracker_factory()`` must return an object with
    ``initialize(image, info)`` / ``track(image, info=None)`` returning
    dicts (``target_bbox``, optional ``segmentation`` /
    ``segmentation_soft`` / ``best_score``).
    """

    def __init__(self, tracker_factory, segmentation_threshold: float = 0.5):
        self.tracker_factory = tracker_factory
        self.segmentation_threshold = segmentation_threshold
        self.initialized_ids: list = []
        self.trackers: OrderedDict = OrderedDict()

    # -- info splitting (wrapper:37-52) --------------------------------
    def _split_info(self, info: dict) -> OrderedDict:
        info_split = OrderedDict()
        init_other = OrderedDict()
        for obj_id in info["init_object_ids"]:
            entry = {"object_ids": [obj_id],
                     "sequence_object_ids": info.get(
                         "sequence_object_ids", info.get("object_ids"))}
            other = {}
            if "init_bbox" in info:
                entry["init_bbox"] = info["init_bbox"][obj_id]
                other["init_bbox"] = entry["init_bbox"]
            if info.get("init_mask") is not None:
                m = (np.asarray(info["init_mask"]) == int(obj_id))
                entry["init_mask"] = m.astype(np.uint8)
                other["init_mask"] = entry["init_mask"]
            info_split[obj_id] = entry
            init_other[obj_id] = other
        for entry in info_split.values():
            entry["init_other"] = init_other
        return info_split

    @staticmethod
    def _set_defaults(out: dict, defaults: dict) -> dict:
        for k, v in defaults.items():
            if out.get(k) is None:
                out[k] = v
        return out

    # -- merging (wrapper:63-101) --------------------------------------
    def default_merge(self, out_all: OrderedDict) -> OrderedDict:
        merged = OrderedDict()
        out_first = next(iter(out_all.values()))
        keys = out_first.keys()

        if "segmentation" in keys and out_first["segmentation"] is not None:
            # deviation from wrapper:70-76: an object whose output carries
            # no mask (e.g. a mid-sequence box-only init while others
            # segment) contributes an empty soft mask instead of crashing
            # the np.stack
            shape = np.asarray(out_first["segmentation"]).shape
            soft = np.stack([
                np.zeros(shape, np.float32)
                if out.get("segmentation_soft",
                           out.get("segmentation")) is None
                else np.asarray(out.get("segmentation_soft",
                                        out["segmentation"]), np.float32)
                for out in out_all.values()])
            obj_ids = np.array([0, *map(int, out_all.keys())], np.uint8)
            merged["segmentation"] = obj_ids[np.where(
                soft.max(axis=0) > self.segmentation_threshold,
                soft.argmax(axis=0) + 1, 0)]

        for k in keys:
            if k != "segmentation":
                # .get: an object initialized this frame reports only the
                # init defaults; missing keys become None for it
                merged[k] = OrderedDict(
                    (obj_id, out.get(k)) for obj_id, out in out_all.items())
        return merged

    def merge_outputs(self, out_all: OrderedDict) -> OrderedDict:
        first = self.trackers[self.initialized_ids[0]]
        custom = getattr(first, "merge_results", None)
        return custom(out_all) if custom is not None else self.default_merge(
            out_all)

    # -- protocol (wrapper:103-180) ------------------------------------
    def initialize(self, image, info: dict):
        self.initialized_ids = []
        self.trackers = OrderedDict()
        if len(info["init_object_ids"]) == 0:
            return None

        init_split = self._split_info(info)
        self.trackers = OrderedDict(
            (obj_id, self.tracker_factory()) for obj_id in info["object_ids"])

        out_all = OrderedDict()
        for obj_id in info["init_object_ids"]:
            t0 = time.time()
            out = self.trackers[obj_id].initialize(image, init_split[obj_id])
            out = self._set_defaults(out or {}, {
                "target_bbox": init_split[obj_id].get("init_bbox"),
                "time": time.time() - t0,
                "segmentation": init_split[obj_id].get("init_mask")})
            out_all[obj_id] = out
        self.initialized_ids = list(info["init_object_ids"])
        return self.merge_outputs(out_all)

    def track(self, image, info: dict | None = None):
        info = info or {}
        prev_output = info.get("previous_output", OrderedDict())

        init_split = None
        if info.get("init_object_ids"):
            init_split = self._split_info(info)
            for entry in init_split.values():
                entry["previous_output"] = prev_output
            info["init_other"] = next(iter(init_split.values()))["init_other"]

        out_all = OrderedDict()
        for obj_id in self.initialized_ids:
            t0 = time.time()
            out = self.trackers[obj_id].track(image, info) \
                if _accepts_info(self.trackers[obj_id]) \
                else self.trackers[obj_id].track(image)
            out_all[obj_id] = self._set_defaults(
                out, {"time": time.time() - t0})

        if init_split is not None:
            for obj_id in info["init_object_ids"]:
                if obj_id not in self.trackers:
                    self.trackers[obj_id] = self.tracker_factory()
                t0 = time.time()
                out = self.trackers[obj_id].initialize(
                    image, init_split[obj_id])
                out_all[obj_id] = self._set_defaults(out or {}, {
                    "target_bbox": init_split[obj_id].get("init_bbox"),
                    "time": time.time() - t0,
                    "segmentation": init_split[obj_id].get("init_mask")})
            self.initialized_ids.extend(info["init_object_ids"])

        return self.merge_outputs(out_all)


def _accepts_info(tracker) -> bool:
    import inspect

    try:
        sig = inspect.signature(tracker.track)
    except (TypeError, ValueError):
        return False
    return len(sig.parameters) >= 2 or any(
        p.kind == inspect.Parameter.VAR_POSITIONAL
        for p in sig.parameters.values())


def run_multi_object_sequence(tracker_factory, frames, init_info: dict,
                              frame_infos: list | None = None) -> dict:
    """Run a multi-object sequence (VOT2020 protocol shape): per-frame
    merged outputs, threading ``previous_output`` like the reference's
    run_sequence does for multi-object datasets. ``frame_infos[i]`` may
    carry ``init_object_ids`` for objects entering at frame i+1.

    Returns {'boxes': {obj_id: (N,4) array}, 'segmentations': [labeled]}.
    """
    wrapper = MultiObjectWrapper(tracker_factory)
    out = wrapper.initialize(frames[0], init_info)
    per_obj = {obj: [np.asarray(b, np.float64)]
               for obj, b in out["target_bbox"].items()}
    segs = [out.get("segmentation")]
    prev = out
    for i in range(1, len(frames)):
        info = dict(frame_infos[i - 1]) if frame_infos and frame_infos[i - 1] \
            else {}
        info["previous_output"] = prev
        out = wrapper.track(frames[i], info)
        for obj, b in out["target_bbox"].items():
            per_obj.setdefault(obj, [np.full((4,), np.nan)] * i).append(
                np.asarray(b, np.float64))
        segs.append(out.get("segmentation"))
        prev = out
    return {"boxes": {k: np.stack(v) for k, v in per_obj.items()},
            "segmentations": segs}

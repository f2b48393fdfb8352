"""Training-time processing: box jitter, jittered centre crop, augmentation.

numpy/cv2 port of mmtrack_tpu/data/processing.py (ViPTProcessing,
KYSPairProcessing, jitter_box, transform_box_to_crop_np, grayscale_6ch,
from_config; :24-200, :204) and of mmtrack_tpu/ops/crop.py::sample_target_np (:254).
The JAX modules are numpy/cv2 code too, but importing them imports the JAX
ops package. The reference is ViPTProcessing (ViPT
lib/train/data/processing.py:40-138) with the transform chain of
base_functions.py:99-110: joint grayscale (p=.05) + hflip (p=.5), then per
crop brightness jitter (0.2) + hflip (p=.5) + ImageNet normalisation of
both modality triplets. Random draws come from the caller's
np.random.Generator in the JAX package's order, so the same generator
gives the same crops bit for bit.
"""

from __future__ import annotations

import math

import cv2
import numpy as np

MEAN_6 = np.array([0.485, 0.456, 0.406] * 2, np.float32)
STD_6 = np.array([0.229, 0.224, 0.225] * 2, np.float32)


def sample_target_np(im: np.ndarray, target_bb, search_area_factor: float,
                     output_sz: int | None = None):
    """Host/cv2 twin of the reference sample_target (bit-parity path).

    Returns (crop, resize_factor, att_mask) exactly like
    ViPT/lib/train/data/processing_utils.py:14-81 (att_mask marks padded area).
    """
    x, y, w, h = [float(v) for v in target_bb]
    crop_sz = math.ceil(math.sqrt(w * h) * search_area_factor)
    if crop_sz < 1:
        raise ValueError("Too small bounding box.")

    x1 = round(x + 0.5 * w - crop_sz * 0.5)
    x2 = x1 + crop_sz
    y1 = round(y + 0.5 * h - crop_sz * 0.5)
    y2 = y1 + crop_sz

    x1_pad = max(0, -x1)
    x2_pad = max(x2 - im.shape[1] + 1, 0)
    y1_pad = max(0, -y1)
    y2_pad = max(y2 - im.shape[0] + 1, 0)

    im_crop = im[y1 + y1_pad:y2 - y2_pad, x1 + x1_pad:x2 - x2_pad, :]
    im_crop_padded = cv2.copyMakeBorder(im_crop, y1_pad, y2_pad, x1_pad, x2_pad,
                                        cv2.BORDER_CONSTANT)
    H, W = im_crop_padded.shape[:2]
    att_mask = np.ones((H, W))
    end_x = None if x2_pad == 0 else -x2_pad
    end_y = None if y2_pad == 0 else -y2_pad
    att_mask[y1_pad:end_y, x1_pad:end_x] = 0

    if output_sz is not None:
        resize_factor = output_sz / crop_sz
        im_crop_padded = cv2.resize(im_crop_padded, (output_sz, output_sz))
        att_mask = cv2.resize(att_mask, (output_sz, output_sz)).astype(np.bool_)
        return im_crop_padded, resize_factor, att_mask
    return im_crop_padded, 1.0, att_mask.astype(np.bool_)


def jitter_box(box: np.ndarray, center_jitter: float, scale_jitter: float,
               rng: np.random.Generator) -> np.ndarray:
    """Exp-scale + center jitter (ViPTProcessing._get_jittered_box,
    processing.py:71-85)."""
    size = box[2:4] * np.exp(rng.standard_normal(2) * scale_jitter)
    max_offset = math.sqrt(size.prod()) * center_jitter
    center = box[0:2] + 0.5 * box[2:4] + max_offset * (rng.random(2) - 0.5)
    return np.concatenate([center - 0.5 * size, size]).astype(np.float32)


def transform_box_to_crop_np(box: np.ndarray, crop_box: np.ndarray,
                             resize_factor: float, crop_sz: int,
                             normalize: bool = True) -> np.ndarray:
    crop_center = crop_box[0:2] + 0.5 * crop_box[2:4]
    box_center = box[0:2] + 0.5 * box[2:4]
    out_center = (crop_sz - 1) / 2 + (box_center - crop_center) * resize_factor
    out_wh = box[2:4] * resize_factor
    out = np.concatenate([out_center - 0.5 * out_wh, out_wh]).astype(np.float32)
    return out / crop_sz if normalize else out


def grayscale_6ch(img: np.ndarray) -> np.ndarray:
    """Grayscale each modality triplet (ToGrayscale, transforms.py:265-282)."""
    out = img.copy()
    for c in range(0, img.shape[2], 3):
        g = cv2.cvtColor(img[..., c:c + 3], cv2.COLOR_RGB2GRAY)
        out[..., c:c + 3] = np.stack([g, g, g], axis=2)
    return out


class ViPTProcessing:
    """data dict -> fixed-size normalized crops + normalized boxes.

    Output: template (Nt, T, T, 6) float32 normalized, template_anno (Nt, 4)
    xywh in [0,1]; same for search; data['valid'] False when a jittered box
    collapses (crop_sz < 1, processing.py:113-120).
    """

    def __init__(self, search_area_factor: dict, output_sz: dict,
                 center_jitter_factor: dict, scale_jitter_factor: dict,
                 joint_grayscale_p: float = 0.05, joint_flip_p: float = 0.5,
                 brightness_jitter: float = 0.2, crop_flip_p: float = 0.5,
                 train_mode: bool = True):
        self.search_area_factor = search_area_factor
        self.output_sz = output_sz
        self.center_jitter_factor = center_jitter_factor
        self.scale_jitter_factor = scale_jitter_factor
        self.joint_grayscale_p = joint_grayscale_p
        self.joint_flip_p = joint_flip_p
        self.brightness_jitter = brightness_jitter
        self.crop_flip_p = crop_flip_p
        self.train_mode = train_mode

    def __call__(self, data: dict, rng: np.random.Generator) -> dict:
        # joint transforms: one roll shared by template and search
        if self.train_mode and rng.random() < self.joint_grayscale_p:
            data["template_images"] = [grayscale_6ch(f) for f in data["template_images"]]
            data["search_images"] = [grayscale_6ch(f) for f in data["search_images"]]
        if self.train_mode and rng.random() < self.joint_flip_p:
            for s in ("template", "search"):
                flipped, boxes = [], []
                for f, b in zip(data[s + "_images"], data[s + "_anno"]):
                    W = f.shape[1]
                    flipped.append(np.ascontiguousarray(f[:, ::-1]))
                    # reference flips coordinates as (W-1)-x
                    # (transforms.py:313), so x1 -> (W-1)-(x+w)
                    boxes.append(np.array([(W - 1) - (b[0] + b[2]), b[1],
                                           b[2], b[3]], np.float32))
                data[s + "_images"], data[s + "_anno"] = flipped, np.stack(boxes)

        for s in ("template", "search"):
            jittered = [jitter_box(b, self.center_jitter_factor[s],
                                   self.scale_jitter_factor[s], rng)
                        for b in data[s + "_anno"]]
            for jb in jittered:
                if math.ceil(math.sqrt(max(jb[2] * jb[3], 0.0))
                             * self.search_area_factor[s]) < 1:
                    data["valid"] = False
                    return data

            crops, boxes = [], []
            for frame, jb, gt in zip(data[s + "_images"], jittered, data[s + "_anno"]):
                crop, rf, _ = sample_target_np(frame, jb, self.search_area_factor[s],
                                               output_sz=self.output_sz[s])
                box = transform_box_to_crop_np(gt, jb, rf, self.output_sz[s],
                                               normalize=True)
                crop = crop.astype(np.float32) / 255.0
                c = crop.shape[-1]  # 3-channel RGB corpora or 6-channel MM
                if self.train_mode:
                    # brightness jitter (ToTensorAndJitter, transforms.py)
                    factor = rng.uniform(max(0.0, 1 - self.brightness_jitter),
                                         1 + self.brightness_jitter)
                    crop = np.clip(crop * factor, 0.0, 1.0)
                    if rng.random() < self.crop_flip_p:
                        crop = np.ascontiguousarray(crop[:, ::-1])
                        box = np.array([1.0 - (box[0] + box[2]), box[1],
                                        box[2], box[3]], np.float32)
                crop = (crop - MEAN_6[:c]) / STD_6[:c]
                crops.append(crop)
                boxes.append(box)
            data[s + "_images"] = np.stack(crops)
            data[s + "_anno"] = np.stack(boxes)

        data["valid"] = True
        return data


class KYSPairProcessing:
    """Serve-geometry crops for KYS's propagation training (MotionTrackerActor,
    keep_track_vot2021/ltr/actors/tracking_motion.py:51-78): the GRU state
    is seeded from the previous search frame's label and the current
    frame's fused response is supervised, so both search frames are cropped
    at ONE box, jittered around the previous frame's target, as the
    tracker crops the current frame where the previous one put the target.
    No flips: one on a single crop would scramble the cost volume between
    the two.

    Takes 1 template and 2 ordered search frames; emits the template and
    search crops in ViPTProcessing's layout plus search_prev_images /
    search_prev_anno. Draws: the template jitter, the previous jitter, then
    one brightness factor per crop (template, previous, current).
    """

    def __init__(self, search_area_factor: float = 5.0, output_sz: int = 288,
                 template_jitter=(0.25, 0.0), prev_jitter=(0.25, 0.05),
                 brightness_jitter: float = 0.2, train_mode: bool = True):
        self.search_area_factor = search_area_factor
        self.output_sz = output_sz
        self.template_jitter = template_jitter
        self.prev_jitter = prev_jitter
        self.brightness_jitter = brightness_jitter
        self.train_mode = train_mode

    def _crop(self, frame, crop_box, gt, rng):
        crop, rf, _ = sample_target_np(frame, crop_box, self.search_area_factor,
                                       output_sz=self.output_sz)
        box = transform_box_to_crop_np(gt, crop_box, rf, self.output_sz, normalize=True)
        crop = crop.astype(np.float32) / 255.0
        if self.train_mode:
            factor = rng.uniform(max(0.0, 1 - self.brightness_jitter),
                                 1 + self.brightness_jitter)
            crop = np.clip(crop * factor, 0.0, 1.0)
        c = crop.shape[-1]
        return (crop - MEAN_6[:c]) / STD_6[:c], box

    def __call__(self, data: dict, rng: np.random.Generator) -> dict:
        t_img = data["template_images"][0]
        t_box = np.asarray(data["template_anno"][0], np.float32)
        p_img, c_img = data["search_images"][0], data["search_images"][1]
        p_box = np.asarray(data["search_anno"][0], np.float32)
        c_box = np.asarray(data["search_anno"][1], np.float32)

        jt = jitter_box(t_box, *self.template_jitter, rng)
        jp = jitter_box(p_box, *self.prev_jitter, rng)
        for jb in (jt, jp):
            if math.ceil(math.sqrt(max(jb[2] * jb[3], 0.0)) * self.search_area_factor) < 1:
                data["valid"] = False
                return data

        crop_t, anno_t = self._crop(t_img, jt, t_box, rng)
        crop_p, anno_p = self._crop(p_img, jp, p_box, rng)
        crop_c, anno_c = self._crop(c_img, jp, c_box, rng)      # the same crop box

        data["template_images"] = np.stack([crop_t])
        data["template_anno"] = np.stack([anno_t])
        data["search_prev_images"] = np.stack([crop_p])
        data["search_prev_anno"] = np.stack([anno_p])
        data["search_images"] = np.stack([crop_c])
        data["search_anno"] = np.stack([anno_c])
        data["valid"] = True
        return data


def from_config(cfg, train_mode: bool = True) -> ViPTProcessing:
    return ViPTProcessing(
        search_area_factor={"template": cfg.DATA.TEMPLATE.FACTOR,
                            "search": cfg.DATA.SEARCH.FACTOR},
        output_sz={"template": cfg.DATA.TEMPLATE.SIZE,
                   "search": cfg.DATA.SEARCH.SIZE},
        center_jitter_factor={"template": cfg.DATA.TEMPLATE.CENTER_JITTER,
                              "search": cfg.DATA.SEARCH.CENTER_JITTER},
        scale_jitter_factor={"template": cfg.DATA.TEMPLATE.SCALE_JITTER,
                             "search": cfg.DATA.SEARCH.SCALE_JITTER},
        train_mode=train_mode,
    )

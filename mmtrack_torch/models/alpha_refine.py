"""Alpha-Refine: box -> refined box + segmentation mask plug-in, port of
mmtrack_tpu/models/alpha_refine.py.

A refinement network crops a 2x search region around a coarse box,
correlates template-conditioned features with the search features
(`ops/xcorr.py::depthwise_xcorr`, the hand-written kernel on CUDA
tensors), and decodes a corner-refined box and an upsampled mask. The
VOT entry runs it under the mask protocol (`eval/vot.py::run_vot_exp`).

The network runs at f32, as in the JAX package. Feature maps are NHWC at
the module boundaries (embed, target_kernel, refine) and NCHW inside the
convolutions. On the card a caller that wants the JAX package's f32
numbers turns TF32 off for cuDNN (`torch.backends.cudnn.allow_tf32`),
as the VOT entry does.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from mmtrack_torch.models.heads import CornerPredictor
from mmtrack_torch.models.layers import Conv2d
from mmtrack_torch.models.resnet import resnet18
from mmtrack_torch.models.vipt import init_weights
from mmtrack_torch.ops.crop import crop_resize_normalized
from mmtrack_torch.ops.prroi import prroi_pool
from mmtrack_torch.ops.xcorr import depthwise_xcorr
from mmtrack_torch.trackers.vipt_tracker import MEAN_6CH, STD_6CH, as_frames

# ImageNet statistics of ARcm_seg.img_preprocess (ARcm_seg.py:24-25, 81)
MEAN_3CH = MEAN_6CH[:3]
STD_3CH = STD_6CH[:3]


class MaskDecoder(nn.Module):
    """(B, 64, h, w) NCHW correlation features -> (B, 8h, 8w) mask logits:
    three (bilinear x2, 3x3 conv, ReLU) stages of 128, 64, 32 channels and
    a 3x3 conv to one channel. `F.interpolate` with align_corners=False is
    jax.image.resize's half-pixel bilinear upsampling (tested)."""

    def __init__(self, in_ch: int = 64, dtype=torch.float32, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device, padding=1)
        for i, ch in enumerate((128, 64, 32)):
            self.add_module(f"up{i}", Conv2d(in_ch, ch, 3, **kw))
            in_ch = ch
        self.out = Conv2d(in_ch, 1, 3, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(3):
            x = F.interpolate(x, scale_factor=2, mode="bilinear", align_corners=False)
            x = torch.relu(getattr(self, f"up{i}")(x))
        return self.out(x)[:, 0]


class AlphaRefineNet(nn.Module):
    """AR_seg_mask analog: template-conditioned refinement.

    embed(im (B, S, S, 3)) -> (B, S/8, S/8, 64) features;
    target_kernel(t_feat, t_box_xywh) -> (B, 3, 3, 64) correlation filters;
    refine(kernel, s_feat) -> (boxes (B, 4) cxcywh in [0, 1], mask logits
    (B, S, S)).
    """

    def __init__(self, input_size: int = 256, dtype=torch.float32, device=None):
        super().__init__()
        self.input_size = input_size
        kw = dict(dtype=dtype, device=device)
        self.backbone = resnet18("layer2", **kw)
        self.adjust = Conv2d(128, 64, 1, **kw)
        self.corner_head = CornerPredictor(64, channel=64, feat_sz=input_size // 8, stride=8,
                                           **kw)
        self.mask_decoder = MaskDecoder(64, **kw)
        self.fuse = Conv2d(128, 64, 3, padding=1, **kw)

    def embed(self, im: torch.Tensor) -> torch.Tensor:
        f = self.backbone(im, ("layer2",))["layer2"]                 # stride 8, 128 ch
        return self.adjust(f.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)

    def target_kernel(self, t_feat: torch.Tensor, t_box_xywh: torch.Tensor) -> torch.Tensor:
        """PrRoI-pool the target region to a 3x3 correlation filter."""
        B = t_feat.shape[0]
        xyxy = torch.cat([t_box_xywh[:, :2], t_box_xywh[:, :2] + t_box_xywh[:, 2:]], dim=1)
        idx = torch.arange(B, dtype=torch.float32, device=t_feat.device)[:, None]
        return prroi_pool(t_feat, torch.cat([idx, xyxy], dim=1), 3, 3, 1 / 8)

    def refine(self, kernel: torch.Tensor, s_feat: torch.Tensor):
        # per-sample 3x3 filters over the search features padded by one
        # (alpha_refine.py:81-83); the kernel pads in place of jnp.pad
        corr = depthwise_xcorr(kernel, s_feat, pad=1)
        x = torch.cat([s_feat, corr], dim=-1).permute(0, 3, 1, 2)
        fused = torch.relu(self.fuse(x)).permute(0, 2, 3, 1)
        xyxy = self.corner_head(fused)
        boxes = torch.stack([(xyxy[:, 0] + xyxy[:, 2]) / 2, (xyxy[:, 1] + xyxy[:, 3]) / 2,
                             xyxy[:, 2] - xyxy[:, 0], xyxy[:, 3] - xyxy[:, 1]], dim=1)
        mask = self.mask_decoder(fused.permute(0, 3, 1, 2))
        return boxes, mask

    def forward(self, template, t_box_xywh, search):
        k = self.target_kernel(self.embed(template), t_box_xywh)
        return self.refine(k, self.embed(search))


def build_alpha_refine(input_size: int = 256, seed: Optional[int] = None,
                       state_dict: Optional[dict] = None) -> AlphaRefineNet:
    """AlphaRefineNet at f32 on the CPU with seeded random weights
    (`init_weights`: LeCun-normal kernels, zero biases, identity batch
    norm) or the given state_dict
    (`models/convert.py::alpha_refine_state_dict_from_flax`)."""
    model = AlphaRefineNet(input_size)
    if state_dict is not None:
        model.load_state_dict(state_dict)
    elif seed is not None:
        init_weights(model, seed)
    return model.eval()


@dataclass(frozen=True)
class ARRuntime:
    search_factor: float = 2.0
    input_size: int = 256
    mask_threshold: float = 0.5


class ARcmSeg:
    """Plug-in with the reference API (ARcm_seg.initialize / get_mask,
    ARcm_seg.py:19-93): attach to any tracker to turn its boxes into masks
    and refined boxes. `model` must hold its weights; it is moved to
    `device`.

    Frames are uint8 (H, W, 3). The JAX plug-in takes the frame cast to
    f32 (eval/vot.py:263, :282), then crops and normalises it
    (crop_resize + `_normalize`, alpha_refine.py:121-131): that is exactly
    `crop_resize_normalized` with the 3-channel ImageNet statistics, and
    since the f32 frame holds the same integers, the crop kernel on the
    uint8 frame gives the same values.
    """

    def __init__(self, model: AlphaRefineNet, device, runtime: Optional[ARRuntime] = None):
        self.device = torch.device(device)
        self.model = model.to(self.device).eval()
        self.rt = runtime or ARRuntime()
        self.kernel = None
        self.mean = torch.from_numpy(MEAN_3CH).to(self.device)
        self.std = torch.from_numpy(STD_3CH).to(self.device)

    def _crop_embed(self, frame: np.ndarray, box: torch.Tensor):
        crop, rf = crop_resize_normalized(as_frames(frame[None], self.device),
                                          box.to(self.device), self.rt.search_factor,
                                          self.rt.input_size, self.mean, self.std)
        return self.model.embed(crop), rf

    @torch.inference_mode()
    def initialize(self, frame: np.ndarray, box_xywh) -> None:
        box = torch.tensor(np.asarray(box_xywh, np.float32)[None])
        t_feat, rf = self._crop_embed(frame, box)
        # target box in crop coordinates
        S = self.rt.input_size
        box = box.to(self.device)
        cw = box[:, 2] * rf
        ch = box[:, 3] * rf
        t_box = torch.stack([(S - 1) / 2 - cw / 2, (S - 1) / 2 - ch / 2, cw, ch], dim=1)
        self.kernel = self.model.target_kernel(t_feat, t_box)

    @torch.inference_mode()
    def refine(self, frame: np.ndarray, box_xywh):
        """-> (refined box xywh in image coordinates, mask (H, W) f32 in
        [0, 1] pasted back into the full frame)."""
        box = np.asarray(box_xywh, np.float32)
        s_feat, rf_t = self._crop_embed(frame, torch.from_numpy(box[None]))
        boxes, mask = self.model.refine(self.kernel, s_feat)
        pred, mask_crop, rf = boxes[0], mask[0], rf_t[0]

        # host numpy/cv2, line for line as alpha_refine.py:161-185
        S = self.rt.input_size
        pred_img = pred.cpu().numpy() * S / float(rf)
        cx_prev = float(box[0] + box[2] / np.float32(2))
        cy_prev = float(box[1] + box[3] / np.float32(2))
        half = 0.5 * S / float(rf)
        cx = pred_img[0] + cx_prev - half
        cy = pred_img[1] + cy_prev - half
        refined = [cx - pred_img[2] / 2, cy - pred_img[3] / 2,
                   pred_img[2], pred_img[3]]

        # paste the crop mask back into frame coordinates
        import cv2
        H, W = frame.shape[0], frame.shape[1]
        prob = torch.sigmoid(mask_crop).cpu().numpy().astype(np.float32)
        crop_sz = S / float(rf)
        x1 = int(round(cx_prev - crop_sz / 2))
        y1 = int(round(cy_prev - crop_sz / 2))
        full = np.zeros((H, W), np.float32)
        resized = cv2.resize(prob, (max(int(round(crop_sz)), 1),) * 2)
        xs, ys = max(0, x1), max(0, y1)
        xe = min(W, x1 + resized.shape[1])
        ye = min(H, y1 + resized.shape[0])
        if xe > xs and ye > ys:
            full[ys:ye, xs:xe] = resized[ys - y1:ye - y1, xs - x1:xe - x1]
        return refined, full

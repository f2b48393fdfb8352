"""The analytic FLOP counts against torch's FlopCounterMode over the
program's model on the meta device (B=1), and each kernel's operations
and bytes on small shapes by hand."""

import json
import math
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmarks import flops, roofline
from benchmarks.reference import vipt as ref

ROOT = Path(__file__).resolve().parents[2]
CONFIGS = ["vipt_deep_rgbd", "ostrack_vitb_384_ce"]


def _cfg(name):
    return json.loads((ROOT / "benchmarks/configs" / f"{name}.json").read_text())


def _meta_model(cfg):
    from mmtrack_torch.models.vipt import ViPTrack, drop_prompt_embed

    m = cfg["model"]
    model = ViPTrack(embed_dim=m["embed_dim"], depth=m["depth"], num_heads=m["num_heads"],
                     template_size=cfg["template"]["size"], search_size=cfg["search"]["size"],
                     patch_size=m["patch_size"], ce_loc=tuple(cfg["ce"]["loc"]),
                     prompt_type=m["prompt_type"], head_channel=m["head_channel"],
                     device="meta", drop_path_rate=0.1)
    if m["prompt_type"] == "none":
        drop_prompt_embed(model)
    return model


def _inputs(cfg):
    from mmtrack_torch.models.vipt import generate_ctr_mask

    meta, c = torch.device("meta"), cfg["model"]["channels"]
    Tz, Tx = cfg["template"]["size"], cfg["search"]["size"]
    g = ref.geometry(cfg)
    mask = generate_ctr_mask(g["feat_z"], "CTR_POINT", device=meta)
    return (torch.zeros(1, Tz, Tz, c, device=meta), torch.zeros(1, Tx, Tx, c, device=meta),
            mask, tuple(g["kept"]))


@pytest.mark.parametrize("name", CONFIGS)
def test_forward_flops_equal_flop_counter(name):
    from torch.utils.flop_counter import FlopCounterMode

    cfg = _cfg(name)
    model = _meta_model(cfg)
    z, x, mask, keep = _inputs(cfg)
    with FlopCounterMode(display=False) as counter:
        model(z, x, mask, keep)
    assert flops.forward_flops(cfg) == counter.get_total_flops()


def test_train_flops_equal_flop_counter():
    from torch.utils.flop_counter import FlopCounterMode

    from mmtrack_torch.train.actor import vipt_forward_and_loss
    from mmtrack_torch.train.optim import build_optimizer, prompt_only_mask

    cfg = _cfg("vipt_deep_rgbd")
    model = _meta_model(cfg)
    z, x, mask, keep = _inputs(cfg)
    build_optimizer(model, lr=1e-4, trainable_mask=prompt_only_mask(model))
    batch = {"template": z, "search": x, "search_anno": torch.full((1, 4), 0.3, device="meta")}
    with FlopCounterMode(display=False) as counter:
        loss, _ = vipt_forward_and_loss(model, batch, box_mask_z=mask, ce_keep_lens=keep)
        loss.backward()
    assert flops.train_flops(cfg) == counter.get_total_flops()


def test_block_tokens():
    tokens = flops.block_tokens(_cfg("vipt_deep_rgbd"))
    assert [a for a, _, _ in tokens] == [320] * 4 + [244] * 3 + [190] * 3 + [153] * 2
    assert [i for i, (_, _, ce) in enumerate(tokens) if ce] == [3, 6, 9]
    tokens = flops.block_tokens(_cfg("ostrack_vitb_384_ce"))
    assert sorted({a for a, _, _ in tokens}, reverse=True) == [720, 548, 427, 343]
    assert [lm for _, lm, ce in tokens if ce] == [548, 427, 343]


def test_gemm_and_attention_counts():
    assert roofline.gemm(2, 3, 4, roofline.EPI_BIAS) == (48.0, (8 + 12 + 6) * 2 + 12)
    assert roofline.gemm(2, 3, 4, roofline.EPI_RESIDUAL) == (48.0, (8 + 12 + 6 + 6) * 2 + 12)
    # B=2, L=3, C=4: q k^T and p v, 2 L^2 C each; qkv (B, L, 3C) in, (B, L, C) out, bf16
    assert roofline.attention(2, 3, 4) == (2 * 2 * (2 * 9 * 4), (2 * 3 * 12 + 2 * 3 * 4) * 2)


def test_crop_bytes_count_the_taps_read():
    H, W, C, S, factor = 30, 40, 3, 8, 2.0
    boxes = np.array([[10.0, 5.0, 6.0, 4.0], [-3.0, 20.0, 12.0, 15.0], [35.0, 25.0, 9.0, 9.0]],
                     np.float32)
    frames = torch.zeros((3, H, W, C), dtype=torch.uint8)
    expect = 3 * S * S * C * 4
    for b in range(3):
        # every source pixel whose value reaches the reference crop
        touched = np.zeros((H, W), bool)
        for y in range(H):
            for x in range(W):
                f = frames[b:b + 1].clone()
                f[0, y, x] = 255
                out, _ = ref.crop(f, torch.tensor(boxes[b:b + 1]), factor, S,
                                  torch.zeros(C), torch.ones(C))
                touched[y, x] = bool(out.abs().sum() > 0)
        rows, cols = touched.any(1).sum(), touched.any(0).sum()
        expect += rows * cols * C
    assert roofline.crop_bytes(boxes, H, W, C, S, factor) == expect


def test_share_and_peaks():
    pk = roofline.peaks("NVIDIA H100 80GB HBM3")
    ops, nbytes = 989.4e12, 3.35e12          # one second each at the peaks
    assert math.isclose(roofline.share([(ops, nbytes)], 2.0, pk), 50.0)
    assert roofline.share([], 1.0, pk) is None

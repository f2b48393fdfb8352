"""The frozen reference against the program's float32 plain path on the
CPU at a tiny width: the model's maps for ViPT's deep prompts and for the
prompt-free OSTrack form, with the benchmark's weights loaded by name into
the program and handed to the reference unchanged."""

import json
from pathlib import Path

import pytest
import torch

from benchmarks import system, weights
from benchmarks.reference import vipt as ref

ROOT = Path(__file__).resolve().parents[2]


def _tiny(name):
    cfg = json.loads((ROOT / "benchmarks/configs" / f"{name}.json").read_text())
    cfg["model"].update(embed_dim=64, depth=4, num_heads=1, head_channel=16)
    cfg["template"]["size"], cfg["search"]["size"] = 32, 64
    cfg["ce"].update(loc=[1, 2], keep_ratio=[0.7, 0.7])
    cfg["dtype"] = {"inference": "float32"}
    return cfg


@pytest.mark.parametrize("name", ["vipt_deep_rgbd", "ostrack_vitb_384_ce"])
def test_forward_matches_the_program_in_float32(name):
    from mmtrack_torch.models.vipt import generate_ctr_mask

    cfg = _tiny(name)
    dev = torch.device("cpu")
    params = weights.make(cfg, 2 ** 31 + 3, dev)
    net = system.model(cfg, dev)
    system.load(net, params)
    c = cfg["model"]["channels"]
    g = torch.Generator().manual_seed(0)
    z = torch.randn(3, 32, 32, c, generator=g)
    x = torch.randn(3, 64, 64, c, generator=g)
    geo = ref.geometry(cfg)
    with torch.no_grad():
        out = net(z, x, generate_ctr_mask(geo["feat_z"], "CTR_POINT"), tuple(geo["kept"]))
        want = ref.forward(params, cfg, z, x)
    for key in ("score_map", "size_map", "offset_map", "pred_boxes"):
        torch.testing.assert_close(out[key], want[key], rtol=1e-5, atol=1e-5)


def test_ce_vote_keeps_the_levels():
    """With the decisive vote the reference's eliminations keep exactly
    the highest levels, whatever the frame."""
    cfg = _tiny("vipt_deep_rgbd")
    dev = torch.device("cpu")
    params = weights.make(cfg, 9, dev)
    kept = []
    orig = ref.candidate_elimination

    def spy(*a):
        out = orig(*a)
        kept.append(out[1])
        return out

    g = torch.Generator().manual_seed(1)
    z = torch.randn(2, 32, 32, 6, generator=g)
    x = torch.randn(2, 64, 64, 6, generator=g)
    try:
        ref.candidate_elimination = spy
        with torch.no_grad():
            ref.forward(params, cfg, z, x)
    finally:
        ref.candidate_elimination = orig
    assert [k.shape[1] for k in kept] == ref.geometry(cfg)["kept"]
    for k in kept:
        assert torch.equal(k[0].sort().values, k[1].sort().values)

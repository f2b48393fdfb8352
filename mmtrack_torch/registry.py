"""Tracker recipes the port can build: one name -> (build, modality, family,
composition), port of mmtrack_tpu/registry.py (:19-141, :160-235,
:302-373, :376-456): the ViPT family, plain OSTrack, OSTrack-online,
STARK-S, STARK-ST, SPT, SiamFC, MixFormer_RGBD, SAMF, ProMixTrack, the
DiMP family (DiMP-50, the five DeT_DiMP50 merges, mfDiMP, PrDiMP-50),
KeepTrack and KYS, ATOM with DeT's three RGB-D ATOMs, the DCF family
(ECO, C-COT, MOSSE, SCSRDCF), the MDNet family (MDNet, pyMDNet, pyVITAL, MANet and the
RGB-T chassis APFNet, DAFNet, MaCNet; registry.py:239-299) and the mask
trackers LWL and STM (registry.py:144-156, 201-213): all 42 of the JAX
recipes, with their names, modalities, families, compositions and runtimes.

`build(seed, params, device)` returns a tracker with the reference
BaseTracker API (initialize / track). Weights are seeded random unless
`params` gives a state_dict (for instance one of `models/convert.py`'s
`*_state_dict_from_flax` of a JAX tree; OSTrack-online's holds the score
head under the reference's `cls_head.` prefix). Models are f32, as the JAX
registry builds them. Entry points run on the card unless the caller asks
for the CPU.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

from mmtrack_torch.config import vipt_experiment_config


@dataclass
class TrackerRecipe:
    build: Callable      # (seed, params, device) -> tracker object
    modality: str        # rgbd | rgbt | rgbe | rgb | any
    family: str
    # frame composition the recipe expects (data/composition.py X_DTYPES)
    composition: str = "rgbcolormap"


def _vipt(config_name: str) -> Callable:
    def build(seed: int = 0, params: Optional[dict] = None, device="cuda"):
        from mmtrack_torch.models.vipt import build_viptrack
        from mmtrack_torch.trackers.vipt_tracker import ViPTRuntime, ViPTTracker
        cfg = vipt_experiment_config(config_name)
        model = build_viptrack(cfg, seed=None if params is not None else seed)
        if params is not None:
            model.load_state_dict(params)
        return ViPTTracker(model, device, ViPTRuntime.from_config(cfg))
    return build


def _load_ostrack(model, params: dict):
    """Load an OSTrack state_dict; one without patch_embed_prompt (a
    3-channel tree) drops that module, so the model takes 3-channel crops
    only, as the JAX recipe's params do."""
    from mmtrack_torch.models.vipt import drop_prompt_embed

    if not any(k.startswith("backbone.patch_embed_prompt.") for k in params):
        drop_prompt_embed(model)
    model.load_state_dict(params)
    return model


def _ostrack() -> Callable:
    """Plain OSTrack at 128/256 (registry.py:46-58) over ViPTTracker. Seeded
    weights include patch_embed_prompt, so the default rgbcolormap frames
    add the depth triplet's patch embedding (JAX ViTCEPrompt, vipt.py:152-160)."""
    def build(seed: int = 0, params: Optional[dict] = None, device="cuda"):
        from mmtrack_torch.models.vipt import build_ostrack
        from mmtrack_torch.trackers.vipt_tracker import ViPTRuntime, ViPTTracker
        model = build_ostrack(template_size=128, search_size=256,
                              seed=None if params is not None else seed)
        if params is not None:
            _load_ostrack(model, params)
        return ViPTTracker(model, device, ViPTRuntime())
    return build


def _ostrack_online() -> Callable:
    """OSTrack-online at the published online entry: search 320, the t2m12
    score head (registry.py:334-356); seeds `seed` and `seed + 1`."""
    def build(seed: int = 0, params: Optional[dict] = None, device="cuda"):
        from mmtrack_torch.models.vipt import ScoreTransformer, build_ostrack, init_weights
        from mmtrack_torch.trackers.ostrack_online import (
            OSTrackOnlineRuntime,
            OSTrackOnlineTracker,
        )
        rt = OSTrackOnlineRuntime()
        model = build_ostrack(template_size=128, search_size=320,
                              seed=None if params is not None else seed)
        cls = ScoreTransformer(d_model=768, n_layers=rt.cls_attn_layers,
                               n_mlp_layers=rt.cls_mlp_layers)
        if params is None:
            init_weights(cls, seed + 1)
        else:
            pre = "cls_head."
            _load_ostrack(model, {k: v for k, v in params.items() if not k.startswith(pre)})
            cls.load_state_dict({k[len(pre):]: v for k, v in params.items() if k.startswith(pre)})
        return OSTrackOnlineTracker(model, cls, device, rt)
    return build


def _stark(six_channel: bool, dynamic: bool) -> Callable:
    """STARK-S / STARK-ST / SPT at 128/320 (registry.py:302-314)."""
    def build(seed: int = 0, params: Optional[dict] = None, device="cuda"):
        from mmtrack_torch.models.stark import STARK
        from mmtrack_torch.models.vipt import init_weights
        from mmtrack_torch.trackers.stark_tracker import STARKRuntime, STARKTracker
        model = STARK(six_channel=six_channel, score_head=dynamic)
        if params is None:
            init_weights(model, seed)
        else:
            model.load_state_dict(params)
        return STARKTracker(model, device, STARKRuntime(dynamic_template=dynamic))
    return build


def _siamfc() -> Callable:
    """SiamFC on 6-channel 127/255 crops (registry.py:226-235)."""
    def build(seed: int = 0, params: Optional[dict] = None, device="cuda"):
        from mmtrack_torch.models.siamfc import SiamFC
        from mmtrack_torch.models.vipt import init_weights
        from mmtrack_torch.trackers.siamfc_tracker import SiamFCRuntime, SiamFCTracker
        model = SiamFC()
        if params is None:
            init_weights(model, seed)
        else:
            model.load_state_dict(params)
        return SiamFCTracker(model, device, SiamFCRuntime())
    return build


def _mixformer(in_channels: int = 6, scales: tuple = (1.0,),
               re_constrain: str = "simple") -> Callable:
    """MixFormer-L at the reference's scale (CvT 192/768/1024, depths
    2/2/12), three online templates (TEST.ONLINE_SIZES.VOT2022RGBD):
    MixFormer_RGBD and SAMF on 6 channels (registry.py:316-331), ProMixTrack
    on 3 without re-constraint (registry.py:360-373)."""
    def build(seed: int = 0, params: Optional[dict] = None, device="cuda"):
        from mmtrack_torch.models.mixformer import build_mixformer_rgbd
        from mmtrack_torch.models.vipt import init_weights
        from mmtrack_torch.trackers.mixformer_tracker import MixFormerRuntime, MixFormerTracker
        model = build_mixformer_rgbd(in_channels=in_channels)
        if params is None:
            init_weights(model, seed)
        else:
            model.load_state_dict(params)
        return MixFormerTracker(model, device, MixFormerRuntime(
            scale_factors=scales, online_size=3, re_constrain=re_constrain))
    return build


def _dimp(merge_type: Optional[str], prdimp: bool = False) -> Callable:
    """DiMP-50 (merge None), DeT's dual-backbone DiMP-50 (registry.py:61-74)
    with DeT_DiMP50_Max's runtime, or PrDiMP-50 with its own (:77-90). The
    tracker's random draws are seeded with `seed` too."""
    def build(seed: int = 0, params: Optional[dict] = None, device="cuda"):
        from mmtrack_torch.models.dimp import DiMPNet, build_prdimp50, init_dimp_weights
        from mmtrack_torch.trackers.dimp_tracker import (
            DiMPRuntime,
            DiMPTracker,
            prdimp50_runtime,
        )
        model = build_prdimp50() if prdimp else DiMPNet(merge_type=merge_type)
        if params is None:
            init_dimp_weights(model, seed)
        else:
            model.load_state_dict(params)
        rt = prdimp50_runtime() if prdimp else DiMPRuntime()
        return DiMPTracker(model, device, rt, seed=seed)
    return build


def _keeptrack() -> Callable:
    """KeepTrack over super_dimp_hinge (registry.py:108-122): DiMP-50 with
    the hinge optimiser and the learned peak matcher, KeepTrack's release
    runtime. A state_dict's `descriptor_extractor.` / `matcher.` keys are
    the matcher's; without them the matcher is seeded from `seed + 1`."""
    def build(seed: int = 0, params: Optional[dict] = None, device="cuda"):
        from mmtrack_torch.models.dimp import build_super_dimp50, init_dimp_weights
        from mmtrack_torch.models.peak_matching import PeakMatchingNetwork
        from mmtrack_torch.trackers.keeptrack_tracker import KeepTrackRuntime, KeepTrackTracker
        rt = KeepTrackRuntime()
        model, matcher = build_super_dimp50(), None
        if params is None:
            init_dimp_weights(model, seed)
        else:
            own = ("descriptor_extractor.", "matcher.")
            model.load_state_dict({k: v for k, v in params.items() if not k.startswith(own)})
            if any(k.startswith(own) for k in params):
                matcher = PeakMatchingNetwork(rt.descriptor_dim, rt.desc_feat_dim)
                matcher.load_state_dict({k: v for k, v in params.items() if k.startswith(own)})
        return KeepTrackTracker(model, device, rt, seed=seed, matcher=matcher)
    return build


def _kys() -> Callable:
    """KYS: DiMP-50 and the scene-propagation predictor (registry.py:
    125-141) with the KYS runtime."""
    def build(seed: int = 0, params: Optional[dict] = None, device="cuda"):
        from mmtrack_torch.models.dimp import init_dimp_weights
        from mmtrack_torch.models.kys import build_kysnet
        from mmtrack_torch.trackers.kys_tracker import KYSRuntime, KYSTracker
        model = build_kysnet()
        if params is None:
            init_dimp_weights(model, seed)
        else:
            model.load_state_dict(params)
        return KYSTracker(model, device, KYSRuntime(), seed=seed)
    return build


def _atom(merge_type: Optional[str]) -> Callable:
    """ATOM (merge None) and DeT's RGB-D ATOMs (registry.py:92-105) with
    ATOM's default runtime; the tracker's random draws are seeded with
    `seed` too."""
    def build(seed: int = 0, params: Optional[dict] = None, device="cuda"):
        from mmtrack_torch.models.atom import ATOMNet
        from mmtrack_torch.models.vipt import init_weights
        from mmtrack_torch.trackers.atom_tracker import ATOMRuntime, ATOMTracker
        model = ATOMNet(merge_type=merge_type)
        if params is None:
            init_weights(model, seed)
        else:
            model.load_state_dict(params)
        return ATOMTracker(model, device, ATOMRuntime(), seed=seed)
    return build


def _eco(ccot: bool = False) -> Callable:
    """ECO and C-COT over ResNet-18 with the VGG-M conv1 tap
    (registry.py:160-189)."""
    def build(seed: int = 0, params: Optional[dict] = None, device="cuda"):
        from mmtrack_torch.models.backbones import resnet18_vggmconv1
        from mmtrack_torch.models.vipt import init_weights
        from mmtrack_torch.trackers.ccot_tracker import CCOTTracker
        from mmtrack_torch.trackers.eco_tracker import ECORuntime, ECOTracker
        model = resnet18_vggmconv1()
        if params is None:
            init_weights(model, seed)
        else:
            model.load_state_dict(params)
        if ccot:
            return CCOTTracker(model, device, seed=seed)
        return ECOTracker(model, device, ECORuntime(), seed=seed)
    return build


def _mdnet_model(build_model: Callable, seed: int, params: Optional[dict]):
    from mmtrack_torch.models.vipt import init_weights

    model = build_model()
    if params is None:
        init_weights(model, seed)
    else:
        model.load_state_dict(params)
    return model


def _mdnet(mode: str, vital: bool = False, manet: bool = False) -> Callable:
    """MDNet (single), pyMDNet (dual, fc6 on the concatenation), pyVITAL
    (dual, fc6 on the sum, G's adversarial masks) and MANet (adapter) with
    their published runtimes (registry.py:239-273). The tracker's random
    draws are seeded with `seed` too."""
    def build(seed: int = 0, params: Optional[dict] = None, device="cuda"):
        from mmtrack_torch.models.mdnet import MDNet
        from mmtrack_torch.trackers.mdnet_tracker import MDNetRuntime, MDNetTracker
        model = _mdnet_model(lambda: MDNet(mode=mode, fc6_merge="sum" if vital else "concat"),
                             seed, params)
        if manet:
            # MANet's tracking/options.py + run_tracker.py
            rt = MDNetRuntime(
                n_samples=512, lr_init=1e-4, init_iters=30, lr_update=2e-4,
                n_frames_short=20, long_interval=10,
                scale_pos=1.2, trans_neg=1.5, scale_neg=1.2,
                trans_neg_init=1.0, scale_neg_init=2.0, scale_bbreg=1.5,
                loss_sum=True, manet_seed_memory=True, bbreg_reject=True,
                revert_on_failure=True, hard_trans_expand=True)
        elif vital:
            # pyVITAL's tracking/options.yaml: focal BCE, its learning rates
            rt = MDNetRuntime(vital=True, loss_focal=True, lr_init=5e-3, lr_update=5e-4,
                              lr_g=2e-4)
        else:
            rt = MDNetRuntime()
        return MDNetTracker(model, device, rt, seed=seed)
    return build


def _rgbt_chassis(kind: str) -> Callable:
    """APFNet, DAFNet and MaCNet over the MDNet protocol at its default
    runtime (registry.py:276-299)."""
    def build(seed: int = 0, params: Optional[dict] = None, device="cuda"):
        from mmtrack_torch.models.apfnet import APFNet
        from mmtrack_torch.models.rgbt_fusion import DAFNet, MaCNet
        from mmtrack_torch.trackers.mdnet_tracker import MDNetRuntime, MDNetTracker
        cls = {"apfnet": APFNet, "dafnet": DAFNet, "macnet": MaCNet}[kind]
        return MDNetTracker(_mdnet_model(cls, seed, params), device, MDNetRuntime(), seed=seed)
    return build


def _lwl() -> Callable:
    """LWL at the published configuration (build_lwl_paper: 16 filters of
    size 3) with LWL's runtime (registry.py:144-156)."""
    def build(seed: int = 0, params: Optional[dict] = None, device="cuda"):
        from mmtrack_torch.models.lwl import build_lwl_paper, init_lwl_weights
        from mmtrack_torch.trackers.lwl_tracker import LWLRuntime, LWLTracker
        model = build_lwl_paper()
        if params is None:
            init_lwl_weights(model, seed)
        else:
            model.load_state_dict(params)
        return LWLTracker(model, device, LWLRuntime())
    return build


def _stm() -> Callable:
    """STM with its runtime (registry.py:201-213)."""
    def build(seed: int = 0, params: Optional[dict] = None, device="cuda"):
        from mmtrack_torch.models.stm import build_stm
        from mmtrack_torch.models.vipt import init_weights
        from mmtrack_torch.trackers.stm_tracker import STMRuntime, STMTracker
        model = build_stm()
        if params is None:
            init_weights(model, seed)
        else:
            model.load_state_dict(params)
        return STMTracker(model, device, STMRuntime())
    return build


# recipes without learned weights: no checkpoint applies
WEIGHTLESS = ("mosse", "scsrdcf")


def _no_weights(kind: str) -> Callable:
    """MOSSE and SCSRDCF (registry.py:192-223): closed-form filters without
    learned weights; a checkpoint is refused."""
    def build(seed: int = 0, params: Optional[dict] = None, device="cuda"):
        from mmtrack_torch.trackers.mosse_tracker import MOSSETracker
        from mmtrack_torch.trackers.scsrdcf_tracker import SCSRDCFTracker
        if params is not None:
            raise ValueError(f"{kind} has no learned weights; it takes no checkpoint")
        return MOSSETracker(device) if kind == "mosse" else SCSRDCFTracker(device)
    return build


TRACKER_REGISTRY: dict[str, TrackerRecipe] = {
    **{f"vipt_{kind}_{modality}": TrackerRecipe(_vipt(f"{kind}_{modality}"), modality, "vipt")
       for kind in ("deep", "shaw") for modality in ("rgbd", "rgbt", "rgbe")},
    "ostrack": TrackerRecipe(_ostrack(), "rgb", "ostrack"),
    "ostrack_online": TrackerRecipe(_ostrack_online(), "rgbd", "ostrack", composition="color"),
    "siamfc": TrackerRecipe(_siamfc(), "rgbe", "siamfc"),
    "stark_s": TrackerRecipe(_stark(False, False), "rgb", "stark"),
    "stark_st": TrackerRecipe(_stark(False, True), "rgb", "stark"),
    "spt": TrackerRecipe(_stark(True, False), "rgbd", "stark"),
    "mixformer_rgbd": TrackerRecipe(_mixformer(), "rgbd", "mixformer"),
    # SAMF: the scale-adaptive MixFormer
    "samf": TrackerRecipe(_mixformer(scales=(0.8, 1.0, 1.25)), "rgbd", "mixformer"),
    # ProMixTrack: the RGB MixFormer-L on a 5% JET-depth alpha blend
    "promixtrack": TrackerRecipe(_mixformer(in_channels=3, re_constrain="none"), "rgbd",
                                 "mixformer", composition="rgbd_blend"),
    "dimp50": TrackerRecipe(_dimp(None), "rgb", "dimp"),
    **{f"det_dimp50_{name}": TrackerRecipe(_dimp(merge), "rgbd", "dimp")
       for name, merge in (("max", "max"), ("mean", "mean"), ("mul", "mul"),
                           ("weightedsum", "weightedSum"), ("mc", "conv"))},
    # mfDiMP: the RGB-T fusion DiMP, DeT's mean merge on rgbrgb frames
    "mfdimp": TrackerRecipe(_dimp("mean"), "rgbt", "dimp", composition="rgbrgb"),
    "prdimp50": TrackerRecipe(_dimp(None, prdimp=True), "rgb", "dimp"),
    # KeepTrack and KYS on the DiMP base (the keep_track fork)
    "keep_track": TrackerRecipe(_keeptrack(), "rgb", "dimp"),
    "kys": TrackerRecipe(_kys(), "rgb", "dimp"),
    # ATOM and DeT's RGB-D ATOMs
    "atom": TrackerRecipe(_atom(None), "rgb", "dimp"),
    **{f"det_atom_{name}": TrackerRecipe(_atom(merge), "rgbd", "dimp")
       for name, merge in (("max", "max"), ("mean", "mean"), ("mc", "conv"))},
    # the DCF family on colour frames
    "eco": TrackerRecipe(_eco(), "rgb", "eco", composition="color"),
    "ccot": TrackerRecipe(_eco(ccot=True), "rgb", "eco", composition="color"),
    "mosse": TrackerRecipe(_no_weights("mosse"), "rgb", "eco", composition="color"),
    "scsrdcf": TrackerRecipe(_no_weights("scsrdcf"), "rgb", "eco", composition="color"),
    # the MDNet family: candidate scoring with online fc fine-tuning
    "mdnet": TrackerRecipe(_mdnet("single"), "rgb", "mdnet"),
    "pymdnet": TrackerRecipe(_mdnet("dual"), "rgbe", "mdnet"),
    "pyvital": TrackerRecipe(_mdnet("dual", vital=True), "rgbe", "mdnet"),
    "manet": TrackerRecipe(_mdnet("adapter", manet=True), "rgbe", "mdnet"),
    "apfnet": TrackerRecipe(_rgbt_chassis("apfnet"), "rgbt", "mdnet"),
    "dafnet": TrackerRecipe(_rgbt_chassis("dafnet"), "rgbt", "mdnet"),
    "macnet": TrackerRecipe(_rgbt_chassis("macnet"), "rgbt", "mdnet"),
    # the mask trackers: few-shot segmentation and space-time memory
    "lwl": TrackerRecipe(_lwl(), "rgb", "lwl"),
    "stm": TrackerRecipe(_stm(), "rgb", "lwl"),
}


def build_tracker(name: str, seed: int = 0, params: Optional[dict] = None, device="cuda"):
    if name not in TRACKER_REGISTRY:
        raise KeyError(f"unknown tracker '{name}'; options: {sorted(TRACKER_REGISTRY)}")
    return TRACKER_REGISTRY[name].build(seed=seed, params=params, device=device)


def list_trackers(modality: str | None = None) -> list[str]:
    """Recipe names, all or those of `modality` plus the modality-free
    ('any') ones, as the JAX registry lists them."""
    return sorted(n for n, r in TRACKER_REGISTRY.items()
                  if modality is None or r.modality in (modality, "any"))

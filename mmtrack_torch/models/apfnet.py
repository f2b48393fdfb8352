"""APFNet, the attribute-based progressive fusion RGB-T tracker, port of
mmtrack_tpu/models/apfnet.py in its tracking topology (model_tracking.py,
`active_attribute=None`): two VGG-M streams; at each stage five
challenge-attribute branches (FM, OCC, SC, TC, ILL) fuse the two streams'
stage inputs by a 2-way selective-kernel gate, a 5-way SK gate ensembles
them, and channel-attention transformers encode each stream and the
aggregate and inject the aggregate into both streams; MDNet's fc4 / fc5 /
fc6 score the concatenated conv3 streams (fc4 9216 -> 512).

NCHW throughout; the conv3 flatten is CHW, as the reference's
cat((x1, x2), 1).view(B, -1) is. Parameter names are the reference's,
which mmtrack_tpu/models/convert.py::convert_apfnet_checkpoint reads:
`layers_{v,i}.conv{i}.0`, `parallel{s}.{a}.parallel{s}_conv{c}.0`,
`parallel{s}_skconv.{a}.parallel{s}_skconv_fc{f}.0`,
`ensemble{s}_skconv.ensemble{s}_skconv_fc{f}.0`,
`transformer{s}_{encoder1..3,decoder1..2}.transformer{s}_<role>_{WK,WV,
fc_reduce,fc_rise}.0`, `fc.fc4.0`, `fc.fc5.1`, `branches.{k}.1`.
`stage_mask` selects the parameters each of the three training stages
trains. `active_attribute` selects the JAX model's stage-1 topology (one
attribute branch, additive fusion, no transformers), which no script of
tools/train.py reaches: `make_mdnet_train_step` trains every stage in the
tracking topology, as JAX's does.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from mmtrack_torch.models.mdnet import MDNetHead, SharedConvs, _seq, dropout

ATTRIBUTES = ("FM", "OCC", "SC", "TC", "ILL")
STAGE_CH = (96, 256, 512)      # per stage: branch output channels,
SK_MID = (32, 32, 64)          # the 2-way SK bottleneck,
ATTN_RED = (32, 64, 128)       # the attention's reduced channels
ROLES = ("encoder1", "encoder2", "encoder3", "decoder1", "decoder2")  # vis, inf, agg; vis, inf


def _conv(cin, cout, k, stride=1, bias=True):
    return _seq(0, nn.Conv2d(cin, cout, k, stride=stride, bias=bias))


def sk_gates(u, fc1, fc2, n: int, C: int):
    """Selective-kernel gates: global average pool -> bottleneck -> n * C
    logits -> softmax over the n inputs; (B, n, C)."""
    g = fc2(F.relu(fc1(u.mean((2, 3), keepdim=True))))
    return torch.softmax(g.reshape(g.shape[0], n, C), 1)


class AttrPath(nn.Module):
    """One attribute branch's conv path at one stage (parallel{s}[a])."""

    def __init__(self, stage: int):
        super().__init__()
        s, self.stage = stage + 1, stage
        if stage == 0:      # conv(3->32, 5, s2) + relu, conv(32->96, 4, s2)
            setattr(self, f"parallel{s}_conv1", _conv(3, 32, 5, 2))
            setattr(self, f"parallel{s}_conv2", _conv(32, 96, 4, 2))
        elif stage == 1:    # conv(96->256, 3, s2) + maxpool(8, s1)
            setattr(self, f"parallel{s}_conv1", _conv(96, 256, 3, 2))
        else:               # conv(256->512, 1) + maxpool(3, s1)
            setattr(self, f"parallel{s}_conv1", _conv(256, 512, 1))

    def forward(self, x):
        s = self.stage + 1
        c1 = getattr(self, f"parallel{s}_conv1")[0]
        if self.stage == 0:
            return getattr(self, f"parallel{s}_conv2")[0](F.relu(c1(x)))
        return F.max_pool2d(c1(x), 8 if self.stage == 1 else 3, 1)


class SKPair(nn.Module):
    """A 2-way SK gate (parallel{s}_skconv[a])."""

    def __init__(self, stage: int):
        super().__init__()
        s, C, mid = stage + 1, STAGE_CH[stage], SK_MID[stage]
        self.s, self.C = s, C
        setattr(self, f"parallel{s}_skconv_fc1", _conv(C, mid, 1, bias=False))
        setattr(self, f"parallel{s}_skconv_fc2", _conv(mid, 2 * C, 1, bias=False))

    def forward(self, a, b):
        g = sk_gates(a + b, getattr(self, f"parallel{self.s}_skconv_fc1")[0],
                     getattr(self, f"parallel{self.s}_skconv_fc2")[0], 2, self.C)
        return a * g[:, 0, :, None, None] + b * g[:, 1, :, None, None]


class Ensemble(nn.Module):
    """The 5-way SK ensemble over the attribute outputs (ensemble{s}_skconv)."""

    def __init__(self, stage: int):
        super().__init__()
        s, C, red = stage + 1, STAGE_CH[stage], ATTN_RED[stage]
        self.s, self.C = s, C
        setattr(self, f"ensemble{s}_skconv_fc1", _conv(C, 5 * red, 1, bias=False))
        setattr(self, f"ensemble{s}_skconv_fc2", _conv(5 * red, 5 * C, 1, bias=False))

    def forward(self, outs):
        g = sk_gates(sum(outs), getattr(self, f"ensemble{self.s}_skconv_fc1")[0],
                     getattr(self, f"ensemble{self.s}_skconv_fc2")[0], 5, self.C)
        return sum(v * g[:, i, :, None, None] for i, v in enumerate(outs))


class ChannelAttention(nn.Module):
    """transformer{s}_<role>: 1x1 reduce, L2-normalised WK / WV linears,
    softmax(q . k * 30) over the reduced channel axis, 1x1 rise, residual
    on the input. Self-attention, or cross-attention with q from q_src."""

    def __init__(self, stage: int, role: str):
        super().__init__()
        s, C, red = stage + 1, STAGE_CH[stage], ATTN_RED[stage]
        self.pre = f"transformer{s}_{role}"
        setattr(self, f"{self.pre}_WK", _seq(0, nn.Linear(red, red)))
        setattr(self, f"{self.pre}_WV", _seq(0, nn.Linear(red, red)))
        setattr(self, f"{self.pre}_fc_reduce", _conv(C, red, 1, bias=False))
        setattr(self, f"{self.pre}_fc_rise", _conv(red, C, 1))

    def _part(self, name):
        return getattr(self, f"{self.pre}_{name}")[0]

    @staticmethod
    def _norm(t):
        return t / torch.clamp(torch.linalg.vector_norm(t, dim=-1, keepdim=True), min=1e-12)

    def forward(self, x, q_src=None):
        B, _, H, W = x.shape
        reduce = self._part("fc_reduce")
        tk = reduce(x).flatten(2).transpose(1, 2)
        tq = tk if q_src is None else reduce(q_src).flatten(2).transpose(1, 2)
        wq = self._norm(self._part("WK")(tq))
        wk = self._norm(self._part("WK")(tk))
        wv = self._norm(self._part("WV")(tk))
        aff = torch.softmax(torch.einsum("bti,btj->bij", wq, wk) * 30.0, -1)
        out = torch.einsum("bij,btj->bti", aff, wv)
        return x + self._part("fc_rise")(out.transpose(1, 2).reshape(B, -1, H, W))


class APFNet(MDNetHead):
    """(N, 6, 107, 107) -> (N, 1, 9216) features; MDNet's fc scoring."""

    def __init__(self, num_branches: int = 1):
        super().__init__()
        self.layers_v = SharedConvs()
        self.layers_i = SharedConvs()
        for st in range(3):
            s = st + 1
            setattr(self, f"parallel{s}", nn.ModuleList(AttrPath(st) for _ in ATTRIBUTES))
            setattr(self, f"parallel{s}_skconv", nn.ModuleList(SKPair(st) for _ in ATTRIBUTES))
            setattr(self, f"ensemble{s}_skconv", Ensemble(st))
            for role in ROLES:
                setattr(self, f"transformer{s}_{role}", ChannelAttention(st, role))
        self.fc = nn.Module()
        self.fc.fc4 = _seq(0, nn.Linear(2 * 512 * 9, 512))
        self.fc.fc5 = _seq(1, nn.Linear(512, 512))
        self.branches = nn.ModuleList(_seq(1, nn.Linear(512, 2)) for _ in range(num_branches))

    @staticmethod
    def _is_fc(name):
        return name.startswith(("fc.", "branches."))

    @staticmethod
    def _fc_layer(name):
        return f"fc6_{name.split('.')[1]}" if name.startswith("branches.") else name.split(".")[1]

    def extract_features(self, patches: torch.Tensor,
                         active_attribute: int | None = None) -> torch.Tensor:
        """The tracking topology, or with `active_attribute` (an index into
        ATTRIBUTES) the stage-1 topology (model_stage1.py:255-258; JAX
        apfnet.py:181-205): that attribute's branch alone, added to both
        streams, no ensemble and no transformers."""
        x1, x2 = patches[:, :3], patches[:, 3:6]
        for st, (cv, ci) in enumerate(((self.layers_v.stage1, self.layers_i.stage1),
                                       (self.layers_v.stage2, self.layers_i.stage2),
                                       (self.layers_v.stage3, self.layers_i.stage3))):
            s = st + 1
            paths, gates = getattr(self, f"parallel{s}"), getattr(self, f"parallel{s}_skconv")
            if active_attribute is not None:
                path, gate = paths[active_attribute], gates[active_attribute]
                V = gate(path(x1), path(x2))
                x1, x2 = cv(x1) + V, ci(x2) + V
                continue
            V = getattr(self, f"ensemble{s}_skconv")(
                [gate(path(x1), path(x2)) for path, gate in zip(paths, gates)])
            x1, x2 = cv(x1), ci(x2)
            enc_v, enc_i, enc_a, dec_v, dec_i = (getattr(self, f"transformer{s}_{r}")
                                                 for r in ROLES)
            x1, V, x2 = enc_v(x1), enc_a(V), enc_i(x2)
            x1, x2 = dec_v(x1, q_src=V), dec_i(x2, q_src=V)
        return torch.cat([x1, x2], 1).flatten(1)[:, None]

    def score(self, feats, branch: int = 0, keep=None, fc=None) -> torch.Tensor:
        k4, k6 = keep if keep is not None else (None, None)
        h = dropout(F.relu(self._linear(feats, fc, "fc.fc4.0")), k4)
        h = F.relu(self._linear(h, fc, "fc.fc5.1")).flatten(1)
        return self._linear(dropout(h, k6), fc, f"branches.{branch}.1")

    def dropout_masks(self, draws, key, n: int):
        """JAX's bernoulli masks of split(key): r1 after fc4, r2 before fc6."""
        r1, r2 = draws.split(key)
        return draws.bernoulli(r1, 0.5, (n, 1, 512)), draws.bernoulli(r2, 0.5, (n, 512))

    def forward(self, patches, branch: int = 0, active_attribute: int | None = None):
        return self.score(self.extract_features(patches, active_attribute), branch)


def stage_mask(model: APFNet, stage: int, attribute: int | None = None) -> dict[str, bool]:
    """The trainable parameters of APFNet's three training stages
    (train_stage{1,2,3}.py; mmtrack_tpu/models/apfnet.py:231-254):

      1  one attribute's fusion branch at every stage (`parallel{s}.{a}.*`,
         `parallel{s}_skconv.{a}.*`), run once per attribute;
      2  the aggregation: the 5-way ensembles and the transformers
         (`ensemble{s}_skconv.*`, `transformer{s}_*`);
      3  every parameter;

    fc4 / fc5 / fc6 (`fc.*`, `branches.*`) train in every stage. The
    forward is the tracking topology in every stage, as JAX's step runs
    it."""
    if stage not in (1, 2, 3):
        raise ValueError(f"APFNet trains in stages 1, 2 and 3, not {stage}")
    if stage == 1 and attribute not in range(len(ATTRIBUTES)):
        raise ValueError(f"stage 1 trains one attribute of 0-{len(ATTRIBUTES) - 1}, "
                         f"not {attribute}")
    if stage == 3:
        own = ("",)
    elif stage == 1:
        own = tuple(f"parallel{s}{part}.{attribute}." for s in (1, 2, 3)
                    for part in ("", "_skconv"))
    else:
        own = tuple(p for s in (1, 2, 3) for p in (f"ensemble{s}_skconv.", f"transformer{s}_"))
    return {name: name.startswith(("fc.", "branches.") + own)
            for name, _ in model.named_parameters()}

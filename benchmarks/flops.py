"""Analytic model FLOPs of one frame or one training sample, and the
kernel calls of one step, from a configuration's shapes.

A FLOP is one multiply or one add of a product or a convolution (two per
multiply-add), as torch.utils.flop_counter counts them; normalisation,
softmax, activations and the loss are not counted. The counts are the
model's own: a recompute that the program runs for its backward is not
model work and is not counted.

Forward, per frame, with L_a(i) the tokens of block i's attention and
L_m(i) those of its MLP (candidate elimination shortens both), C the
width, E = C x C:
  patch embeds        2 C (3 p^2) (Lz + Lx) per embedding (one, two with prompts)
  prompt blocks       3 x 2 (Lz + Lx) C h per block (h = the prompt's hidden width)
  qkv, proj           2 L_a (3E + E)
  attention           2 x 2 L_a^2 C   (q k^T and p v)
  CE vote             2 H Lz Ls       (the template rows' weighted sum)
  MLP                 2 L_m (2 r E)   (r = mlp_ratio)
  head                sum over the three towers of 2 Lx k^2 c_in c_out
Prompt-only training adds the backward a frozen trunk needs: the input
gradient of every product and convolution downstream of the first
trainable parameter (the same FLOPs as its forward), both operands'
gradients of each attention product, and the weight gradients of the
trainable prompt products; the RGB patch embedding, whose input and
weight need no gradient, and the CE vote, whose output feeds a sort, have
no backward.
"""

from __future__ import annotations

from benchmarks.reference.vipt import geometry


def _dims(cfg):
    m = cfg["model"]
    g = geometry(cfg)
    C, p, H = m["embed_dim"], m["patch_size"], m["num_heads"]
    lz, lx = g["lens_z"], g["lens_x"]
    loc = cfg["ce"]["loc"]
    La, Lm = [], []
    k = 0
    for i, ent in enumerate(g["entering"]):
        La.append(lz + ent)
        if i in loc:
            Lm.append(lz + g["kept"][k])
            k += 1
        else:
            Lm.append(lz + ent)
    return m, g, C, p, H, lz, lx, La, Lm


def _head_convs(cfg):
    """(k, c_in, c_out) of every convolution of the CENTER head."""
    m = cfg["model"]
    ch = m["head_channel"]
    widths = [m["embed_dim"], ch, ch // 2, ch // 4, ch // 8]
    convs = []
    for out in (1, 2, 2):
        convs += [(3, widths[k - 1], widths[k]) for k in range(1, 5)]
        convs.append((1, widths[4], out))
    return convs


def parts(cfg) -> dict[str, float]:
    """Forward FLOPs of one frame by part."""
    m, g, C, p, H, lz, lx, La, Lm = _dims(cfg)
    deep = m["prompt_type"] == "vipt_deep"
    r = m["mlp_ratio"]
    out = {"embed": 2 * C * 3 * p * p * (lz + lx) * (2 if deep else 1)}
    out["prompt"] = (m["depth"] * 3 * 2 * (lz + lx) * C * m["prompt_hidden"]) if deep else 0
    out["linear"] = sum(2 * a * 4 * C * C + 2 * b * 2 * r * C * C for a, b in zip(La, Lm))
    out["attention"] = sum(4 * a * a * C for a in La)
    out["ce_vote"] = sum(2 * H * lz * (La[i] - lz) for i in cfg["ce"]["loc"])
    out["head"] = sum(2 * lx * k * k * ci * co for k, ci, co in _head_convs(cfg))
    return {k: float(v) for k, v in out.items()}


def forward_flops(cfg) -> float:
    """Model FLOPs of one tracked frame (one forward)."""
    return sum(parts(cfg).values())


def train_flops(cfg) -> float:
    """Model FLOPs of one prompt-only training sample: forward + backward."""
    f = parts(cfg)
    m = cfg["model"]
    if m["prompt_type"] != "vipt_deep":
        raise ValueError("prompt-only training needs prompts")
    bwd = (f["embed"] / 2            # the prompt embedding's weight gradient
           + 2 * f["prompt"]         # input and weight gradients of every prompt product
           + f["linear"]             # input gradients of the frozen products
           + 2 * f["attention"]      # both operands of both products
           + f["head"])              # input gradients of the frozen head
    return sum(f.values()) + bwd


def block_tokens(cfg) -> list[tuple[int, int, bool]]:
    """(L_a, L_m, CE) of each block."""
    m, g, C, p, H, lz, lx, La, Lm = _dims(cfg)
    loc = cfg["ce"]["loc"]
    return [(a, b, i in loc) for i, (a, b) in enumerate(zip(La, Lm))]

"""ViPT's deep-prompt re-injection: one prompt step of `ViTCEPrompt.forward`.

Block 0 fuses the RGB and the auxiliary modality's patch tokens; every
later block of `vipt_deep` re-injects the prompt carried from the block
before (vit_ce_prompt.py:276-300; JAX models/vipt.py). One step over the
template part and the search grid:

    a = norm_a(token row), a zero row where CE pruned the grid position
    b = norm_b(prompt state row)
    state = PromptBlock(a, b)        (per part: the Fovea's softmax runs
                                       over the part's rows)
    tokens = tokens + state          (the live rows)

`prompt_step_plain` is the PyTorch composition of the modules, whose
rounding points the kernels keep. `prompt_step` takes it for CPU tensors
and launches the hand-written kernels (`csrc/prompt.cu`: one pass over
the rows, then one after the softmax's statistics) for CUDA tensors, or
raises: bf16 tokens, state and modules, C = 768. Under autograd the
kernels run the forward and the gradient is the plain composition's
(ops/plain_grad.py). The model picks `prompt_step_plain` itself where it
runs its plain layers (`use_kernels=False`, f32).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch.func import functional_call

from mmtrack_torch.kernels.build import load_library, stream_handle
from mmtrack_torch.ops.ce import gather_search_tokens, recover_search_tokens
from mmtrack_torch.ops.plain_grad import launch_with_plain_grad
from mmtrack_torch.utils import profiling

PROMPT_C = 768            # csrc/prompt.cu's one width (kC): ViT-B, every ViPT config
Pair = tuple[torch.Tensor, torch.Tensor]
# the PromptBlock's parameters, in the order the kernels' wrapper takes them
BLOCK_PARAMS = ("conv0_0.weight", "conv0_0.bias", "conv0_1.weight", "conv0_1.bias",
                "conv1x1.weight", "conv1x1.bias", "fovea.smooth")


def prompt_step_plain(tokens: Pair, prompted: Pair, norm_a, norm_b, block,
                      global_index_s: Optional[torch.Tensor] = None
                      ) -> tuple[torch.Tensor, Pair]:
    """One prompt step in plain PyTorch, any device and dtype.

    tokens: (template (B, Lz, C), search (B, Ll, C)) rows of the token
    stream, the search rows the live ones; prompted: the prompt state
    (template (B, Lz, C), search grid (B, Lx, C)), for block 0 the
    auxiliary modality's tokens; norm_a / norm_b: the LayerNorms of the
    token and the state rows; block: the PromptBlock; global_index_s
    (B, Ll): the grid position of each live search row, None when no row
    was pruned (Ll == Lx). Returns (tokens (B, Lz + Ll, C) with the prompt
    added, the new prompt state (template, search grid))."""
    tok_z, tok_s = tokens
    lens_x = prompted[1].shape[1]
    full_s = tok_s if global_index_s is None else recover_search_tokens(
        tok_s, global_index_s, lens_x)
    full = norm_a(torch.cat([tok_z, full_s], dim=1))
    lens_z = tok_z.shape[1]
    p_z = block(full[:, :lens_z], norm_b(prompted[0]))
    p_s = block(full[:, lens_z:], norm_b(prompted[1]))
    sel = p_s if global_index_s is None else gather_search_tokens(p_s, global_index_s)
    return torch.cat([tok_z, tok_s], dim=1) + torch.cat([p_z, sel], dim=1), (p_z, p_s)


def _rows(name: str, t: torch.Tensor, B: int, C: int) -> torch.Tensor:
    """`t` as (B, L, C) with rows of C contiguous, 16-byte aligned, and a
    lane stride of whole 16-byte vectors: a view such as a part of the
    token stream as it is, anything else copied."""
    if t.dim() != 3 or t.shape[0] != B or t.shape[2] != C:
        raise ValueError(f"prompt step: {name} must be (B={B}, L, C={C}), got {tuple(t.shape)}")
    if t.stride(2) != 1 or t.stride(1) != C or t.stride(0) % 8 or t.data_ptr() % 16:
        t = t.contiguous()
    return t


def _step_tensors(tokens: Pair, prompted: Pair, norm_a, norm_b, block) -> tuple:
    """The step's tensors as the kernels' wrapper and `_step_plain` take
    them: tokens, state, both LayerNorms' parameters, the block's."""
    return (*tokens, *prompted, norm_a.weight, norm_a.bias, norm_b.weight, norm_b.bias,
            *(block.get_parameter(k) for k in BLOCK_PARAMS))


def _step_plain(tok_z, tok_s, st_z, st_s, ga, ba, gb, bb, *block_params, modules,
                global_index_s) -> tuple[torch.Tensor, torch.Tensor]:
    """`prompt_step_plain` on `_step_tensors`' tensors in place of the
    modules' parameters: (tokens, the new state as one (B, Lz + Lx, C)).
    The plain gradient of the kernels' forward."""
    norm_a, norm_b, block = modules
    out, (p_z, p_s) = prompt_step_plain(
        (tok_z, tok_s), (st_z, st_s),
        lambda x: functional_call(norm_a, {"weight": ga, "bias": ba}, (x,)),
        lambda x: functional_call(norm_b, {"weight": gb, "bias": bb}, (x,)),
        lambda a, b: functional_call(block, dict(zip(BLOCK_PARAMS, block_params)), (a, b)),
        global_index_s)
    return out, torch.cat([p_z, p_s], dim=1)


def _prompt_launch(tok_z, tok_s, st_z, st_s, ga, ba, gb, bb, w0, b0, w1, b1, w2, b2, smooth,
                   modules, global_index_s) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernels on `_step_tensors`' tensors: (tokens, the new state as
    one (B, Lz + Lx, C)), or raises before the library is built."""
    bf16 = torch.bfloat16
    norm_a, norm_b, block = modules
    B, Lz, C = tok_z.shape
    tok_z, tok_s = (_rows(n, t, B, C) for n, t in zip(("tokens[0]", "tokens[1]"), (tok_z, tok_s)))
    st_z, st_s = (_rows(n, t, B, C) for n, t in zip(("prompted[0]", "prompted[1]"), (st_z, st_s)))
    Ll, Lx = tok_s.shape[1], st_s.shape[1]
    if st_z.shape[1] != Lz or not 1 <= Ll <= Lx:
        raise ValueError(f"prompt step: template rows {Lz} / {st_z.shape[1]}, search rows "
                         f"{Ll} live of {Lx}")
    computes = (norm_a.dtype, norm_b.dtype, block.conv0_0.dtype, block.conv0_1.dtype,
                block.conv1x1.dtype)
    if any(t.dtype != bf16 for t in (tok_z, tok_s, st_z, st_s)) or any(
            d != bf16 for d in computes):
        raise TypeError("prompt step kernel needs bf16 tokens, prompt state and modules "
                        "(an f32 model runs prompt_step_plain)")
    if C != PROMPT_C:
        raise ValueError(f"prompt step kernel needs C == {PROMPT_C}, got {C}")
    if global_index_s is None:
        if Ll != Lx:
            raise ValueError("prompt step: a pruned search part needs its global_index_s")
        gidx = None
    else:
        if tuple(global_index_s.shape) != (B, Ll):
            raise ValueError(f"prompt step: global_index_s {tuple(global_index_s.shape)}, "
                             f"want {(B, Ll)}")
        gidx = global_index_s.to(torch.int64).contiguous()
    w0, w1, w2 = (w[:, :, 0, 0].to(bf16).contiguous() for w in (w0, w1, w2))
    if w0.shape != (8, C) or w1.shape != (8, C) or w2.shape != (C, 8):
        raise ValueError(f"prompt step kernel needs C -> 8 -> C weights, got "
                         f"{tuple(w0.shape)}, {tuple(w1.shape)}, {tuple(w2.shape)}")
    small = [t.float().contiguous() for t in (ga, ba, gb, bb, b0, b1, b2, smooth)]
    dev = tok_z.device
    for t in (tok_z, tok_s, st_z, st_s, w0, w1, w2, *small) + (() if gidx is None else (gidx,)):
        if t.device != dev:
            raise ValueError(f"prompt step: every operand must be on {dev}")
    if dev.type != "cuda":
        raise ValueError(f"prompt step kernel needs CUDA tensors, got {dev}")
    ga, ba, gb, bb, b0, b1, b2, smooth = small
    out = torch.empty((B, Lz + Ll, C), dtype=bf16, device=dev)
    state = torch.empty((B, Lz + Lx, C), dtype=bf16, device=dev)
    proj = torch.empty((B, Lz + Lx, 16), dtype=bf16, device=dev)
    load_library().launch(
        "mmt_prompt_step_bf16", tok_z.data_ptr(), tok_z.stride(0), tok_s.data_ptr(),
        tok_s.stride(0), st_z.data_ptr(), st_z.stride(0), st_s.data_ptr(), st_s.stride(0),
        None if gidx is None else gidx.data_ptr(), ga.data_ptr(), ba.data_ptr(),
        float(norm_a.eps), gb.data_ptr(), bb.data_ptr(), float(norm_b.eps), w0.data_ptr(),
        b0.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), b2.data_ptr(),
        smooth.data_ptr(), proj.data_ptr(), out.data_ptr(), state.data_ptr(), B, Lz, Lx, Ll,
        C, stream_handle(dev))
    profiling.count("launches.prompt_step")
    return out, state


def prompt_step(tokens: Pair, prompted: Pair, norm_a, norm_b, block,
                global_index_s: Optional[torch.Tensor] = None) -> tuple[torch.Tensor, Pair]:
    """One prompt step (`prompt_step_plain`'s arguments and result).

    CPU tensors take the plain composition. CUDA tensors launch the
    kernels (bf16 tokens, state and modules, C = 768) or raise; under
    autograd with the plain composition's gradient."""
    if tokens[0].device.type == "cpu":
        return prompt_step_plain(tokens, prompted, norm_a, norm_b, block, global_index_s)
    out, state = launch_with_plain_grad(
        _prompt_launch, _step_plain, _step_tensors(tokens, prompted, norm_a, norm_b, block),
        modules=(norm_a, norm_b, block), global_index_s=global_index_s)
    lens_z = tokens[0].shape[1]
    return out, (state[:, :lens_z], state[:, lens_z:])

"""The attention kernel's order of operations, emulated on the CPU.

`csrc/attention.cu` cannot run here, so this test repeats its arithmetic in
torch at bf16, in its order: q scaled in bf16; a pass over 64-column K
tiles with, in the streaming kernel (L > 320), an online f32 row max and a
sum rescaled at each new max, or, in the resident kernel (L <= 320), the
exact row max and then one sum; then p = exp(s - max) / sum in f32 rounded
to bf16, and PV accumulated in f32 tile by tile and rounded to bf16 at the
end. The
emulation must stay within two bf16 ulps of the row's largest |output| of
both `flash_mhsa_qkv_plain` and the JAX Pallas `flash_mhsa_qkv` (interpret
mode), at the token counts of the tracking and training paths (320, 244,
190, 153) and a short one (17), and with logits spread over more than 80
in a row. The two sides differ only in f32 summation order, so a
probability or an output rounds one ulp the other way now and then.

The ulp bar alone would also pass the usual flash form that rounds the
unnormalised probabilities and divides O at the end; that form changes
12-50% of the outputs against the plain version, the kernel's order under
0.1%, so the plain comparison also holds the share of differing outputs
under 1%.

The kernel divides by a reciprocal and two FMAs (Markstein's correction);
a last test checks in exact arithmetic that this is the correctly rounded
division for the probabilities' range.
"""

from fractions import Fraction

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from mmtrack_torch.ops.flash_attn import flash_mhsa_qkv_plain  # noqa: E402

H, D = 2, 64          # the kernel's head width
C = H * D
TILE = 64             # the kernel's K/V tile rows
SCALE = D ** -0.5


def kernel_order_mhsa(qkv: torch.Tensor, num_heads: int, scale: float,
                      streaming: bool = True) -> torch.Tensor:
    """softmax(q k^T * scale) v in the attention kernel's order of operations:
    the streaming kernel's (an online max and rescaled sum, tile by tile) or
    the resident one's (the exact row max first, then one sum)."""
    B, L, C3 = qkv.shape
    d = C3 // 3 // num_heads
    parts = qkv.view(B, L, 3, num_heads, d).permute(2, 0, 3, 1, 4)   # (3, B, H, L, d)
    scale_bf16 = float(torch.tensor(scale, dtype=torch.bfloat16))
    q = (parts[0].float() * scale_bf16).to(torch.bfloat16).float()
    k, v = parts[1].float(), parts[2].float()
    tiles = range(0, L, TILE)
    m = torch.full((B, num_heads, L), -torch.inf)
    total = torch.zeros(B, num_heads, L)
    for j0 in tiles:                                   # pass 1: S tile by tile
        s = q @ k[..., j0:j0 + TILE, :].transpose(-1, -2)
        m_new = torch.maximum(m, s.amax(-1))
        if streaming:
            total = total * torch.exp(m - m_new) + torch.exp(s - m_new[..., None]).sum(-1)
        m = m_new
    if not streaming:
        for j0 in tiles:
            s = q @ k[..., j0:j0 + TILE, :].transpose(-1, -2)
            total = total + torch.exp(s - m[..., None]).sum(-1)
    out = torch.zeros(B, num_heads, L, d)
    for j0 in tiles:                                   # pass 2: normalised P, then PV
        s = q @ k[..., j0:j0 + TILE, :].transpose(-1, -2)
        p = (torch.exp(s - m[..., None]) / total[..., None]).to(torch.bfloat16)
        out = out + p.float() @ v[..., j0:j0 + TILE, :]
    return out.to(torch.bfloat16).transpose(1, 2).reshape(B, L, num_heads * d)


def _qkv(L: int, spread: bool) -> torch.Tensor:
    qkv = np.random.RandomState(L).randn(2, L, 3 * C).astype(np.float32)
    if spread:
        qkv[..., :C] *= 32
    return torch.from_numpy(qkv).to(torch.bfloat16)


def _assert_row_ulps(got: np.ndarray, want: np.ndarray, ulps: int = 2) -> None:
    scale = np.maximum(np.abs(got), np.abs(want)).max(-1, keepdims=True)
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(scale, 2.0 ** -126))) - 7)
    assert np.isfinite(got).all()
    assert (np.abs(got - want) <= ulps * ulp).all(), (np.abs(got - want) / ulp).max()


CASES = [(L, False) for L in (320, 244, 190, 153, 17)] + [(320, True)]


@pytest.mark.parametrize("streaming", [True, False], ids=["streaming", "resident"])
@pytest.mark.parametrize("L,spread", CASES)
def test_kernel_order_matches_plain(L, spread, streaming):
    qkv = _qkv(L, spread)
    if spread:
        q = qkv[..., :D].float() * SCALE
        logits = q @ qkv[..., C:C + D].float().transpose(-1, -2)
        assert (logits.amax(-1) - logits.amin(-1)).max() > 80
    got = kernel_order_mhsa(qkv, H, SCALE, streaming)
    want = flash_mhsa_qkv_plain(qkv, H, SCALE)
    assert got.dtype == torch.bfloat16 and got.shape == (2, L, C)
    _assert_row_ulps(got.float().numpy(), want.float().numpy())
    assert (got != want).float().mean() < 0.01


@pytest.mark.parametrize("streaming", [True, False], ids=["streaming", "resident"])
@pytest.mark.parametrize("L,spread", CASES)
def test_kernel_order_matches_pallas(L, spread, streaming):
    from mmtrack_tpu.ops.flash_attn import flash_mhsa_qkv as pallas_mhsa

    qkv = _qkv(L, spread)
    want = np.asarray(pallas_mhsa(jnp.asarray(qkv.float().numpy()).astype(jnp.bfloat16), H,
                                  SCALE, interpret=True).astype(jnp.float32))
    _assert_row_ulps(kernel_order_mhsa(qkv, H, SCALE, streaming).float().numpy(), want)


def _rn32(v: Fraction) -> Fraction:
    """An exact rational rounded to the nearest f32 (ties to even)."""
    if v == 0:
        return Fraction(0)
    a = abs(v)
    e = a.numerator.bit_length() - a.denominator.bit_length()
    if Fraction(2) ** e > a:
        e -= 1
    ulp = Fraction(2) ** (max(e, -126) - 23)
    q, r = divmod(a, ulp)
    if r > ulp / 2 or (r == ulp / 2 and q % 2):
        q += 1
    return (1 if v > 0 else -1) * q * ulp


def _markstein(x: Fraction, y: Fraction) -> Fraction:
    """The kernel's division: q = x r, then q + (x - q y) r with FMAs, r = 1/y."""
    r = _rn32(1 / y)
    q = _rn32(x * r)
    return _rn32(q + _rn32(x - q * y) * r)


def test_kernel_division_is_correctly_rounded():
    """p = e / sum in the kernel is a reciprocal and two FMAs: equal to the
    correctly rounded quotient for e in (0, 1] and sums in [1, 464] (the
    probabilities' range), on random pairs and on divisors with all-ones
    and near-one significands."""
    rng = np.random.RandomState(0)
    xs = [np.float32(np.exp(-rng.exponential(4.0))) for _ in range(1500)]
    xs += [np.float32(v) for v in rng.rand(500)] + [np.float32(1), np.float32(1 - 2 ** -24)]
    ys = [np.float32(1 + rng.rand() * 463) for _ in range(len(xs))]
    pairs = list(zip(xs, ys))
    hard = [Fraction(2) ** k * (1 + Fraction(m, 2 ** 23)) for k in range(9)
            for m in (0, 1, 2, 3, 2 ** 22 + 1, 2 ** 23 - 3, 2 ** 23 - 2, 2 ** 23 - 1)]
    pairs += [(x, y) for y in hard for x in xs[:40] + xs[-2:]]
    for x, y in pairs:
        x, y = Fraction(float(x)), Fraction(float(y))
        assert _markstein(x, y) == _rn32(x / y), (float(x), float(y))

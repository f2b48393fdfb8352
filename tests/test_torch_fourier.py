"""The port's Fourier and least-squares ops (mmtrack_torch/ops/fourier.py,
ops/optimization.py, ops/window.py::gauss_label_2d) against the JAX
package's at f32, on seeded numpy inputs, JAX jitted as its trackers run
these ops.

Bars, relative to the largest |JAX value| of the array: cfft2 (odd and
even N), sample_scores, shift_spectrum, embed_spectrum and
conj_symmetrize within 1e-5 (pocketfft on both sides, in other orders);
the three CG forms (plain, carried-direction Fletcher-Reeves,
carried-direction Polak-Ribiere over two calls with a decayed direction,
each preconditioned) and gauss_newton_cg on the same residuals within
1e-5, the carried state included; steepest_descent_gn (global and per
sample step lengths), mlu and gauss_label_2d within 1e-6. Exact: the
host constants (bicubic_interp_spectrum in f64 and with f32_parity,
gauss_label_spectrum, reg_filter with and without pad_to), max2d_wrapped
on maps with tied maxima, and a dead CG iteration freezing the carry.
"""

import test_torch_threads  # noqa: F401  (first: caps torch's CPU threads)
from functools import partial

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from mmtrack_tpu.ops import fourier as jf  # noqa: E402
from mmtrack_tpu.ops import optimization as jo  # noqa: E402
from mmtrack_tpu.ops import window as jw  # noqa: E402
from mmtrack_torch.ops import fourier as pf  # noqa: E402
from mmtrack_torch.ops import optimization as po  # noqa: E402
from mmtrack_torch.ops import window as pw  # noqa: E402


def close(got, want, rel):
    got = np.asarray(got.detach().numpy() if torch.is_tensor(got) else got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got.astype(np.complex128) - want.astype(np.complex128)).max()) / scale
    assert err <= rel, f"max |diff| / max |want| = {err:.3g} > {rel}"


def T(a):
    return torch.from_numpy(np.array(a))


def spectrum(rng, shape):
    return (rng.randn(*shape) + 1j * rng.randn(*shape)).astype(np.complex64)


# ---------------------------------------------------------------- spectra

@pytest.mark.parametrize("N", [9, 18, 52])
def test_cfft2_and_sample_scores_match_jax(N):
    rng = np.random.RandomState(N)
    x = rng.randn(3, N, N).astype(np.float32)
    want = jax.jit(jf.cfft2)(jnp.asarray(x))
    got = pf.cfft2(T(x))
    assert got.dtype == torch.complex64 and got.shape[-1] == N + (N + 1) % 2
    close(got, want, 1e-5)
    grid = 2 * N + 1
    close(pf.sample_scores(got, grid),
          jax.jit(partial(jf.sample_scores, grid=grid))(want), 1e-5)
    with pytest.raises(ValueError):
        pf.sample_scores(got, got.shape[-1] - 1)


def test_shift_embed_and_symmetrize_match_jax():
    rng = np.random.RandomState(1)
    S = spectrum(rng, (4, 2, 13, 13))
    shift = rng.uniform(-3, 3, (4, 1, 2)).astype(np.float32)
    close(pf.shift_spectrum(T(S), T(shift)),
          jax.jit(jf.shift_spectrum)(jnp.asarray(S), jnp.asarray(shift)), 1e-5)
    close(pf.embed_spectrum(T(S), 21), jax.jit(partial(jf.embed_spectrum, F_out=21))(
        jnp.asarray(S)), 1e-5)
    with pytest.raises(ValueError):
        pf.embed_spectrum(T(S), 11)
    close(pf.conj_symmetrize(T(S)), jax.jit(jf.conj_symmetrize)(jnp.asarray(S)), 1e-5)
    assert torch.equal(pf.centered_freqs(13), T(np.asarray(jf.centered_freqs(13))))


@pytest.mark.parametrize("F", [13, 53, 201])
def test_host_constants_equal_jax(F):
    for parity in (False, True):
        np.testing.assert_array_equal(pf.bicubic_interp_spectrum(F, -0.75, f32_parity=parity),
                                      jf.bicubic_interp_spectrum(F, -0.75, f32_parity=parity))
    np.testing.assert_array_equal(pf.gauss_label_spectrum(F, 1.7, 2.3),
                                  np.asarray(jf.gauss_label_spectrum(F, 1.7, 2.3)))
    args = ((F * 4, F * 4 + 8), (F * 0.7, F * 1.3), 1e-4, 1e-2, 2.0, 0.05)
    np.testing.assert_array_equal(pf.reg_filter(*args), jf.reg_filter(*args))
    np.testing.assert_array_equal(pf.reg_filter(*args, pad_to=15), jf.reg_filter(*args, pad_to=15))
    with pytest.raises(ValueError):
        pf.reg_filter(*args, pad_to=1)


def test_max2d_wrapped_takes_the_first_of_tied_maxima():
    rng = np.random.RandomState(2)
    s = rng.uniform(0, 1, (5, 17, 17)).astype(np.float32)
    s[0, 3, 4] = s[0, 12, 1] = 2.0          # tied: the row-major first wins
    s[1] = 0.5                               # all tied: index 0
    s[2, 16, 16] = s[2, 0, 16] = 3.0
    want = jax.jit(jf.max2d_wrapped)(jnp.asarray(s))
    got = pf.max2d_wrapped(T(s))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_gauss_label_2d_matches_jax():
    sig = np.float32(1.37)
    c = np.asarray([0.3, -1.6], np.float32)
    want = jax.jit(lambda s, cy, cx: jw.gauss_label_2d(18, 18, s, s, cy, cx))(sig, c[0], c[1])
    got = pw.gauss_label_2d(18, 18, torch.tensor(sig), torch.tensor(sig), T(c)[0], T(c)[1])
    close(got, want, 1e-6)
    close(pw.gauss_label_2d(7, 9, 2.0, 1.5), jw.gauss_label_2d(7, 9, 2.0, 1.5), 1e-6)


# ---------------------------------------------------------------- solvers

def _spd(rng, n):
    m = rng.randn(n, n).astype(np.float32)
    return (m @ m.T / n + 0.5 * np.eye(n)).astype(np.float32)


SYS_RNG = np.random.RandomState(3)
A1, A2 = _spd(SYS_RNG, 12), _spd(SYS_RNG, 7)
B = {"u": SYS_RNG.randn(12).astype(np.float32), "v": SYS_RNG.randn(7).astype(np.float32)}
DIAG = {"u": np.diag(A1).copy(), "v": np.diag(A2).copy()}


def _ops(lib):
    """The block system {u: A1 u, v: A2 v} and its Jacobi preconditioner in
    the framework `lib` (jnp or the port's torch)."""
    if lib is jnp:
        a1, a2, d = jnp.asarray(A1), jnp.asarray(A2), {k: jnp.asarray(v) for k, v in DIAG.items()}
    else:
        a1, a2, d = T(A1), T(A2), {k: T(v) for k, v in DIAG.items()}
    return (lambda t: {"u": a1 @ t["u"], "v": a2 @ t["v"]},
            lambda t: {"u": t["u"] / d["u"], "v": t["v"] / d["v"]})


CG_FORMS = ("plain", "stateful_fletcher_reeves", "stateful_polak_ribiere")


@pytest.mark.parametrize("form", CG_FORMS)
def test_cg_forms_match_jax(form):
    jb = {k: jnp.asarray(v) for k, v in B.items()}
    pb = {k: T(v) for k, v in B.items()}
    fr = form == "stateful_fletcher_reeves"
    if form == "plain":
        def jrun(b):
            A, M = _ops(jnp)
            return jo.conjugate_gradient(A, b, jax.tree.map(jnp.zeros_like, b), 6, precond=M)

        A, M = _ops(torch)
        close(po.conjugate_gradient(A, pb, po.tree_map(torch.zeros_like, pb), 6, precond=M)["u"],
              jax.jit(jrun)(jb)["u"], 1e-5)
        return

    # two calls: the second carries the first's direction, decayed
    def jrun(b):
        A, M = _ops(jnp)
        zero = jax.tree.map(jnp.zeros_like, b)
        x1, st = jo.conjugate_gradient_stateful(A, b, zero, 4, jo.cg_state_init(zero), precond=M,
                                                fletcher_reeves=fr,
                                                direction_forget_factor=0.15)
        b2 = jax.tree.map(lambda t: 0.7 * t, b)
        x2, st = jo.conjugate_gradient_stateful(A, b2, x1, 3, st, precond=M, fletcher_reeves=fr,
                                                direction_forget_factor=0.15)
        return x2, st

    A, M = _ops(torch)
    zero = po.tree_map(torch.zeros_like, pb)
    x1, st = po.conjugate_gradient_stateful(A, pb, zero, 4, po.cg_state_init(zero), precond=M,
                                            fletcher_reeves=fr, direction_forget_factor=0.15)
    x2, st = po.conjugate_gradient_stateful(A, po.tree_map(lambda t: 0.7 * t, pb), x1, 3, st,
                                            precond=M, fletcher_reeves=fr,
                                            direction_forget_factor=0.15)
    want_x, want_st = jax.jit(jrun)(jb)
    for k in ("u", "v"):
        close(x2[k], want_x[k], 1e-5)
        close(st[0][k], want_st[0][k], 1e-5)
        close(st[2][k], want_st[2][k], 1e-5)
    close(st[1], want_st[1], 1e-5)
    assert st[1].dtype == torch.float32 and bool(st[3]) == bool(want_st[3])


def test_dead_cg_iteration_freezes_the_carry():
    """b = 0: rho is 0 from the first iteration, so x stays and the carried
    direction, rho and r_prev keep their entry values (JAX's too)."""
    A, M = _ops(torch)
    zero = {k: torch.zeros_like(T(v)) for k, v in B.items()}
    p0 = {k: T(v) for k, v in B.items()}
    st0 = (p0, torch.tensor(2.0), p0, torch.tensor(True))
    x, st = po.conjugate_gradient_stateful(A, zero, zero, 3, st0, precond=M,
                                           fletcher_reeves=False, direction_forget_factor=0.5)
    jA, jM = _ops(jnp)
    jz = {k: jnp.zeros_like(jnp.asarray(v)) for k, v in B.items()}
    jp0 = {k: jnp.asarray(v) for k, v in B.items()}
    jx, jst = jax.jit(lambda s: jo.conjugate_gradient_stateful(
        jA, jz, jz, 3, s, precond=jM, fletcher_reeves=False, direction_forget_factor=0.5))(
        (jp0, jnp.float32(2.0), jp0, jnp.bool_(True)))
    for k in ("u", "v"):
        assert torch.equal(x[k], zero[k]) and torch.equal(st[0][k], p0[k])
        np.testing.assert_array_equal(st[0][k].numpy(), np.asarray(jst[0][k]))
    assert float(st[1]) == float(jst[1]) == 4.0 and bool(st[3])


def _residuals(lib, x, J, y):
    """A nonlinear pytree residual: tanh of a linear map, a square and a
    plain regulariser."""
    t = lib.tanh(x["w"] @ J) - y
    return {"data": t, "sq": 0.3 * x["s"] ** 2 - 0.1, "reg": (0.2 * x["w"], 0.1 * x["s"])}


def _gn_inputs():
    rng = np.random.RandomState(5)
    J = (rng.randn(6, 20) / 3).astype(np.float32)
    y = (0.5 * rng.randn(20)).astype(np.float32)
    x0 = {"w": (0.1 * rng.randn(6)).astype(np.float32), "s": rng.uniform(0.5, 1, 4).astype(np.float32)}
    return J, y, x0


@pytest.mark.parametrize("fletcher_reeves", [True, False])
def test_gauss_newton_cg_matches_jax(fletcher_reeves):
    J, y, x0 = _gn_inputs()
    prec = {"w": 2.0, "s": 0.5}

    def jrun(x):
        return jo.gauss_newton_cg(partial(_residuals, jnp, J=jnp.asarray(J), y=jnp.asarray(y)),
                                  x, 3, 5, precond=lambda t: {k: t[k] / prec[k] for k in t},
                                  fletcher_reeves=fletcher_reeves)

    want = jax.jit(jrun)({k: jnp.asarray(v) for k, v in x0.items()})
    with torch.no_grad():
        got = po.gauss_newton_cg(partial(_residuals, torch, J=T(J), y=T(y)),
                                 {k: T(v) for k, v in x0.items()}, 3, 5,
                                 precond=lambda t: {k: t[k] / prec[k] for k in t},
                                 fletcher_reeves=fletcher_reeves)
    for k in ("w", "s"):
        close(got[k], want[k], 1e-5)


@pytest.mark.parametrize("batch_dims", [0, 1])
def test_steepest_descent_gn_matches_jax(batch_dims):
    rng = np.random.RandomState(6)
    J = (rng.randn(3, 5, 8) / 3).astype(np.float32)
    y = (0.5 * rng.randn(3, 8)).astype(np.float32)
    x0 = {"a": (0.1 * rng.randn(3, 5)).astype(np.float32),
          "b": rng.uniform(0.5, 1, (3, 2)).astype(np.float32)}

    def res(lib, x, J, y):
        t = lib.tanh(lib.einsum("nk,nkm->nm", x["a"], J)) - y
        return {"d": t, "b": 0.3 * x["b"] ** 2 - 0.1}

    want = jax.jit(lambda x: jo.steepest_descent_gn(
        partial(res, jnp, J=jnp.asarray(J), y=jnp.asarray(y)), x, 3, steplength_reg=0.1,
        batch_dims=batch_dims))({k: jnp.asarray(v) for k, v in x0.items()})
    got = po.steepest_descent_gn(partial(res, torch, J=T(J), y=T(y)),
                                 {k: T(v) for k, v in x0.items()}, 3, steplength_reg=0.1,
                                 batch_dims=batch_dims)
    for k in ("a", "b"):
        close(got[k], want[k], 1e-6)


def test_mlu_matches_jax():
    x = np.concatenate([np.linspace(-3, 3, 61), [0.0, -0.0, -1e-6, 1e-6]]).astype(np.float32)
    close(po.mlu(T(x), 0.05), jax.jit(partial(jo.mlu, a=0.05))(jnp.asarray(x)), 1e-6)

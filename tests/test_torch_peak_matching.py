"""KeepTrack's learned peak matcher (models/peak_matching.py) against the
JAX package's at f32 on the CPU.

The flax leaves of the descriptor extractor and the matcher are drawn
from a numpy seed at the shapes of jax.eval_shape of their inits (no init
compile) and reach the port through
models/convert.py::peak_matching_state_dict_from_flax. Bars, at
descriptor_dim 32 and 256 on random peak sets with invalid slots:
log_assignment within 1e-4 where its row and column are valid or
dustbins (the masked entries sit near -1e4, within 1e-6 relative), the
matches equal, the match scores and the assignment probabilities within
1e-5, with the GNN's residual branches drawn at a tenth of LeCun's scale;
at full scale the matches and scores, the probabilities within 1e-4. The
DescriptorExtractor within 1e-5 of its largest magnitude, a peak on the
(H + 1)-th row and one past it included. The bridge: the port's
state_dict through JAX's convert_peak_matching_checkpoint gives the flax
trees exactly, and back.
"""

import test_torch_threads  # noqa: F401  (first: caps torch's CPU threads)
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from mmtrack_tpu.models import peak_matching as jpm  # noqa: E402
from mmtrack_tpu.models.convert import convert_peak_matching_checkpoint  # noqa: E402
from mmtrack_torch.models import peak_matching as pm  # noqa: E402
from mmtrack_torch.models.convert import peak_matching_state_dict_from_flax  # noqa: E402
from test_torch_dimp import _leaf, close  # noqa: E402

K = 4
FEAT = 1024                        # the raw layer3 width the descriptors read
D_SMALL = 32


def T(a, dtype=np.float32):
    return torch.from_numpy(np.array(a, dtype=dtype))


def matcher_trees(D: int, seed: int = 1, residual_scale: float = 0.1) -> dict:
    """{'desc': {'params'}, 'matcher': {'params', 'batch_stats'}} at
    descriptor_dim D, numpy-seeded at the inits' eval_shape; the GNN's
    residual branches end in a kernel drawn at `residual_scale` of
    LeCun's."""
    rng = np.random.RandomState(seed)

    def leaf(path, shape):
        v = _leaf(rng, path, shape)
        keys = [p.key for p in path]
        if keys[-3:] == ["mlp", "lin1", "kernel"]:
            v = v * residual_scale
        return np.asarray(v, np.float32)

    def fill(shapes):
        return jax.tree_util.tree_map_with_path(lambda path, s: leaf(path, s.shape), shapes)

    de, mt = jpm.DescriptorExtractor(D), jpm.PeakMatcher(descriptor_dim=D, input_dim=D)
    d, k, s, v = (jnp.zeros((1, K, D)), jnp.zeros((1, K, 2)), jnp.zeros((1, K)),
                  jnp.ones((1, K), bool))
    return {"desc": fill(jax.eval_shape(lambda: de.init(jax.random.PRNGKey(0),
                                                       jnp.zeros((6, 6, FEAT)),
                                                       jnp.zeros((K, 2))))),
            "matcher": fill(jax.eval_shape(lambda: mt.init(jax.random.PRNGKey(0), d, k, s, v, d,
                                                           k, s, v)))}


def port_matcher(trees, D: int) -> pm.PeakMatchingNetwork:
    net = pm.PeakMatchingNetwork(D, FEAT)
    net.load_state_dict(peak_matching_state_dict_from_flax(trees))
    return net.eval().requires_grad_(False)


@pytest.fixture(scope="module")
def trees():
    cache = {}

    def get(D, residual_scale=0.1):
        if (D, residual_scale) not in cache:
            cache[D, residual_scale] = matcher_trees(D, residual_scale=residual_scale)
        return cache[D, residual_scale]
    return get


# ---------------------------------------------------------------- the matcher

def _peak_sets(rng, D, B=2, H=120.0, W=160.0):
    def one():
        valid = rng.uniform(size=(B, K)) > 0.3
        valid[:, 0] = True
        return (rng.randn(B, K, D).astype(np.float32),
                np.stack([rng.uniform(0, H, (B, K)), rng.uniform(0, W, (B, K))], -1)
                .astype(np.float32),
                rng.uniform(0, 1, (B, K)).astype(np.float32), valid)
    return one() + one()


@functools.lru_cache(maxsize=None)
def jax_matcher(D: int):
    """The JAX matcher's apply at descriptor_dim D, jitted once."""
    jm = jpm.PeakMatcher(descriptor_dim=D, input_dim=D)
    return jax.jit(lambda v, *a: jm.apply(v, *a, image_size_wh=(160.0, 120.0)))


def _run_matchers(tr, D, prob_bar=1e-5):
    port = port_matcher(tr, D)
    sets = _peak_sets(np.random.RandomState(D), D)
    want = jax_matcher(D)(tr["matcher"], *map(jnp.asarray, sets))
    with torch.no_grad():
        got = port.matcher(*(T(a, bool) if a.dtype == bool else T(a) for a in sets),
                           image_size_wh=(160.0, 120.0))
    for k in ("matches0", "matches1"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    for k in ("match_scores0", "match_scores1"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=0, atol=1e-5)
    Z, jZ = got["log_assignment"].numpy(), np.asarray(want["log_assignment"])
    np.testing.assert_allclose(np.exp(Z), np.exp(jZ), rtol=0, atol=prob_bar)
    return Z, jZ, sets[3], sets[7]


@pytest.mark.parametrize("D", [D_SMALL, 256])
def test_matcher_matches_jax(trees, D):
    Z, jZ, v0, v1 = _run_matchers(trees(D), D)
    keep = (np.concatenate([v0, np.ones((2, 1), bool)], 1)[:, :, None]
            & np.concatenate([v1, np.ones((2, 1), bool)], 1)[:, None, :])
    np.testing.assert_allclose(Z[keep], jZ[keep], rtol=0, atol=1e-4)
    np.testing.assert_allclose(Z[~keep], jZ[~keep], rtol=1e-6, atol=0)


@pytest.mark.parametrize("D", [D_SMALL, 256])
def test_matcher_matches_jax_at_lecun_scale(trees, D):
    """The GNN's residual branches at LeCun's full scale: each of the 18
    layers doubles the descriptors' variance and the scores reach 1e4,
    where the log-domain sums cancel to f32's ulp there (log_assignment
    parts by ~1e-2 on entries of -500); the matches and their scores still
    agree, the assignment probabilities within 1e-4."""
    _run_matchers(trees(D, 1.0), D, prob_bar=1e-4)


@pytest.mark.parametrize("D", [D_SMALL, 256])
def test_descriptor_extractor_matches_jax(trees, D):
    tr = trees(D)
    rng = np.random.RandomState(3)
    feat = rng.randn(6, 7, FEAT).astype(np.float32)
    # (H, W) is the conv's last row and column, (H + 1, W + 1) clips to it
    coords = np.asarray([[0, 0], [6, 7], [3, 2], [7, 9]], np.float32)
    want = jpm.DescriptorExtractor(D).apply(tr["desc"], jnp.asarray(feat), jnp.asarray(coords))
    with torch.no_grad():
        got = port_matcher(tr, D).descriptor_extractor(T(feat), T(coords))
    close(got.numpy(), want, 1e-5)


def test_matcher_bridge_round_trip(trees):
    """The port's state_dict through JAX's convert_peak_matching_checkpoint
    gives the flax trees exactly; peak_matching_state_dict_from_flax of
    them gives it back."""
    tr = trees(256)
    sd = port_matcher(tr, 256).state_dict()
    back = convert_peak_matching_checkpoint(sd)
    flat_w = jax.tree_util.tree_leaves_with_path(tr)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_w) == len(flat_b)
    for path, v in flat_w:
        np.testing.assert_array_equal(np.asarray(flat_b[path]), v, err_msg=str(path))
    again = peak_matching_state_dict_from_flax(back)
    assert set(again) == {k for k in sd if not k.endswith("num_batches_tracked")}
    for k, v in again.items():
        assert torch.equal(v, sd[k]), k


@pytest.mark.parametrize("seed", [0, 1])
def test_matcher_nll_loss_and_gradient_match_jax(seed):
    """KeepTrack's matcher loss: matched, unmatched (dustbin) and invalid
    peaks; the loss within 1e-6 relative and its gradient with respect to
    the log-assignment within 1e-6 of JAX's (jax.grad)."""
    rng = np.random.RandomState(seed)
    B, M, N = 3, 5, 4
    la = rng.randn(B, M + 1, N + 1).astype(np.float32)
    gt = rng.randint(-1, N, (B, M)).astype(np.int32)
    valid0 = rng.rand(B, M) > 0.3
    valid1 = rng.rand(B, N) > 0.3
    if seed == 1:
        valid0[:] = False                 # no valid peak: the mean's floor of 1
    args = (jnp.asarray(gt), jnp.asarray(valid0), jnp.asarray(valid1))
    want, want_g = jax.value_and_grad(lambda x: jpm.matcher_nll_loss(x, *args))(jnp.asarray(la))
    x = T(la).requires_grad_(True)
    got = pm.matcher_nll_loss(x, T(gt), T(valid0), T(valid1))
    got.backward()
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(want_g), rtol=0, atol=1e-6)

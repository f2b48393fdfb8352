"""The streamed wire of the port on the CPU: device compose and host decode.

mmtrack_torch/ops/compose.py against mmtrack_tpu/ops/compose.py on the
same seeded planes: the rgbcolormap compose from raw 16-bit depth bit for
bit against JAX and compose_x (the tie fuzz included); the JET LUT, the
rgb + index compose and the
triangular chroma upsample bit for bit; the BT.601 conversion and the YUV
compose bit for bit against a numpy f32 reference that rounds once per
operation in JAX's written order, and within 1 LSB of JAX at under 1e-5
of the values (XLA's CPU backend contracts the G row's products into
fused multiply-adds: 2 of 786,432 values differ on a full chroma sweep
at most luma levels). The rgb + index compose also against the host's
compose_x. mmtrack_torch/data/native_io.py
against mmtrack_tpu/data/native_io.py and cv2 on files the tests write:
every decoder byte-equal, the cv2 fallback byte-equal to the native path,
the loader's build from source when the tracked library does not load,
and its report when nothing loads.
"""

import test_torch_threads  # noqa: F401  (first: caps torch's CPU threads)
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import cv2  # noqa: E402
import jax  # noqa: E402

from mmtrack_torch.data import composition, native_io  # noqa: E402
from mmtrack_torch.ops import compose  # noqa: E402
from mmtrack_tpu.data import native_io as jax_native_io  # noqa: E402
from mmtrack_tpu.ops import compose as jax_compose  # noqa: E402


def _planes(lead, H, W, seed, smooth=False):
    """(y, cb, cr, idx, rgb) uint8 planes with leading axes `lead`; smooth
    content keeps most values inside the clamp, extremes are included."""
    rng = np.random.default_rng(seed)

    def plane(shape):
        if not smooth:
            return rng.integers(0, 256, (*lead, *shape)).astype(np.uint8)
        coarse = rng.integers(0, 256, (*lead, shape[0] // 4 + 1, shape[1] // 4 + 1))
        up = np.repeat(np.repeat(coarse, 4, -2), 4, -1)[..., :shape[0], :shape[1]]
        return up.astype(np.uint8)

    y, cb, cr = plane((H, W)), plane((H // 2, W // 2)), plane((H // 2, W // 2))
    y.reshape(-1)[:4] = (0, 255, 0, 255)
    cb.reshape(-1)[:2] = (0, 255)
    cr.reshape(-1)[:2] = (255, 0)
    idx = rng.integers(0, 256, (*lead, H, W)).astype(np.uint8)
    rgb = rng.integers(0, 256, (*lead, H, W, 3)).astype(np.uint8)
    return y, cb, cr, idx, rgb


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def test_jet_lut_equals_jax():
    lut = compose.jet_lut()
    assert lut.shape == (256, 3) and lut.dtype == np.uint8
    np.testing.assert_array_equal(lut, jax_compose.jet_lut())


LEADS = [(), (3,), (2, 2)]


@pytest.mark.parametrize("lead", LEADS)
def test_rgb_index_compose_bit_equal_to_jax(lead):
    _, _, _, idx, rgb = _planes(lead, 24, 40, 1)
    lut = compose.jet_lut()
    want = np.asarray(jax.jit(jax_compose.compose_rgb_index_device)(rgb, idx, lut))
    got = compose.compose_rgb_index_device(*_t(rgb, idx, lut))
    assert got.dtype == torch.uint8 and got.shape == (*lead, 24, 40, 6)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("clip", [True, False])
def test_rgb_index_compose_equals_host_compose(clip):
    """The 4 B/px wire reproduces compose_x('rgbcolormap') bit for bit,
    also where the depth clip's median is a half-integer."""
    rng = np.random.default_rng(2)
    rgb = rng.integers(0, 256, (30, 44, 3)).astype(np.uint8)
    depth = rng.integers(300, 9000, (30, 44)).astype(np.uint16)
    host = composition.compose_x(rgb, depth, "rgbcolormap", x_clip=clip)
    idx = composition.depth_index_u8(depth, x_clip=clip)
    dev = compose.compose_rgb_index_device(*_t(rgb, idx, compose.jet_lut()))
    np.testing.assert_array_equal(dev.numpy(), host)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("clip", [True, False])
def test_rgbcolormap_device_bit_equal_to_jax_and_host(seed, clip):
    """compose_rgbcolormap_device against JAX's and compose_x on raw uint16
    depth (the cases of tests/test_eval.py:180-200)."""
    r = np.random.RandomState(seed)
    rgb = r.randint(0, 255, (32, 48, 3)).astype(np.uint8)
    dep = r.randint(100, 60000, (32, 48)).astype(np.uint16)
    lut = compose.jet_lut()
    host = composition.compose_x(rgb, dep, "rgbcolormap", x_clip=clip)
    want = np.asarray(jax_compose.compose_rgbcolormap_device(rgb, dep, jax.numpy.asarray(lut),
                                                              depth_clip=clip))
    got = compose.compose_rgbcolormap_device(*_t(rgb, dep, lut), depth_clip=clip)
    assert got.dtype == torch.uint8 and got.shape == (32, 48, 6)
    np.testing.assert_array_equal(got.numpy(), host)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("lead", LEADS[1:])
def test_rgbcolormap_device_leading_axes(lead):
    """Each frame of a (T, B) batch composes on its own clip and range."""
    rng = np.random.RandomState(9)
    rgb = rng.randint(0, 255, (*lead, 16, 20, 3)).astype(np.uint8)
    dep = rng.randint(0, 9000, (*lead, 16, 20)).astype(np.uint16)
    dep.reshape(-1, 16, 20)[0] //= 7                               # another range per frame
    lut = compose.jet_lut()
    got = compose.compose_rgbcolormap_device(*_t(rgb, dep, lut))
    assert got.shape == (*lead, 16, 20, 6)
    want = np.asarray(jax_compose.compose_rgbcolormap_device(rgb, dep, jax.numpy.asarray(lut)))
    np.testing.assert_array_equal(got.numpy(), want)
    for f, (c, d) in enumerate(zip(rgb.reshape(-1, 16, 20, 3), dep.reshape(-1, 16, 20))):
        np.testing.assert_array_equal(got.numpy().reshape(-1, 16, 20, 6)[f],
                                      composition.compose_x(c, d, "rgbcolormap", x_clip=True))


def test_rgbcolormap_device_rounding_ties():
    """The tie fuzz of tests/test_eval.py:223-250: tight depth ranges put
    NORM_MINMAX results on .5 and even-count medians on x.5; the f64 sum
    cast once to f32 must round as cv2's f32 FMA, with 0 mismatches
    against compose_x and JAX; a constant map gets index 0."""
    lut = compose.jet_lut()
    jax_fn = jax.jit(lambda r, d: jax_compose.compose_rgbcolormap_device(
        r, d, jax.numpy.asarray(lut)))
    rng = np.random.default_rng(21)
    mismatches = 0
    for trial in range(25):
        n = 48
        lo = int(rng.integers(0, 30000))
        hi = lo + int(rng.integers(100, 12000))
        d = rng.integers(lo, hi + 1, size=(n, n)).astype(np.uint16)
        rgb = rng.integers(0, 255, (n, n, 3)).astype(np.uint8)
        host = composition.compose_x(rgb, d, "rgbcolormap", x_clip=True)
        got = compose.compose_rgbcolormap_device(*_t(rgb, d, lut)).numpy()
        mismatches += int((got != host).sum())
        np.testing.assert_array_equal(
            got, np.asarray(jax_fn(rgb, d)))
    assert mismatches == 0
    d = np.full((16, 16), 4321, np.uint16)
    rgb = np.zeros((16, 16, 3), np.uint8)
    np.testing.assert_array_equal(compose.compose_rgbcolormap_device(*_t(rgb, d, lut)).numpy(),
                                  composition.compose_x(rgb, d, "rgbcolormap", x_clip=True))


def _yuv_one_rounding(y, cb, cr):
    """BT.601 of ops/compose.py in numpy f32, one rounding per operation in
    the written order: what the port computes on either device."""
    cbu = compose._upsample2x_triangular(torch.from_numpy(cb)).numpy() - np.float32(128)
    cru = compose._upsample2x_triangular(torch.from_numpy(cr)).numpy() - np.float32(128)
    yf = y.astype(np.float32)
    r = yf + np.float32(1.402) * cru
    g = yf - np.float32(0.344136286) * cbu - np.float32(0.714136286) * cru
    b = yf + np.float32(1.772) * cbu
    return np.clip(np.round(np.stack([r, g, b], -1)), 0, 255).astype(np.uint8)


def _assert_within_jax_bar(got, want):
    """At most 1 LSB from JAX, at under 1e-5 of the values: XLA's CPU
    backend contracts the products of the G row into fused multiply-adds,
    so where the one-rounding G lands on .5 it may round the other way
    (2 of 786,432 values on a full (cb, cr) sweep at most luma levels)."""
    diff = np.abs(got.astype(int) - want.astype(int))
    assert diff.max() <= 1, diff.max()
    assert (diff > 0).sum() <= 1e-5 * diff.size, f"{(diff > 0).sum()} of {diff.size} differ"


@pytest.mark.parametrize("smooth", [False, True])
@pytest.mark.parametrize("lead", LEADS)
def test_upsample_and_yuv_to_rgb_match_jax(lead, smooth):
    y, cb, cr, idx, _ = _planes(lead, 32, 48, 3 + len(lead), smooth)
    first = (0,) * len(lead)        # JAX's upsample takes one 2-D plane
    up = compose._upsample2x_triangular(torch.from_numpy(cb)).numpy()
    assert up.shape == (*lead, 32, 48) and up.dtype == np.float32
    np.testing.assert_array_equal(
        up[first], np.asarray(jax.jit(jax_compose._upsample2x_triangular)(cb[first])))
    got = compose.yuv420_to_rgb_device(*_t(y, cb, cr)).numpy()
    assert got.dtype == np.uint8 and got.shape == (*lead, 32, 48, 3)
    np.testing.assert_array_equal(got, _yuv_one_rounding(y, cb, cr))
    _assert_within_jax_bar(got, np.asarray(jax.jit(jax_compose.yuv420_to_rgb_device)(y, cb, cr)))
    lut = compose.jet_lut()
    got6 = compose.compose_yuv_index_device(*_t(y, cb, cr, idx, lut)).numpy()
    np.testing.assert_array_equal(got6[..., :3], got)
    np.testing.assert_array_equal(got6[..., 3:], lut[idx])
    _assert_within_jax_bar(
        got6, np.asarray(jax.jit(jax_compose.compose_yuv_index_device)(y, cb, cr, idx, lut)))


@pytest.mark.parametrize("luma", [0, 36, 100, 128, 200, 255])
def test_yuv_to_rgb_every_chroma_pair(luma):
    """All 256^2 (cb, cr) pairs: bit-equal to the one-rounding reference,
    within the bar of JAX."""
    c = np.arange(256, dtype=np.uint8)
    cb, cr = np.meshgrid(c, c, indexing="ij")
    cb, cr = cb.reshape(128, 512), cr.reshape(128, 512)
    y = np.full((256, 1024), luma, np.uint8)
    got = compose.yuv420_to_rgb_device(*_t(y, cb, cr)).numpy()
    np.testing.assert_array_equal(got, _yuv_one_rounding(y, cb, cr))
    _assert_within_jax_bar(got, np.asarray(jax.jit(jax_compose.yuv420_to_rgb_device)(y, cb, cr)))


@pytest.fixture
def pair(tmp_path):
    """A 48x64 JPEG (4:2:0, smooth) + 16-bit PNG pair and a 40x56 JPEG that
    the raw 4:2:0 decode must refuse."""
    rng = np.random.default_rng(5)
    base = rng.integers(0, 255, (6, 8, 3)).astype(np.uint8)
    frame = cv2.resize(base, (64, 48), interpolation=cv2.INTER_LINEAR)
    depth = rng.integers(500, 4000, (48, 64)).astype(np.uint16)
    jp, pp, jp2 = str(tmp_path / "f.jpg"), str(tmp_path / "d.png"), str(tmp_path / "g.jpg")
    cv2.imwrite(jp, frame[..., ::-1])
    cv2.imwrite(pp, depth)
    cv2.imwrite(jp2, frame[:40, :56, ::-1])
    return jp, pp, jp2


def test_native_decoder_loads_here():
    assert native_io.decoder() == "native"
    assert native_io.load_error() is None


@pytest.mark.parametrize("clip", [True, False])
def test_decode_pair_rgb_index_byte_equal(pair, clip):
    jp, pp, _ = pair
    outs = []
    for mod in (native_io, jax_native_io):
        rgb = np.zeros((2, 48, 64, 3), np.uint8)
        idx = np.zeros((2, 48, 64), np.uint8)
        mod.decode_pair_rgb_index(jp, pp, rgb[1], idx[1], clip=clip)
        assert rgb[0].max() == 0 and idx[0].max() == 0   # slice writes stay in-slice
        outs.append((rgb[1], idx[1]))
    ref_rgb = cv2.cvtColor(cv2.imread(jp), cv2.COLOR_BGR2RGB)
    ref_idx = composition.depth_index_u8(cv2.imread(pp, -1), x_clip=clip)
    for rgb, idx in outs:
        np.testing.assert_array_equal(rgb, ref_rgb)
        np.testing.assert_array_equal(idx, ref_idx)


def test_decode_jpeg_png_and_index_byte_equal(pair):
    jp, pp, _ = pair
    a, b = native_io.decode_jpeg_rgb(jp), jax_native_io.decode_jpeg_rgb(jp)
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(a, cv2.cvtColor(cv2.imread(jp), cv2.COLOR_BGR2RGB))
    out = np.zeros((64, 80, 3), np.uint8)
    np.testing.assert_array_equal(native_io.decode_jpeg_rgb(jp, out=out), a)
    d = native_io.decode_png_u16(pp)
    np.testing.assert_array_equal(d, jax_native_io.decode_png_u16(pp))
    np.testing.assert_array_equal(d, cv2.imread(pp, -1))
    assert native_io.decode_jpeg_rgb(pp) is None
    rng = np.random.default_rng(11)
    for trial in range(20):
        depth = rng.integers(0, 30000, (17, 23)).astype(np.uint16)
        for clip in (True, False):
            got = native_io.depth_index_u8_native(depth, clip=clip)
            np.testing.assert_array_equal(got, jax_native_io.depth_index_u8_native(depth, clip))
            np.testing.assert_array_equal(got, composition.depth_index_u8(depth, x_clip=clip))


def test_decode_pair_yuv_index_byte_equal_and_within_one_lsb(pair):
    jp, pp, jp2 = pair
    outs = []
    for mod in (native_io, jax_native_io):
        planes = (np.zeros((48, 64), np.uint8), np.zeros((24, 32), np.uint8),
                  np.zeros((24, 32), np.uint8), np.zeros((48, 64), np.uint8))
        assert mod.decode_pair_yuv_index(jp, pp, *planes)
        outs.append(planes)
        assert not mod.decode_pair_yuv_index(jp2, pp, np.zeros((40, 56), np.uint8),
                                             np.zeros((20, 28), np.uint8),
                                             np.zeros((20, 28), np.uint8),
                                             np.zeros((40, 56), np.uint8))
    for a, b in zip(*outs):
        np.testing.assert_array_equal(a, b)
    y, cb, cr, idx = outs[0]
    rgb = compose.yuv420_to_rgb_device(*_t(y, cb, cr)).numpy()
    ref = cv2.cvtColor(cv2.imread(jp), cv2.COLOR_BGR2RGB)
    assert np.abs(rgb.astype(int) - ref.astype(int)).max() <= 1
    np.testing.assert_array_equal(idx, composition.depth_index_u8(cv2.imread(pp, -1)))


@pytest.fixture
def fresh_loader(monkeypatch, tmp_path):
    """The loader's state reset, its build directory in tmp_path."""
    monkeypatch.setattr(native_io, "_lib", None)
    monkeypatch.setattr(native_io, "_lib_tried", False)
    monkeypatch.setattr(native_io, "_load_error", None)
    monkeypatch.setattr(native_io, "_BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(native_io, "_SO_PATH", str(tmp_path / "missing" / "libimageio.so"))
    return tmp_path


def test_loader_builds_the_source_when_the_tracked_library_fails(fresh_loader, pair):
    assert native_io.decoder() == "native"
    built = list((fresh_loader / "build").iterdir())
    assert len(built) == 1 and built[0].name.startswith("libimageio_")
    jp, pp, _ = pair
    rgb, idx = np.zeros((48, 64, 3), np.uint8), np.zeros((48, 64), np.uint8)
    native_io.decode_pair_rgb_index(jp, pp, rgb, idx)
    np.testing.assert_array_equal(rgb, cv2.cvtColor(cv2.imread(jp), cv2.COLOR_BGR2RGB))


def test_cv2_fallback_byte_equal_and_reported(fresh_loader, monkeypatch, pair):
    """Neither the tracked library nor a build: decoder() says cv2,
    load_error() names both causes, the rgb + index decode still equals
    the native one, and the raw 4:2:0 decode refuses."""
    monkeypatch.setattr(native_io, "_SRC_PATH", str(fresh_loader / "missing" / "imageio.cc"))
    assert native_io.decoder() == "cv2"
    err = native_io.load_error()
    assert "libimageio.so" in err and "imageio.cc" in err
    jp, pp, _ = pair
    rgb, idx = np.zeros((48, 64, 3), np.uint8), np.zeros((48, 64), np.uint8)
    native_io.decode_pair_rgb_index(jp, pp, rgb, idx)
    want_rgb, want_idx = np.zeros_like(rgb), np.zeros_like(idx)
    jax_native_io.decode_pair_rgb_index(jp, pp, want_rgb, want_idx)
    np.testing.assert_array_equal(rgb, want_rgb)
    np.testing.assert_array_equal(idx, want_idx)
    assert native_io.decode_jpeg_rgb(jp) is None
    d = np.random.default_rng(0).integers(0, 9000, (9, 13)).astype(np.uint16)
    np.testing.assert_array_equal(native_io.depth_index_u8_native(d),
                                  composition.depth_index_u8(d))
    assert not native_io.decode_pair_yuv_index(jp, pp, np.zeros((48, 64), np.uint8),
                                               np.zeros((24, 32), np.uint8),
                                               np.zeros((24, 32), np.uint8),
                                               np.zeros((48, 64), np.uint8))


def test_decoders_refuse_buffers_the_c_side_would_overrun(pair):
    jp, pp, _ = pair
    idx = np.zeros((48, 64), np.uint8)
    for bad in (np.zeros((48, 64, 4), np.uint8)[..., :3], np.zeros((48, 32, 3), np.uint8),
                np.zeros((48, 64, 3), np.int16)):
        with pytest.raises(ValueError, match="rgb_out"):
            native_io.decode_pair_rgb_index(jp, pp, bad, idx)
    with pytest.raises(ValueError, match="cb_out"):
        native_io.decode_pair_yuv_index(jp, pp, np.zeros((48, 64), np.uint8),
                                        np.zeros((24, 16), np.uint8),
                                        np.zeros((24, 32), np.uint8), idx)

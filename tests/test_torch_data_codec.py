"""The port's native JPEG/PNG codec and resize (``lap_tpu_torch/csrc/
lap_native.cpp`` through ``lap_tpu_torch/native.py``) against OpenCV, which
the JAX package's ``decode_image``, ``encode_jpeg`` and ``resize_with_pad_np``
call, on the CPU.

Exact, no tolerance: the native JPEG decode gives ``cv2.imdecode``'s bits on
baseline files that cv2 writes (4:2:0, 4:2:2, 4:4:4, 4:1:1, 4:4:0 and
grayscale; odd and camera sizes; restart markers; qualities 5-100), and cv2
reads the port's encoder's files to the port's decode of them. PNG (every
filter type; grey, grey+alpha, RGB, RGBA, palette) decodes to cv2's bits,
and the golden PNG of ``tests/golden/ref_parity/images.npz`` decodes to
cv2's and resizes within ``test_ref_parity.py``'s image tolerance of the
reference's. The resize equals ``cv2.resize(INTER_LINEAR)`` bit for bit.
Files the decoder does not take raise ``ValueError`` naming what they are.
"""

import struct
import zlib

import numpy as np
import pytest

pytest.importorskip("torch")
cv2 = pytest.importorskip("cv2")

from lap_tpu.data import episode_pipeline as jax_ep  # noqa: E402
from lap_tpu_torch import native  # noqa: E402
from lap_tpu_torch.data import episode_pipeline as port_ep  # noqa: E402
from lap_tpu_torch.utils import image  # noqa: E402

SAMPLING = {
    "420": None,  # cv2's default at quality 95
    "422": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
    "444": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444,
    "411": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411,
    "440": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440,
}
SIZES = [(31, 57), (480, 640), (3, 5), (17, 2)]


@pytest.fixture(scope="module", autouse=True)
def _library():
    if native.get_lib() is None:
        pytest.fail("the native library did not build (g++)")


def _frame(h, w, seed=0, noise=10.0):
    """Smooth structure plus noise, as a camera frame."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    img = np.stack([x * 255.0 / max(w, 1), y * 255.0 / max(h, 1), 128 + 100 * np.sin((x + 2 * y) / 9.0)], -1)
    return np.clip(img + rng.normal(0, noise, img.shape), 0, 255).astype(np.uint8)


def _cv2_decode(data: bytes) -> np.ndarray:
    return cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)[..., ::-1]


def _cv2_jpeg(rgb, quality=95, sampling=None, restart=None) -> bytes:
    params = [cv2.IMWRITE_JPEG_QUALITY, quality]
    if sampling is not None:
        params += [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, sampling]
    if restart is not None:
        params += [cv2.IMWRITE_JPEG_RST_INTERVAL, restart]
    ok, buf = cv2.imencode(".jpg", rgb[..., ::-1] if rgb.ndim == 3 else rgb, params)
    assert ok
    return buf.tobytes()


@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("sampling", sorted(SAMPLING))
def test_jpeg_decode_equals_cv2(sampling, size):
    data = _cv2_jpeg(_frame(*size), sampling=SAMPLING[sampling])
    np.testing.assert_array_equal(native.jpeg_decode(data), _cv2_decode(data))


@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_grayscale_jpeg_decodes_to_cv2s_three_channels(size):
    data = _cv2_jpeg(_frame(*size)[..., 1])
    got = native.jpeg_decode(data)
    assert got.shape == (*size, 3)
    np.testing.assert_array_equal(got, _cv2_decode(data))


@pytest.mark.parametrize("restart", [1, 3, 7])
@pytest.mark.parametrize("sampling", ["420", "444"])
def test_jpeg_with_restart_markers_equals_cv2(sampling, restart):
    data = _cv2_jpeg(_frame(57, 83, seed=restart), sampling=SAMPLING[sampling], restart=restart)
    assert b"\xff\xdd" in data and b"\xff\xd0" in data  # DRI and RST0 are there
    np.testing.assert_array_equal(native.jpeg_decode(data), _cv2_decode(data))


@pytest.mark.parametrize("quality", [5, 30, 75, 100])
def test_noise_at_every_quality_equals_cv2(quality):
    """Noise drives the IDCT into its range limit and long Huffman codes."""
    rgb = np.random.default_rng(quality).integers(0, 256, (40, 72, 3), np.uint8)
    for sampling in (None, SAMPLING["444"]):
        data = _cv2_jpeg(rgb, quality=quality, sampling=sampling)
        np.testing.assert_array_equal(native.jpeg_decode(data), _cv2_decode(data))


@pytest.mark.parametrize("quality", [20, 95])
@pytest.mark.parametrize("size", [(256, 256), (31, 57), (1, 1), (9, 2)], ids=lambda s: f"{s[0]}x{s[1]}")
def test_encoder_round_trips_through_cv2(size, quality):
    rgb = _frame(*size, seed=quality)
    data = native.jpeg_encode(rgb, quality)
    assert data[:2] == b"\xff\xd8" and data[-2:] == b"\xff\xd9"
    ours = native.jpeg_decode(data)
    np.testing.assert_array_equal(ours, _cv2_decode(data))
    if size == (256, 256):  # as faithful as cv2's encoder at the same quality (within 5%)
        theirs = _cv2_decode(_cv2_jpeg(rgb, quality=quality))
        assert np.abs(ours.astype(int) - rgb).mean() <= 1.05 * np.abs(theirs.astype(int) - rgb).mean()
    grey = native.jpeg_encode(rgb[..., 0], quality)
    np.testing.assert_array_equal(native.jpeg_decode(grey), _cv2_decode(grey))


def test_encoder_writes_smooth_frames_at_camera_sizes():
    data = port_ep.encode_jpeg(_frame(256, 256, noise=3.0), 95)
    assert 10_000 < len(data) < 40_000, len(data)


def test_progressive_file_raises_naming_its_marker():
    ok, buf = cv2.imencode(".jpg", _frame(32, 32), [cv2.IMWRITE_JPEG_PROGRESSIVE, 1])
    with pytest.raises(ValueError, match="SOF2 .progressive."):
        native.jpeg_decode(buf.tobytes())
    with pytest.raises(ValueError, match="SOF2"):
        port_ep.decode_image(buf.tobytes())


def test_arithmetic_and_12_bit_files_raise():
    data = bytearray(_cv2_jpeg(_frame(16, 16)))
    sof = data.index(b"\xff\xc0")
    arith = bytes(data[:sof + 1]) + b"\xc9" + bytes(data[sof + 2:])
    with pytest.raises(ValueError, match="SOF9 .arithmetic"):
        native.jpeg_decode(arith)
    twelve = bytearray(data)
    twelve[sof + 4] = 12  # the sample precision byte
    with pytest.raises(ValueError, match="12-bit"):
        native.jpeg_decode(bytes(twelve))
    with pytest.raises(ValueError, match="neither JPEG nor PNG"):
        native.decode_image(b"GIF89a....")


def _png(pixels: np.ndarray, color_type: int, filter_type: int, palette=None) -> bytes:
    """A PNG whose rows all use ``filter_type``."""
    h, w = pixels.shape[:2]
    rows = pixels.reshape(h, -1).astype(np.int32)
    bpp = pixels.shape[2] if pixels.ndim == 3 else 1
    raw = bytearray()
    for y in range(h):
        row, up = rows[y], rows[y - 1] if y else np.zeros_like(rows[y])
        left = np.concatenate([np.zeros(bpp, np.int32), row[:-bpp]])
        upleft = np.concatenate([np.zeros(bpp, np.int32), up[:-bpp]])
        if filter_type == 0:
            out = row
        elif filter_type == 1:
            out = row - left
        elif filter_type == 2:
            out = row - up
        elif filter_type == 3:
            out = row - (left + up) // 2
        else:
            p = left + up - upleft
            pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, upleft))
            out = row - pred
        raw += bytes([filter_type]) + (out % 256).astype(np.uint8).tobytes()

    def chunk(kind, body):
        return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))

    png = b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0))
    if palette is not None:
        png += chunk(b"PLTE", palette.tobytes())
    return png + chunk(b"IDAT", zlib.compress(bytes(raw))) + chunk(b"IEND", b"")


@pytest.mark.parametrize("filter_type", range(5))
@pytest.mark.parametrize("color_type", [0, 2, 3, 4, 6], ids=["grey", "rgb", "palette", "grey_alpha", "rgba"])
def test_png_decode_equals_cv2(color_type, filter_type):
    rng = np.random.default_rng(color_type * 5 + filter_type)
    channels = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[color_type]
    palette = rng.integers(0, 256, (16, 3), np.uint8) if color_type == 3 else None
    high = 16 if color_type == 3 else 256
    pixels = rng.integers(0, high, (13, 21, channels), np.uint8)
    data = _png(pixels, color_type, filter_type, palette)
    np.testing.assert_array_equal(native.png_decode(data), _cv2_decode(data))


def test_png_from_cv2_and_the_golden_equal_cv2():
    from test_ref_parity import GOLD, SEP, _assert_image_close

    images = np.load(GOLD / "images.npz")
    png = images[f"png{SEP}in"].tobytes()
    np.testing.assert_array_equal(port_ep.decode_image(png), _cv2_decode(png))
    decode = port_ep.make_image_decoder((224, 224), primary_image_key="base", wrist_image_key="wrist")
    out = decode({"observation": {"base": png, "wrist": png}})
    _assert_image_close(out["observation"]["base"], images[f"png{SEP}out"], (96, 128))
    for level in (0, 9):
        ok, buf = cv2.imencode(".png", _frame(33, 47)[..., ::-1], [cv2.IMWRITE_PNG_COMPRESSION, level])
        np.testing.assert_array_equal(native.png_decode(buf.tobytes()), _cv2_decode(buf.tobytes()))


def test_decode_image_equals_jax_on_both_formats():
    rgb = _frame(48, 64)
    for data in (_cv2_jpeg(rgb), jax_ep.encode_jpeg(rgb), port_ep.encode_jpeg(rgb), cv2.imencode(".png", rgb)[1].tobytes()):
        np.testing.assert_array_equal(port_ep.decode_image(data), jax_ep.decode_image(data))
    already = np.zeros((4, 4, 3), np.uint8)
    assert port_ep.decode_image(already) is already


def test_codec_raises_without_the_library(monkeypatch):
    """No fallback to cv2 or to Python: the codec needs the native library."""
    monkeypatch.setattr(native, "get_lib", lambda: None)
    data = _cv2_jpeg(_frame(8, 8))
    for fn, arg in ((native.jpeg_decode, data), (native.jpeg_encode, _frame(8, 8)),
                    (port_ep.decode_image, data), (image.resize_with_pad_np, _frame(8, 8))):
        with pytest.raises(RuntimeError, match="unavailable"):
            fn(arg) if fn is not image.resize_with_pad_np else fn(arg, 4, 4)


@pytest.mark.parametrize("shape", [(256, 256), (480, 640), (31, 57), (64, 48), (100, 224), (448, 448), (2, 3),
                                   (600, 7), (720, 1280)], ids=lambda s: f"{s[0]}x{s[1]}")
def test_resize_equals_cv2(shape):
    rgb = np.random.default_rng(shape[0] * 7 + shape[1]).integers(0, 256, (*shape, 3), np.uint8)
    for height, width in ((224, 224), (96, 128), (56, 56)):
        rh, rw = image.resized_geometry(*shape, height, width)
        if shape == (height, width) or 0 in (rh, rw):
            continue
        want = np.zeros((height, width, 3), np.uint8)
        y0, x0 = (height - rh) // 2, (width - rw) // 2
        want[y0 : y0 + rh, x0 : x0 + rw] = cv2.resize(rgb, (rw, rh), interpolation=cv2.INTER_LINEAR).reshape(rh, rw, 3)
        np.testing.assert_array_equal(image.resize_with_pad_np(rgb, height, width), want)
    batch = np.stack([rgb, rgb[::-1]])
    np.testing.assert_array_equal(image.resize_with_pad_np(batch, 56, 56)[1], image.resize_with_pad_np(rgb[::-1], 56, 56))


def test_resize_takes_uint8_images_only():
    with pytest.raises(TypeError, match="uint8"):
        image.resize_with_pad_np(np.zeros((8, 8, 3), np.float32), 4, 4)

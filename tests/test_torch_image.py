"""The port's host image library (``data/image.py``) against OpenCV, which
the JAX package calls for the same work: the JPEG decoder byte for byte
against ``cv2.imread`` on files ``cv2.imwrite`` writes (every sampling,
qualities 50/85/95, restart intervals, odd sizes, grey) and on the JAX
writer's ``image_detail`` files; its refusals; the encoder read back the
same by both decoders; ``convert_maps`` + ``remap_linear`` against
``cv2.convertMaps`` + ``cv2.remap`` over every fractional position and maps
that leave the image; the HSV pair against ``cv2.cvtColor`` on all 2^24
inputs (with the one stated difference, OpenCV's own scalar row tail);
``lut`` and ``resize_linear`` against ``cv2.LUT`` and ``cv2.resize``."""
import os

import cv2
import numpy as np
import pytest

from mm_training_tpu.data.synthetic import generate_synthetic_dataset as j_generate
from mm_training_tpu_torch.data import image

SAMPLING = {'444': cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444,
            '422': cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
            '420': cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420}
SIZES = [(64, 128), (37, 53), (1, 1), (2, 3), (17, 9), (5, 33), (88, 160)]


def _photo(h, w, seed):
    """The JAX writer's detail image: smooth colour upsampled, then noise."""
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 255, (max(h // 8, 2), max(w // 8, 2), 3), dtype=np.uint8)
    img = cv2.resize(img, (w, h), interpolation=cv2.INTER_LINEAR)
    noise = rng.integers(-10, 10, (h, w, 3), dtype=np.int16)
    return np.clip(img.astype(np.int16) + noise, 0, 255).astype(np.uint8)


def _all_pixels():
    """Every uint8 triple once, as a 4096 x 4096 image (rows a whole number
    of OpenCV's vector blocks)."""
    a = np.arange(1 << 24, dtype=np.uint32)
    return np.stack([(a >> 16) & 255, (a >> 8) & 255, a & 255], -1).astype(
        np.uint8).reshape(4096, 4096, 3)


# ----------------------------------------------------------------- decoder

@pytest.mark.parametrize('rst', [0, 3])
@pytest.mark.parametrize('quality', [50, 85, 95])
@pytest.mark.parametrize('sampling', list(SAMPLING))
def test_decode_equals_cv2(tmp_path, sampling, quality, rst):
    """Every size, the odd ones' partial MCUs and one-pixel images included,
    at one sampling, quality and restart interval: the same bytes as
    cv2.imread."""
    for i, (h, w) in enumerate(SIZES):
        path = str(tmp_path / f'{i}.jpg')
        params = [cv2.IMWRITE_JPEG_QUALITY, quality,
                  cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING[sampling]]
        if rst:
            params += [cv2.IMWRITE_JPEG_RST_INTERVAL, rst]
        assert cv2.imwrite(path, _photo(h, w, i), params)
        want = cv2.imread(path)
        got = image.imread(path)
        assert got.dtype == np.uint8 and got.shape == want.shape, (h, w)
        assert got.tobytes() == want.tobytes(), (h, w)


@pytest.mark.parametrize('quality', [50, 95])
def test_decode_grey_equals_cv2(tmp_path, quality):
    """A one-component file decodes to its grey replicated to BGR."""
    for i, (h, w) in enumerate(SIZES):
        path = str(tmp_path / f'{i}.jpg')
        cv2.imwrite(path, cv2.cvtColor(_photo(h, w, i), cv2.COLOR_BGR2GRAY),
                    [cv2.IMWRITE_JPEG_QUALITY, quality])
        got = image.imread(path)
        assert got.tobytes() == cv2.imread(path).tobytes(), (h, w)
        assert (got[..., 0] == got[..., 2]).all()


@pytest.mark.parametrize('detail', [False, True])
def test_decode_jax_writer_images(tmp_path, detail):
    """The JAX writer's camera JPEGs (quality 95, and 85 with detail, at the
    full 704 x 1280) read to cv2.imread's bytes."""
    j_generate(str(tmp_path), splits=('train',), frames_per_sequence=1, n_objects=1,
               n_ground_points=10, image_detail=detail, seed=3)
    files = [os.path.join(d, f) for d, _, fs in os.walk(tmp_path) for f in fs
             if f.endswith('.jpg')]
    assert len(files) == 2
    for f in files:
        want = cv2.imread(f)
        assert want.shape == (704, 1280, 3)
        assert image.imread(f).tobytes() == want.tobytes()


def _patched(src, dst, old: bytes, new: bytes):
    data = open(src, 'rb').read()
    assert old in data
    with open(dst, 'wb') as f:
        f.write(data.replace(old, new, 1))


def _exif_app1(orientation: int) -> bytes:
    tiff = (b'II*\x00' + (8).to_bytes(4, 'little') + (1).to_bytes(2, 'little')
            + (0x0112).to_bytes(2, 'little') + (3).to_bytes(2, 'little')
            + (1).to_bytes(4, 'little') + orientation.to_bytes(2, 'little') + b'\x00\x00'
            + (0).to_bytes(4, 'little'))
    body = b'Exif\x00\x00' + tiff
    return b'\xff\xe1' + (len(body) + 2).to_bytes(2, 'big') + body


def test_refusals_name_the_file_and_feature(tmp_path):
    """What the decoder cannot decode as cv2 does raises ValueError naming
    the file and the feature: progressive, arithmetic-coded, 12-bit, an EXIF
    orientation cv2 would apply (orientation 1 reads as cv2 reads it); a
    missing file raises FileNotFoundError."""
    img = _photo(24, 40, 0)
    base = str(tmp_path / 'base.jpg')
    cv2.imwrite(base, img, [cv2.IMWRITE_JPEG_QUALITY, 90])
    prog = str(tmp_path / 'prog.jpg')
    cv2.imwrite(prog, img, [cv2.IMWRITE_JPEG_PROGRESSIVE, 1])
    with pytest.raises(ValueError, match='prog.jpg: progressive'):
        image.imread(prog)
    sof = b'\xff\xc0\x00\x11\x08'
    for name, new, feature in (('arith.jpg', b'\xff\xc9\x00\x11\x08', 'arithmetic'),
                               ('twelve.jpg', b'\xff\xc0\x00\x11\x0c', '12-')):
        _patched(base, str(tmp_path / name), sof, new)
        with pytest.raises(ValueError, match=f'{name}: .*{feature}'):
            image.imread(str(tmp_path / name))
    data = open(base, 'rb').read()
    for orientation in (1, 6):
        path = str(tmp_path / f'exif{orientation}.jpg')
        with open(path, 'wb') as f:
            f.write(data[:2] + _exif_app1(orientation) + data[2:])
        if orientation == 1:
            assert image.imread(path).tobytes() == cv2.imread(path).tobytes()
        else:
            assert cv2.imread(path).shape == (40, 24, 3)     # cv2 rotates it
            with pytest.raises(ValueError, match=f'exif{orientation}.jpg: EXIF orientation'):
                image.imread(path)
    with pytest.raises(FileNotFoundError):
        image.imread(str(tmp_path / 'missing.jpg'))
    with pytest.raises(ValueError, match='not a JPEG'):
        image.decode_jpeg(b'\x89PNG\r\n\x1a\n' + bytes(64), 'x.png')


# ----------------------------------------------------------------- encoder

@pytest.mark.parametrize('quality', [50, 85, 95])
def test_encoder_files_read_the_same_by_cv2(tmp_path, quality):
    """The port's encoder: cv2.imread and the port's imread read its files to
    the same bytes, no further from the source than cv2.imwrite's own file
    at that quality (2% slack: the forward DCTs differ) on images of 1000
    pixels or more; its quantization
    and Huffman tables are the ones cv2.imwrite writes."""
    for i, (h, w) in enumerate(SIZES):
        src = _photo(h, w, 10 + i)
        path, ref = str(tmp_path / f'{i}.jpg'), str(tmp_path / f'{i}_cv.jpg')
        image.imwrite_jpeg(path, src, quality)
        want = cv2.imread(path)
        got = image.imread(path)
        assert got.shape == src.shape and got.tobytes() == want.tobytes(), (h, w)
        if h * w >= 1000:     # tiny images: the chroma edge padding differs
            cv2.imwrite(ref, src, [cv2.IMWRITE_JPEG_QUALITY, quality])
            err = np.abs(got.astype(int) - src).mean()
            assert err <= 1.02 * np.abs(cv2.imread(ref).astype(int) - src).mean(), (h, w)

    def tables(path):
        data, out, i = open(path, 'rb').read(), [], 2
        while data[i + 1] != 0xDA:
            n = int.from_bytes(data[i + 2:i + 4], 'big')
            if data[i + 1] in (0xDB, 0xC4):
                out.append(data[i:i + 2 + n])
            i += 2 + n
        return sorted(out)
    cv2.imwrite(str(tmp_path / 'cv.jpg'), _photo(32, 32, 0), [cv2.IMWRITE_JPEG_QUALITY, quality])
    assert tables(str(tmp_path / 'cv.jpg')) == tables(str(tmp_path / '0.jpg'))


# ------------------------------------------------------------------- remap

def test_convert_maps_equals_cv2():
    """Every fractional position of INTER_TAB_SIZE 32, ties at half a
    fraction (rounded to even), negative and far-out coordinates."""
    frac = (np.arange(1024) % 32) / 32.0 + 0.25 / 32
    mx = np.concatenate([10 + frac, np.arange(-64, 64) / 64.0, [-1e4, 3e4, -0.5 / 32]])
    my = np.concatenate([10 + (np.arange(1024) // 32) / 32.0, np.arange(64, -64, -1) / 64.0,
                         [-1e4, 5.0, 2.5 / 32]])
    mx, my = (np.resize(m.astype(np.float32), (23, 51)) for m in (mx, my))
    want = cv2.convertMaps(mx, my, cv2.CV_16SC2)
    got = image.convert_maps(mx, my)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


@pytest.mark.parametrize('channels', [3, 1])
def test_remap_equals_cv2(channels):
    """cv2.remap(INTER_LINEAR) with a zero border on every fractional
    position, on maps that leave the image on each side, and on the -1e4
    of an invalid ray."""
    rng = np.random.default_rng(7)
    src = rng.integers(0, 256, (50, 70, channels), dtype=np.uint8)
    mx = rng.uniform(-3, 73, (64, 96)).astype(np.float32)
    my = rng.uniform(-3, 53, (64, 96)).astype(np.float32)
    mx[:16, :64].flat[:] = 20 + (np.arange(1024) % 32) / 32.0
    my[:16, :64].flat[:] = 20 + (np.arange(1024) // 32) / 32.0
    mx[20:24] = np.linspace(-1.5, 70.5, 96)               # across both edges
    my[24:28] = np.linspace(-1.5, 50.5, 96)
    mx[::7, ::5] = -1e4
    m1, m2 = cv2.convertMaps(mx, my, cv2.CV_16SC2)
    want = cv2.remap(src, m1, m2, cv2.INTER_LINEAR)
    got = image.remap_linear(src[..., 0] if channels == 1 else src, *image.convert_maps(mx, my))
    assert got.shape == (64, 96, channels)
    assert got.tobytes() == want.reshape(got.shape).tobytes()


# --------------------------------------------------------------------- HSV

def test_bgr_to_hsv_equals_cv2_on_every_input():
    px = _all_pixels()
    assert image.bgr_to_hsv(px).tobytes() == cv2.cvtColor(px, cv2.COLOR_BGR2HSV).tobytes()


def test_hsv_to_bgr_equals_cv2_on_every_input():
    """Byte-equal to OpenCV's vector path on all 2^24 inputs. The stated
    difference: OpenCV computes a row's last width % (4 x float lanes)
    pixels in a scalar path that rounds where its vector path truncates;
    there (rows one pixel wide) 12,395,370 of the 2^24 inputs differ, each
    by 1. The data path's widths (1280; 128 in the tiny configs) are whole
    vector blocks."""
    px = _all_pixels()
    got = image.hsv_to_bgr(px)
    assert got.tobytes() == cv2.cvtColor(px, cv2.COLOR_HSV2BGR).tobytes()
    tail = cv2.cvtColor(px.reshape(-1, 1, 3), cv2.COLOR_HSV2BGR).reshape(px.shape)
    diff = np.abs(tail.astype(np.int16) - got.astype(np.int16)).max(-1)
    assert int((diff > 0).sum()) == 12_395_370 and int(diff.max()) == 1


@pytest.mark.parametrize('width', [128, 1280])
def test_hsv_round_trip_equals_cv2_at_the_path_widths(width):
    rng = np.random.default_rng(width)
    img = rng.integers(0, 256, (16, width, 3), dtype=np.uint8)
    hsv = image.bgr_to_hsv(img)
    assert hsv.tobytes() == cv2.cvtColor(img, cv2.COLOR_BGR2HSV).tobytes()
    assert (image.hsv_to_bgr(hsv).tobytes()
            == cv2.cvtColor(hsv, cv2.COLOR_HSV2BGR).tobytes())


# -------------------------------------------------------------- LUT, resize

@pytest.mark.parametrize('shape', [(256,), (256, 3), (1, 256, 3)])
def test_lut_equals_cv2(shape):
    rng = np.random.default_rng(len(shape))
    img = rng.integers(0, 256, (33, 47, 3), dtype=np.uint8)
    table = rng.integers(0, 256, shape, dtype=np.uint8)
    want = cv2.LUT(img, table.reshape(1, 256, 3) if table.ndim == 2 else table)
    assert image.lut(img, table).tobytes() == want.tobytes()


@pytest.mark.parametrize('src_hw,dst_hw', [((88, 160), (704, 1280)), ((8, 16), (64, 128)),
                                           ((5, 7), (37, 53)), ((3, 3), (10, 11)),
                                           ((50, 70), (20, 30)), ((1, 9), (4, 40))])
def test_resize_equals_cv2(src_hw, dst_hw):
    """Upsampling (the writer's 8x), odd factors, and downsampling; rows
    outside the source keep their unclamped weights as in resize.cpp."""
    rng = np.random.default_rng(sum(src_hw))
    src = rng.integers(0, 256, src_hw + (3,), dtype=np.uint8)
    want = cv2.resize(src, dst_hw[::-1], interpolation=cv2.INTER_LINEAR)
    assert image.resize_linear(src, *dst_hw).tobytes() == want.tobytes()

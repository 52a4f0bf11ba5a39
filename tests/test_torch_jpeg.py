"""The port's host codecs against Pillow (the oracle here; the GPU machine
has no Pillow): the JPEG decoder and encoder (presight_tpu_torch/native/
jpeg.cpp), the LANCZOS resize and the PNG mask reader
(presight_tpu_torch/data/image_metadata.py).

Tolerance: none. Decoded pixels, resized pixels and mask values are
identical to Pillow's (also when 8 threads decode at once), and the
encoder's files are identical to the bytes Pillow's Image.save writes by
default (quality 75, 4:2:0), the one mode the encoder has.
"""

import io
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from make_jpeg_goldens import CASES, OUT as GOLDENS, image
from presight_tpu_torch.data.image_metadata import lanczos_resize, read_png
from presight_tpu_torch.native import jpeg

SIZES = [(45, 80), (17, 33), (225, 400)]
SUBSAMPLING = {0: "444", 1: "422", 2: "420"}


def _pil_jpeg(pixels: np.ndarray, **kwargs) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(pixels).save(buf, format="JPEG", **kwargs)
    return buf.getvalue()


def _pil_pixels(data: bytes) -> np.ndarray:
    return np.asarray(Image.open(io.BytesIO(data)))


@pytest.mark.parametrize("subsampling", list(SUBSAMPLING), ids=list(SUBSAMPLING.values()))
@pytest.mark.parametrize("size", SIZES, ids=[f"{h}x{w}" for h, w in SIZES])
def test_decode_equals_pillow(size, subsampling):
    """Quality 50, 75 and 95, Huffman tables optimised or standard, with and
    without restart intervals."""
    pixels = image(*size, seed=size[0] + subsampling)
    for quality in (50, 75, 95):
        for optimize in (False, True):
            for restart in ({}, {"restart_marker_blocks": 3}, {"restart_marker_rows": 1}):
                data = _pil_jpeg(pixels, quality=quality, subsampling=subsampling,
                                 optimize=optimize, **restart)
                assert (b"\xff\xdd" in data) == bool(restart)
                np.testing.assert_array_equal(jpeg.decode(data), _pil_pixels(data),
                                              err_msg=f"q{quality} optimize={optimize} {restart}")


@pytest.mark.parametrize("size", SIZES, ids=[f"{h}x{w}" for h, w in SIZES])
def test_decode_greyscale_equals_pillow(size):
    grey = image(*size, seed=1)[..., 1]
    for quality in (50, 95):
        data = _pil_jpeg(grey, quality=quality)
        got = jpeg.decode(data)
        assert got.shape == size
        np.testing.assert_array_equal(got, _pil_pixels(data))


@pytest.mark.parametrize("name", list(CASES))
def test_decode_checked_in_goldens(name):
    """The goldens chip_smoke.py decodes on the GPU machine."""
    want = np.load(GOLDENS / "pixels.npz")[name]
    np.testing.assert_array_equal(jpeg.decode(GOLDENS / f"{name}.jpg"), want)


@pytest.mark.parametrize("size", SIZES + [(1, 1), (9, 5)],
                         ids=[f"{h}x{w}" for h, w in SIZES + [(1, 1), (9, 5)]])
def test_encode_equals_pillow_save(size):
    """Image.save with Pillow's defaults (quality 75, 4:2:0) and the port's
    encode(): the same bytes, hence the same decoded pixels."""
    pixels = image(*size, seed=7)
    ours, theirs = jpeg.encode(pixels), _pil_jpeg(pixels)
    np.testing.assert_array_equal(_pil_pixels(ours), _pil_pixels(theirs))
    assert ours == theirs


_THREADED_DECODE = """
import sys, threading
from pathlib import Path
import numpy as np
from presight_tpu_torch.native import jpeg

goldens, names, out = Path(sys.argv[1]), sys.argv[2].split(","), sys.argv[3]
files = [(goldens / f"{names[i % len(names)]}.jpg").read_bytes() for i in range(8)]
jpeg.lib()  # load the library first: only the decodes start together
start, got = threading.Barrier(8), [None] * 8

def run(i):
    start.wait()
    got[i] = jpeg.decode(files[i])

threads = [threading.Thread(target=run, args=(i,)) for i in range(8)]
for t in threads:
    t.start()
for t in threads:
    t.join()
np.savez(out, **{f"{names[i % len(names)]}-{i}": g for i, g in enumerate(got)})
"""

COLOUR = [name for name in CASES if not CASES[name][3]]


@pytest.fixture(scope="module")
def threaded_decodes(tmp_path_factory):
    """The colour goldens decoded by 8 threads that start together in a
    fresh process, so that the first colour decodes of the process (which
    build the YCbCr->RGB tables) run at once."""
    out = tmp_path_factory.mktemp("threads") / "decoded.npz"
    subprocess.run([sys.executable, "-c", _THREADED_DECODE, str(GOLDENS), ",".join(COLOUR),
                    str(out)], check=True, cwd=Path(__file__).resolve().parents[1])
    return np.load(out)


@pytest.mark.parametrize("name", COLOUR)
def test_decode_from_threads_equals_goldens(threaded_decodes, name):
    want = np.load(GOLDENS / "pixels.npz")[name]
    got = [threaded_decodes[k] for k in threaded_decodes.files if k.rsplit("-", 1)[0] == name]
    assert len(got) == 2
    for g in got:
        np.testing.assert_array_equal(g, want)


def test_progressive_and_bad_files_raise():
    pixels = image(17, 33, seed=0)
    with pytest.raises(ValueError, match="progressive"):
        jpeg.decode(_pil_jpeg(pixels, progressive=True))
    with pytest.raises(ValueError, match="not a JPEG"):
        jpeg.decode(b"\x89PNG\r\n\x1a\n" + bytes(32))
    with pytest.raises(ValueError):
        jpeg.decode(_pil_jpeg(pixels)[:200])


@pytest.mark.parametrize("src,dst", [((45, 80), (20, 37)), ((45, 80), (90, 160)),
                                     ((17, 33), (45, 80)), ((225, 400), (113, 199))],
                         ids=["down", "up", "up-odd", "down-odd"])
def test_lanczos_resize_equals_pillow(src, dst):
    pixels = (np.random.RandomState(src[0]).rand(*src, 3) * 255).astype(np.uint8)
    want = np.asarray(Image.fromarray(pixels).resize((dst[1], dst[0]), Image.LANCZOS))
    np.testing.assert_array_equal(lanczos_resize(pixels, dst[1], dst[0]), want)


@pytest.mark.parametrize("mode", ["L", "RGB", "P"])
def test_png_mask_equals_pillow(mode, tmp_path):
    pixels = (np.random.RandomState(0).rand(37, 53, 3) * 255).astype(np.uint8)
    pixels[:9] = 0
    img = Image.fromarray(pixels)
    img = img if mode == "RGB" else img.convert(mode)
    for optimize in (False, True):
        path = tmp_path / f"m{optimize}.png"
        img.save(path, optimize=optimize)
        np.testing.assert_array_equal(read_png(path), np.asarray(Image.open(path)))


def test_png_other_formats_raise(tmp_path):
    path = tmp_path / "rgba.png"
    Image.fromarray(np.zeros((4, 4, 4), np.uint8)).save(path)
    with pytest.raises(ValueError, match="8-bit non-interlaced"):
        read_png(path)

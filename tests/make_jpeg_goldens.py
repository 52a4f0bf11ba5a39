"""Write the JPEG goldens under tests/goldens/jpeg/ with Pillow.

    python tests/make_jpeg_goldens.py

Each case is a JPEG file written by Pillow from a seeded image and the
pixels Pillow decodes from it (``np.asarray(Image.open(path))``), all in
``pixels.npz``. The port's codec (presight_tpu_torch/native/jpeg.py) must
decode every file to exactly those pixels: tests/test_torch_jpeg.py holds
it to them on the CPU and chip_smoke.py on the GPU machine's host, which
has no Pillow.
"""

from pathlib import Path

import numpy as np
from PIL import Image

OUT = Path(__file__).resolve().parent / "goldens" / "jpeg"

# name -> (height, width, Image.save arguments, greyscale)
CASES = {
    "q75_420_45x80": (45, 80, {}, False),
    "q95_422_rst_17x33": (17, 33, dict(quality=95, subsampling=1, restart_marker_blocks=2), False),
    "q50_444_opt_225x400": (225, 400, dict(quality=50, subsampling=0, optimize=True), False),
    "q75_420_rst_opt_225x400": (225, 400, dict(restart_marker_rows=1, optimize=True), False),
    "q90_grey_45x80": (45, 80, dict(quality=90), True),
}


def image(h: int, w: int, seed: int) -> np.ndarray:
    """Smooth gradients with noise, as camera images have both."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.stack([0.5 + 0.4 * np.sin(xx / w * 3), 0.5 + 0.4 * np.cos(yy / h * 2),
                    0.4 + 0.3 * np.sin((xx + yy) / (w + h) * 4)], -1)
    img += rng.randn(h, w, 3).astype(np.float32) * 0.08
    return (np.clip(img, 0, 1) * 255).astype(np.uint8)


def main() -> None:
    OUT.mkdir(parents=True, exist_ok=True)
    pixels = {}
    for i, (name, (h, w, kwargs, grey)) in enumerate(CASES.items()):
        img = Image.fromarray(image(h, w, i))
        if grey:
            img = img.convert("L")
        path = OUT / f"{name}.jpg"
        img.save(path, **kwargs)
        pixels[name] = np.asarray(Image.open(path))
    np.savez_compressed(OUT / "pixels.npz", **pixels)


if __name__ == "__main__":
    main()

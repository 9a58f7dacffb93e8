"""Image encoding, AVIF (reference parity) and PNG: the native encoder
first, then Pillow, in the JAX package's order.

The reference encodes AVIF with quality 100, speed 8, YCbCr 4:4:4
(src/lib.rs:326-333) and appends the suffix unconditionally
(src/lib.rs:192-195).
"""

from __future__ import annotations

import numpy as np

from fractal_tpu_torch.io import native

AVIF_QUALITY = 100
AVIF_SPEED = 8
AVIF_SUBSAMPLING = "4:4:4"
AVIF_RANGE = "full"


def output_filename(name: str, fmt: str = "avif") -> str:
    """``format!("{}.avif", f)``: "output" → "output.avif"."""
    return f"{name}.{fmt}"


def _to_pil(img: np.ndarray):
    from PIL import Image

    img = np.ascontiguousarray(img)
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"expected (H, W, 3) uint8, got {img.shape} {img.dtype}")
    return Image.fromarray(img, mode="RGB")


def encode_image(img: np.ndarray, path: str) -> None:
    """Encode (H, W, 3) uint8 to ``path``; the format follows the extension."""
    lower = path.lower()
    if lower.endswith(".png"):
        if native.available():
            native.write_png(img, path)
            return
        _to_pil(img).save(path, format="PNG")
    elif lower.endswith(".avif"):
        if native.avif_available():
            native.write_avif(img, path, quality=AVIF_QUALITY, speed=AVIF_SPEED)
            return
        _to_pil(img).save(path, format="AVIF", quality=AVIF_QUALITY,
                          speed=AVIF_SPEED, subsampling=AVIF_SUBSAMPLING,
                          range=AVIF_RANGE)
    else:
        _to_pil(img).save(path)


def write_image(img: np.ndarray, name: str, fmt: str = "avif",
                verbose: bool = True) -> str:
    """The reference's write path (src/lib.rs:245-251, 324-344) with its
    progress prints."""
    path = output_filename(name, fmt)
    if verbose:
        print("Starting encode.")
    encode_image(img, path)
    if verbose:
        print(f'Finished encode. Writing file "{path}".')
    return path

"""Image I/O (port of ``io/images.py``): PNG and other LDR images through
PIL, EXR, MERL and meshes through the port's host library (``native/``).
"""

from __future__ import annotations

import numpy as np

from vrenderer_pathtracer_tpu_torch.native import (  # noqa: F401  (re-exports)
    load_exr,
    load_fbx,
    load_merl,
    load_mesh_file,
    load_obj,
    load_ply,
    write_exr,
)


def load_image(path) -> np.ndarray:
    """An LDR image as [H,W,3] float32 in [0, 1], with no gamma handling
    (the Renderer linearises diffuse maps at load)."""
    from PIL import Image

    return np.asarray(Image.open(path).convert("RGB"), np.float32) / 255.0


def save_png(path, img01, flip_y: bool = True) -> None:
    """[H,W,3] floats in [0, 1] as an 8-bit PNG; ``flip_y`` turns the
    renderer's bottom-up rows into image order."""
    from PIL import Image

    arr = np.asarray(img01)
    if flip_y:
        arr = arr[::-1]
    arr = (np.clip(arr, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
    Image.fromarray(arr).save(path)


def save_depth_png(path, depth, flip_y: bool = True) -> None:
    """The depth channel as the reference shows it: (1 - depth) grey."""
    d = np.asarray(depth)
    save_png(path, np.repeat((1.0 - d)[..., None], 3, axis=-1), flip_y=flip_y)

"""Asset and image I/O of the port (``io/images.py``)."""

from vrenderer_pathtracer_tpu_torch.io.images import (
    load_exr,
    load_fbx,
    load_image,
    load_merl,
    load_mesh_file,
    load_obj,
    load_ply,
    save_depth_png,
    save_png,
    write_exr,
)

__all__ = [
    "load_exr", "load_fbx", "load_image", "load_merl", "load_mesh_file",
    "load_obj", "load_ply", "save_depth_png", "save_png", "write_exr",
]

from mpsnerf_torch.native.bindings import (
    export_obj,
    extract_isosurface,
    load_obj,
    rasterize_mesh,
)

__all__ = ["extract_isosurface", "rasterize_mesh", "export_obj", "load_obj"]

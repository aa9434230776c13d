"""Serving of the port: bundles (weights + factory config) and a stdlib
HTTP front-end with the JAX server's wire protocol.

See :mod:`mpsnerf_torch.serve.bundle` for the bundle and
:mod:`mpsnerf_torch.serve.server` for the routes.
"""

from mpsnerf_torch.serve.bundle import (
    ServedRenderer,
    export_serving_bundle,
    load_serving_bundle,
)

__all__ = ["ServedRenderer", "export_serving_bundle", "load_serving_bundle"]

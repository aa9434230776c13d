"""The device time of LayerNorm's kernels per profiled view, ms: torch's
(its row moments and its forward, vectorised or not) and the port's own
(``mpsnerf_torch/csrc/layer_norm.cu``), by kernel name in the trace."""

from benchmark.harness.trace import kernel_seconds

LAYER_NORM_KERNELS = ("RowwiseMomentsCUDAKernel", "LayerNormForwardCUDAKernel",
                      "vectorized_layer_norm_kernel", "layer_norm_rows",
                      "layer_norm_wide")


def read(run):
    secs = kernel_seconds(run.trace, LAYER_NORM_KERNELS)
    if not secs or run.profiled_units <= 0:
        return None
    return 1e3 * sum(secs) / run.profiled_units

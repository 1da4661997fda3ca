"""Timing and throughput bookkeeping, and the debug guards."""

from vrenderer_pathtracer_tpu_torch.utils.profiling import (
    RenderStats,
    measure_renderer,
    profiler_trace,
    timeit,
)

__all__ = ["RenderStats", "measure_renderer", "profiler_trace", "timeit"]

from vrenderer_pathtracer_tpu_torch.utils.debug import (  # noqa: E402
    assert_finite_tree,
    checked,
    interpret_kernels,
)

__all__ += ["assert_finite_tree", "checked", "interpret_kernels"]

"""Timing and throughput bookkeeping, and the debug guards."""

from vrenderer_pathtracer_tpu_torch.utils.debug import (
    assert_finite_tree,
    checked,
    interpret_kernels,
)

__all__ = ["assert_finite_tree", "checked", "interpret_kernels"]

"""Device milliseconds a step of the kernels behind the trained tables'
gradients: the sort-based accumulate that the backward of a gather from a
table (``table[:, idx]`` in ``ops/brdf.py::lookup_brdf``, ``hdr[idx]`` in
``ops/envmap.py``) runs, over the traced window, taken a step.

Matched by the names the profiler gives them on the card (PyTorch 2.11,
CUDA 12.8): PyTorch's ``index_put_with_sort_kernel`` path sorts the
indices with CUB's radix sort (``cub::DeviceRadixSortHistogramKernel``,
``DeviceRadixSortExclusiveSumKernel``, ``DeviceRadixSortOnesweepKernel``)
and accumulates each run of equal indices
(``indexing_backward_kernel_stride_1``,
``indexing_backward_kernel_small_stride``).  No other kernel of the step
sorts or accumulates by index.
"""

import re

TABLE_GRAD = re.compile(r"indexing_backward_kernel|RadixSort")


def read(run):
    steps = run.state.get("steps")
    if not steps or run.trace is None or not run.trace.ops:
        return None
    ops = run.trace.named(lambda n: TABLE_GRAD.search(n) is not None)
    if not ops:
        return None
    return sum(b - a for _, a, b in ops) / steps * 1e3

"""Numerical guards and the sanitizer build (port of ``utils/debug.py``).

The JAX module guards the shading path with ``checkify`` and runs its
Pallas kernels in interpret mode as its "sanitizer build".  Here:

* :func:`checked` — a wrapper that raises on a NaN or inf in any tensor
  the wrapped function returns (a debug tool: it reads the outputs back,
  so it never belongs on the main path);
* :func:`assert_finite_tree` — the host-side check of a tree of tensors,
  naming the leaf that holds non-finite values;
* :func:`interpret_kernels` — the sanitizer build: the plain PyTorch
  versions of the kernels, which run on CPU tensors (``device="cpu"``,
  ``--cpu``).  Inside the block ``scene.settings_for_scene`` refuses a
  CUDA scene, since on the card every path runs its hand-written kernels
  and none of them gives way to a plain version.
"""

from __future__ import annotations

import contextlib
import contextvars
import functools

from vrenderer_pathtracer_tpu_torch.utils.tree import tensor_leaves

_INTERPRET = contextvars.ContextVar("interpret_kernels", default=False)


def _first_non_finite(tree):
    for path, leaf in tensor_leaves(tree):
        if leaf.is_floating_point():
            bad = int((~leaf.detach().isfinite()).sum())
            if bad:
                return path, bad
    return None


def checked(fn):
    """Wrap ``fn`` so that it raises ``FloatingPointError`` when any tensor
    it returns holds a NaN or an inf (the first such leaf is named).

        step = checked(render_pass)
        rgb, depth = step(scene, settings, ...)
    """
    @functools.wraps(fn)
    def wrapped(*args, **kw):
        out = fn(*args, **kw)
        found = _first_non_finite(out)
        if found is not None:
            name = getattr(fn, "__name__", "fn")
            raise FloatingPointError(
                f"{name} returned {found[1]} non-finite values at "
                f"output{found[0]}")
        return out

    return wrapped


@contextlib.contextmanager
def interpret_kernels():
    """Run the plain PyTorch versions, on CPU tensors, inside the block: a
    CUDA scene is refused there (module docstring)."""
    token = _INTERPRET.set(True)
    try:
        yield
    finally:
        _INTERPRET.reset(token)


def interpreting() -> bool:
    """Whether the caller is inside :func:`interpret_kernels`."""
    return _INTERPRET.get()


def assert_finite_tree(tree, name: str = "tree") -> None:
    """Host-side finite check over a tree of tensors (post-hoc debugging):
    raises ``AssertionError`` naming the first leaf with non-finite
    values."""
    found = _first_non_finite(tree)
    if found is not None:
        raise AssertionError(f"{name}{found[0]}: {found[1]} non-finite values")

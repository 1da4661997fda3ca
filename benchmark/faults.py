"""Faults planted in the program's timed path, for showing that ``correct``
catches them (the tests, and ``controls.py`` on the card).

Each planter takes ``patch(obj, name, value)`` (``monkeypatch.setattr``,
or :func:`patcher`'s) and breaks the path under the benchmark: the loops
and the references are left as they are.
"""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def patcher():
    """A ``patch(obj, name, value)`` whose patches are undone on exit."""
    undo = []

    def patch(obj, name, value):
        undo.append((obj, name, getattr(obj, name)))
        setattr(obj, name, value)

    try:
        yield patch
    finally:
        for obj, name, value in reversed(undo):
            setattr(obj, name, value)


def state_unchanged(patch):
    """A pass that leaves the accumulation as it was; an optimiser step
    that leaves the parameters as they were."""
    from vrenderer_pathtracer_tpu_torch.render import renderer as R

    def unchanged(scene, camera, accum, frame, *a):
        return R.tonemap(accum, frame), torch.ones(accum.shape[0],
                                                   device=accum.device)
    patch(R, "_render_step", unchanged)
    patch(torch.optim.Adam, "step", lambda self, *a, **k: None)


def half_batch(patch):
    """Half of each pass's samples left out, the mean taken over the rest
    (renders and loss gradients alike)."""
    from vrenderer_pathtracer_tpu_torch.parallel import sharding
    from vrenderer_pathtracer_tpu_torch.render import renderer as R

    real_pass, real_loss = R.render_pass, sharding._train_loss

    def halve(settings):
        return settings.replace(
            samples_per_pass=max(1, settings.samples_per_pass // 2))

    patch(R, "render_pass",
          lambda scene, settings, *a, **k: real_pass(scene, halve(settings),
                                                     *a, **k))
    patch(sharding, "_train_loss",
          lambda params, scene, settings, *a, **k: real_loss(
              params, scene, halve(settings), *a, **k))


def answer_altered(patch):
    """Each displayed value 2/255 brighter; each loss half again as large
    (and so its gradients)."""
    from vrenderer_pathtracer_tpu_torch.parallel import sharding
    from vrenderer_pathtracer_tpu_torch.render import renderer as R

    real_tonemap, real_loss = R.tonemap, sharding._train_loss
    patch(R, "tonemap", lambda *a, **k: real_tonemap(*a, **k) + 2.0 / 255.0)
    patch(sharding, "_train_loss", lambda *a, **k: real_loss(*a, **k) * 1.5)


def exchange_left_out(patch):
    """The gather between ranks left out: every rank's frame holds its own
    band where the others' belong."""
    from vrenderer_pathtracer_tpu_torch.parallel import multihost

    def own(tile, mesh=None):
        import torch.distributed as dist

        n = dist.get_world_size() if dist.is_initialized() else 1
        return torch.cat([tile] * n)
    patch(multihost, "gather_image", own)


FAULTS = {"state_unchanged": state_unchanged, "half_batch": half_batch,
          "answer_altered": answer_altered,
          "exchange_left_out": exchange_left_out}

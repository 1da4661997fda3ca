"""Example scripts of the port (port of the repository's ``examples/``).

Each runs as ``python -m vrenderer_pathtracer_tpu_torch.examples.<name>``
and has ``main(argv=None)``, which returns its readings as a dict; each
runs on the card unless ``--cpu`` is given, and fails without one:

* ``inverse_rendering`` — recover sphere albedo, emission and the Fresnel
  sliders from a Cornell target through ``sharded_opt_step`` (K2);
* ``envmap_recovery`` — recover an HDRI through
  ``sharded_deferred_opt_step`` (K4's records and ``compose``);
* ``config5`` — BASELINE config 5: a paged mesh (K5), HDRI, MERL, FXAA and
  remat, then one gradient with respect to the MERL table and the HDRI;
* ``bench_paged`` — K5 on coherent, shuffled and sorted shuffled rays.
"""

from __future__ import annotations

import contextlib
import os
import tempfile

import torch
import torch.distributed as dist


def device_of(cpu: bool) -> torch.device:
    """The CPU when ``cpu``, else the current card; without a card that
    raises ``RuntimeError`` (nothing carries on quietly on the CPU)."""
    if cpu:
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available (pass --cpu to run "
                           "on the CPU)")
    return torch.device("cuda", torch.cuda.current_device())


@contextlib.contextmanager
def process_group(cpu: bool):
    """The process group of the sharded examples: ``torchrun``'s (its
    ``WORLD_SIZE`` and ``RANK``) when there is one, else a world-size-1
    group on a file store; NCCL on the card, gloo with ``cpu``.  Yields the
    world size; a group this context started is destroyed on exit."""
    from vrenderer_pathtracer_tpu_torch.parallel import multihost

    backend = "gloo" if cpu else None
    if dist.is_initialized():
        yield dist.get_world_size()
        return
    world = int(os.environ.get("WORLD_SIZE", "1"))
    with tempfile.TemporaryDirectory() as tmp:
        if world > 1:
            multihost.initialize(None, world, int(os.environ["RANK"]),
                                 backend=backend)
        else:
            multihost.initialize(f"file://{tmp}/store", 1, 0, backend=backend)
        try:
            yield world
        finally:
            dist.destroy_process_group()

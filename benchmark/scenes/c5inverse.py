"""The ``c5inverse`` configuration in the program: config 5's scene built
by ``scenes/c5.py::renderer`` (the ``Renderer`` and its loaders), each
view's target rendered with the true tables by the ``Renderer``'s pass, and
``deferred_opt_step`` with Adam over ``DeferredParams`` holding the HDRI
and the MERL table, started flat (``reference/c5inverse.py::start``).  On
the card the step runs the wavefront with K5, compact waves and remat, as
``settings_for_scene`` resolves them."""

from __future__ import annotations

from benchmark import harness
from benchmark.reference import c5inverse as ref
from benchmark.reference import views
from benchmark.scenes import c5


class Trainer:
    """The training object: the scene, the views' cameras and targets,
    the trained tables, Adam over them and the step."""

    def __init__(self, run):
        import torch

        from vrenderer_pathtracer_tpu_torch.parallel.sharding import (
            DeferredParams, deferred_opt_step)
        from vrenderer_pathtracer_tpu_torch.render.renderer import render_pass

        t, dev = run.traffic, run.device
        r = c5.renderer(run)
        self.scene, self.settings = r.scene, r.settings
        self.fc, self.fp = r.fresnel_coef, r.fresnel_pow
        self.cameras, self.targets = [], []
        with torch.no_grad():
            for k in range(t["n_views"]):
                c5.apply_view(run, r, views.spec(t["views"], run.seed, k))
                acc = None
                for frame in range(1, t["target_passes"] + 1):
                    rgb, _ = render_pass(self.scene, self.settings, r.camera,
                                         frame, self.fc, self.fp, run.seed)
                    acc = rgb if acc is None else acc + rgb
                self.cameras.append(r.camera)
                self.targets.append(acc / t["target_passes"])
        harness.note(run, "targets rendered")
        s0 = ref.start(run.cfg, run.seed)
        self.params = DeferredParams(
            hdr=torch.as_tensor(s0["hdr"], device=dev).requires_grad_(),
            brdf=torch.as_tensor(s0["brdf"], device=dev).requires_grad_())
        self.opt = torch.optim.Adam(self.params.leaves(), lr=t["lr"])
        self._step = deferred_opt_step(self.settings, self.opt,
                                       scene=self.scene, seed=run.seed,
                                       device=dev)

    def view_of(self, i: int) -> int:
        """The view of the loop's ``i``-th step (0-based): one in turn."""
        return i % len(self.cameras)

    def step(self, i: int, frame: int):
        k = self.view_of(i)
        self.params, metrics = self._step(self.params, self.scene,
                                          self.cameras[k], self.targets[k],
                                          frame, self.fc, self.fp)
        return metrics

    def leaves(self) -> list:
        """Copies of the tables [hdr, brdf], float32 on the host."""
        return [x.detach().float().cpu().clone() for x in self.params.leaves()]

    def grads(self) -> list:
        """Copies of the gradients the optimiser took in its last step."""
        return [x.grad.detach().float().cpu().clone()
                for x in self.params.leaves()]


trainer = Trainer

"""The ``cornell`` configuration in the program: the Cornell shells with
the mirror and Fresnel spheres, through the ``Renderer`` (K1 on the card)
or through ``opt_step`` with Adam (K2 on the card)."""

from __future__ import annotations

import numpy as np

from benchmark import program
from benchmark.reference import cornell as ref


def renderer(run):
    from vrenderer_pathtracer_tpu_torch import Renderer

    s = program.settings(run, use_cornell_box=True, has_hdr=False)
    r = Renderer(s.width, s.height, settings=s, seed=run.seed,
                 device=run.device, device_mesh=program.render_mesh(run))
    r.set_fresnel_coef(run.cfg["fresnel_coef"])
    r.set_fresnel_power(run.cfg["fresnel_pow"])
    return r


apply_view = program.apply_view


class Trainer:
    """The training object: the seeded true scene and its target, the
    trainable parameters, Adam over them, and the step of ``opt_step``."""

    def __init__(self, run):
        import torch

        from vrenderer_pathtracer_tpu_torch.core.camera import Camera
        from vrenderer_pathtracer_tpu_torch.parallel.sharding import TrainParams, opt_step
        from vrenderer_pathtracer_tpu_torch.render.renderer import render_pass
        from vrenderer_pathtracer_tpu_torch.scene.scene import Scene, settings_for_scene

        t, dev = run.traffic, run.device
        truth, start = ref.train_inputs(run.cfg, run.seed)
        f32 = dict(dtype=torch.float32, device=dev)
        s = program.settings(run, use_cornell_box=True, has_hdr=False)
        scene = Scene.analytic(s, dev)
        self.scene = scene.replace_spheres(
            color=torch.tensor(truth["color"], **f32),
            emission=torch.tensor(truth["emission"], **f32))
        self.camera = Camera.default(dev)
        resolved = settings_for_scene(self.scene, s)
        fc, fp = (torch.tensor(truth[k], **f32)
                  for k in ("fresnel_coef", "fresnel_pow"))
        acc = None
        for frame in range(1, t["target_passes"] + 1):
            rgb, _ = render_pass(self.scene, resolved, self.camera, frame, fc,
                                 fp, run.seed)
            acc = rgb if acc is None else acc + rgb
        self.target = acc / t["target_passes"]
        from benchmark import harness

        harness.note(run, "target rendered")
        self.params = TrainParams(**{k: torch.tensor(np.asarray(v), **f32)
                                     for k, v in start.items()})
        for leaf in self.params.leaves():
            leaf.requires_grad_()
        self.opt = torch.optim.Adam(self.params.leaves(), lr=t["lr"])
        self._step = opt_step(s, self.opt, seed=run.seed, device=dev)

    def step(self, frame: int):
        self.params, metrics = self._step(self.params, self.scene, self.camera,
                                          self.target, frame)
        return metrics

    def leaves(self) -> list:
        return [x.detach().double().cpu().numpy().copy()
                for x in self.params.leaves()]

    def first_grads(self) -> list:
        """The gradients as Adam took them in its first step, from its
        state: the first moment over (1 - beta1); zero for a leaf it has no
        state for (it never stepped)."""
        import torch

        b1 = self.opt.param_groups[0]["betas"][0]
        return [(self.opt.state[p].get("exp_avg", torch.zeros_like(p))
                 / (1 - b1)).double().cpu().numpy()
                for p in self.params.leaves()]


trainer = Trainer

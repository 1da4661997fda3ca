"""PyTorch port: FXAA (``ops/fxaa.py``) against the JAX package's ``fxaa``
on the same images, and the Renderer's FXAA toggle and sliders.

The two are the same float32 arithmetic in the same order on static
shifts, so the images agree to 1e-6.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from vrenderer_pathtracer_tpu.ops.fxaa import fxaa as j_fxaa
import vrenderer_pathtracer_tpu_torch as vpt
from vrenderer_pathtracer_tpu_torch.ops.fxaa import fxaa

ATOL = 1e-6
_j_fxaa = jax.jit(j_fxaa)  # one compile per image shape, not per op


def _images():
    rng = np.random.default_rng(11)
    noise = rng.uniform(0, 1, (33, 47, 3)).astype(np.float32)
    # Hard edges: a diagonal step, a vertical bar and a one-pixel line.
    yy, xx = np.mgrid[0:40, 0:56]
    edge = np.zeros((40, 56, 3), np.float32)
    edge[yy > 0.6 * xx + 3] = 1.0
    edge[:, 30:33] = (0.2, 0.9, 0.4)
    edge[17, :] = 0.75
    smooth = np.broadcast_to(np.linspace(0, 1, 24, dtype=np.float32)[None, :, None],
                             (16, 24, 3)).copy()
    return {"noise": noise, "edges": edge, "smooth": smooth,
            "tiny": noise[:3, :5]}


@pytest.mark.parametrize("subpix, edge", [(0.75, 0.166), (1.0, 0.063),
                                          (0.25, 0.333), (0.0, 0.125)])
def test_fxaa_matches_jax(subpix, edge):
    for name, img in _images().items():
        want = np.asarray(_j_fxaa(jnp.asarray(img), subpix, edge))
        got = fxaa(torch.tensor(img), subpix, edge).numpy()
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=0, err_msg=name)
    # A smooth ramp is left as it is; hard edges move.
    smooth, edges = _images()["smooth"], _images()["edges"]
    assert np.array_equal(fxaa(torch.tensor(smooth), subpix, edge).numpy(),
                          smooth)
    assert not np.array_equal(fxaa(torch.tensor(edges), subpix, edge).numpy(),
                              edges)


def test_fxaa_is_differentiable():
    img = torch.tensor(_images()["edges"], requires_grad=True)
    fxaa(img).sum().backward()
    assert torch.isfinite(img.grad).all() and img.grad.abs().sum() > 0


def test_renderer_fxaa_toggle_and_sliders():
    """toggle_fxaa switches the display pass without clearing the
    accumulation; the image is the FXAA of the plain one."""
    kw = dict(use_cornell_box=True, has_hdr=False, samples_per_pass=2,
              bounces=2)
    r = vpt.Renderer(24, 16, device="cpu", settings=vpt.RenderSettings(**kw))
    plain, _ = r.render()
    r.toggle_fxaa(True)
    assert r.settings.use_fxaa and r.get_frame_count() == 2
    shown, _ = r.current_frame()
    np.testing.assert_allclose(shown.numpy(), fxaa(plain).numpy(), atol=0)
    r.set_fxaa_params(subpix_quality=0.25, edge_threshold=0.3)
    assert (r.fxaa_subpix_quality, r.fxaa_edge_threshold) == (0.25, 0.3)
    again, _ = r.current_frame()
    np.testing.assert_allclose(again.numpy(), fxaa(plain, 0.25, 0.3).numpy(),
                               atol=0)
    on = vpt.Renderer(24, 16, device="cpu",
                      settings=vpt.RenderSettings(use_fxaa=True, **kw))
    img, _ = on.render()
    np.testing.assert_allclose(img.numpy(), fxaa(plain).numpy(), atol=0)
    assert not np.array_equal(img.numpy(), plain.numpy())
    r.toggle_fxaa(False)
    assert torch.equal(r.current_frame()[0], plain)

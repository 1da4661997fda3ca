"""PyTorch port: the terminal viewer (``view.py``) against the JAX package's.

The six tests of tests/test_viewer.py on the port's viewer, then both
viewers driven by one key script on a 16x16 Cornell box (orbit, dolly, the
Fresnel sliders, FXAA, the depth view, SGR drags): the camera equals the
JAX viewer's bit for bit, the sliders, FXAA state, frame counts and HUD
fields (all but the timings) equal, and the drawn cells agree under the
outlier contract of tests/test_config3_textured_mesh.py (at most 2% of the
drawn pixels off by more than 1e-3, mean at most 1e-4 over the rest).  The
script ends with FXAA off: FXAA's edge tests turn a float32 rounding
difference of its input into a discrete change of up to a 3x3
neighbourhood, which on a 16x16 frame is more than 2% of the pixels
(tests/test_torch_fxaa.py holds FXAA to JAX's on the same inputs).  An
SGR wheel report leaves the port's camera as it is (the JAX viewer decodes
it as a left-button drag, a fault of the reference not held here), and
the CLI's ``view --headless --cpu`` draws what the JAX CLI's does.
"""

import io
import re

import numpy as np
import pytest

import vrenderer_pathtracer_tpu as jvpt
from vrenderer_pathtracer_tpu import cli as jcli
from vrenderer_pathtracer_tpu.view import TerminalViewer as JViewer
import vrenderer_pathtracer_tpu_torch as vpt
from vrenderer_pathtracer_tpu_torch import cli
from vrenderer_pathtracer_tpu_torch.view import (
    CELL_PX_X, CELL_PX_Y, ORBIT_PX, TerminalViewer)

FLAGS = dict(use_cornell_box=True, has_hdr=False, samples_per_pass=1, bounces=2)

# One batch of keys a pass.  The SGR reports are decoded by each viewer.
SCRIPT = (("right",), ("up", "w"), ("]", "'"), ("f",), ("enter",),
          ("0;10;5M", "32;13;7M", "0;13;7m"), ("2;5;5M", "34;5;8M", "2;5;8m"),
          ("h", "s", "[", ";"), ("enter", "down", "f"))
CELL = re.compile(r"\x1b\[38;2;(\d+);(\d+);(\d+)m\x1b\[48;2;(\d+);(\d+);(\d+)m")


def _viewer(w=16, h=16):
    r = vpt.Renderer(w, h, settings=vpt.RenderSettings(**FLAGS), device="cpu")
    out = io.StringIO()
    return TerminalViewer(r, out=out, max_cols=24, max_rows=10), r, out


def test_headless_loop_draws_frames():
    v, r, out = _viewer()
    v.run(max_passes=3, interactive=False)
    assert r.get_frame_count() == 4  # 3 passes
    text = out.getvalue()
    assert "\x1b[38;2;" in text and "▀" in text  # truecolor half-blocks
    assert "3 spp" in text.split("\n")[-2]      # HUD line of the last frame


def test_orbit_keys_restart_accumulation():
    v, r, _ = _viewer()
    v.step()
    assert r.get_frame_count() == 2
    yaw0 = float(r.camera.yaw)
    v.step(keys=["right"])
    assert np.isclose(float(r.camera.yaw) - yaw0,
                      r.camera.DRAG_RAD_PER_PX * ORBIT_PX)
    assert r.get_frame_count() == 2  # cleared to 1, then one pass
    origin0 = r.camera.origin.clone()
    v.step(keys=["w"])
    assert not np.allclose(r.camera.origin.numpy(), origin0.numpy())


def test_depth_toggle_and_quit():
    v, _, _ = _viewer()
    v.step(keys=["enter"])
    assert v.show_depth and "depth" in v.hud()
    v.step(keys=["enter"])
    assert not v.show_depth
    v.step(keys=["q"])
    assert v.quit


def test_fresnel_keys_update_sliders():
    v, r, _ = _viewer()
    c0 = float(r.fresnel_coef)
    v.handle_key("]")
    assert float(r.fresnel_coef) > c0
    v.handle_key("[")
    assert np.isclose(float(r.fresnel_coef), c0)
    p0 = float(r.fresnel_pow)
    v.handle_key("'")
    assert float(r.fresnel_pow) > p0


def _cells(text):
    """The last frame's drawn pixels [2 * rows, cols, 3] uint8 and its HUD."""
    frame = text.split("\x1b[H")[-1]
    lines = frame.split("\n")
    rows = [CELL.findall(line) for line in lines if CELL.search(line)]
    px = np.array([[[c[:3], c[3:]] for c in row] for row in rows], np.int32)
    img = px.transpose(0, 2, 1, 3).reshape(-1, px.shape[1], 3)
    hud = next(line for line in lines if "spp" in line)
    return img, hud


def _hud_fields(hud):
    return [f.strip() for f in hud.split("|")[2:]]  # all but fps and ms


def _assert_cells_agree(got, want):
    err = np.abs(got - want).max(axis=-1) / 255.0
    assert got.shape == want.shape
    assert (err > 1e-3).mean() <= 0.02, f"{(err > 1e-3).mean():.3%} differ"
    assert err[err <= 1e-3].mean() <= 1e-4


def test_cli_view_headless(capsys, monkeypatch):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    argv = ["view", "--cornell", "--width", "16", "--height", "16",
            "--samples-per-pass", "1", "--bounces", "2",
            "--passes", "2", "--headless", "--cpu", "--cols", "20",
            "--rows", "8"]
    assert cli.main(argv) == 0
    port = capsys.readouterr().out
    assert "▀" in port and "spp" in port
    assert jcli.main(argv) == 0
    jax_ = capsys.readouterr().out
    (got, got_hud), (want, want_hud) = _cells(port), _cells(jax_)
    assert got.shape == (16, 20, 3)
    _assert_cells_agree(got, want)
    assert _hud_fields(got_hud) == _hud_fields(want_hud)


def test_mouse_drag_orbits_with_reference_constant():
    v, r, _ = _viewer()
    assert TerminalViewer._parse_sgr_mouse("32;10;5M") == ("mouse", 0, 10, 5, True)
    assert TerminalViewer._parse_sgr_mouse("0;3;4m") == ("mouse", 0, 3, 4, False)
    assert TerminalViewer._parse_sgr_mouse("garbage") is None

    yaw0, pitch0 = float(r.camera.yaw), float(r.camera.pitch)
    v.handle_key(("mouse", 0, 10, 5, True))     # press: anchors, no motion
    assert float(r.camera.yaw) == yaw0
    v.handle_key(("mouse", 0, 13, 7, True))     # drag +3 cols, +2 rows
    s = r.camera.DRAG_RAD_PER_PX
    np.testing.assert_allclose(float(r.camera.yaw),
                               yaw0 - 3 * CELL_PX_X * s, rtol=1e-6)
    np.testing.assert_allclose(float(r.camera.pitch),
                               pitch0 + 2 * CELL_PX_Y * s, rtol=1e-6)
    assert r.frame == 1                          # camera edits clear accum

    v.handle_key(("mouse", 0, 13, 7, False))    # release
    yaw1 = float(r.camera.yaw)
    v.handle_key(("mouse", 0, 20, 9, True))     # new press: no jump
    assert float(r.camera.yaw) == yaw1

    z0 = float(r.camera.origin[2])
    v.handle_key(("mouse", 2, 5, 5, True))      # RMB press
    v.handle_key(("mouse", 2, 5, 8, True))      # drag down 3 rows
    assert float(r.camera.origin[2]) != z0      # dollied along view dir


@pytest.mark.parametrize("report", ["64;10;5M", "65;10;5M", "96;12;6M"])
def test_sgr_wheel_report_leaves_the_camera(report):
    """Wheel up, wheel down, and a wheel report with the motion bit: no
    action, also in the middle of a left-button drag."""
    v, r, _ = _viewer()
    ev = TerminalViewer._parse_sgr_mouse(report)
    assert ev[0] == "wheel"
    before = [t.clone() for t in (r.camera.yaw, r.camera.pitch, r.camera.origin)]
    frame = r.frame
    v.handle_key(ev)
    v.handle_key(("mouse", 0, 10, 5, True))     # a drag anchored here
    v.handle_key(ev)
    after = (r.camera.yaw, r.camera.pitch, r.camera.origin)
    assert all(bool((a == b).all()) for a, b in zip(after, before))
    assert r.frame == frame


def _drive(viewer, script):
    for batch in script:
        viewer.step([viewer._parse_sgr_mouse(k) if k[-1] in "Mm" and ";" in k
                     else k for k in batch])
    return viewer


def test_key_script_matches_the_jax_viewer():
    port, r, out = _viewer()
    jr = jvpt.Renderer(16, 16, settings=jvpt.RenderSettings(**FLAGS))
    jout = io.StringIO()
    jv = JViewer(jr, out=jout, max_cols=24, max_rows=10)
    _drive(port, SCRIPT)
    _drive(jv, SCRIPT)
    cam, jcam = r.camera, jr.camera
    assert cam.yaw.numpy().tobytes() == np.asarray(jcam.yaw).tobytes()
    assert cam.pitch.numpy().tobytes() == np.asarray(jcam.pitch).tobytes()
    assert cam.origin.numpy().tobytes() == np.asarray(jcam.origin).tobytes()
    assert float(r.fresnel_coef) == float(jr.fresnel_coef)
    assert float(r.fresnel_pow) == float(jr.fresnel_pow)
    assert r.settings.use_fxaa == jr.settings.use_fxaa is False  # twice
    assert port.show_depth == jv.show_depth is False  # toggled twice
    assert (r.frame, r.samples_per_pixel, port._passes) == (
        jr.frame, jr.samples_per_pixel, jv._passes)
    (got, hud), (want, jhud) = _cells(out.getvalue()), _cells(jout.getvalue())
    assert got.shape == (20, 24, 3)
    _assert_cells_agree(got, want)
    assert _hud_fields(port.hud()) == _hud_fields(jv.hud())
    assert _hud_fields(hud) == _hud_fields(jhud)

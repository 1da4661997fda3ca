"""Live terminal viewer: the interactive display loop (port of ``view.py``).

The reference is an interactive renderer: a 0-ms repaint timer while mouse
drags orbit and dolly the camera, with an fps / ms / spp HUD.  This module
binds the port's progressive ``Renderer`` to a terminal instead: frames
draw as ANSI 24-bit half-blocks (two pixels per character cell), keys
drive the camera updates the reference's mouse did, and every scene edit
restarts progressive accumulation through the ``Renderer``'s own setters.

Key map (reference affordance in parens):
  arrows / hjkl   orbit yaw/pitch          (LMB drag, 0.00174532925 rad/px)
  w / s           dolly forward/back       (RMB drag)
  enter           toggle color/depth view  (Return key)
  f               toggle FXAA              (UI checkbox)
  [ / ]           fresnel coefficient -/+  (UI slider, clears accumulation)
  ; / '           fresnel power -/+        (UI slider)
  q / Esc         quit                     (Escape)

Mouse drags too: the interactive loop enables xterm button-event tracking
with SGR encoding (CSI ?1002/?1006).  LMB drag orbits with the reference's
radians per pixel (terminal cells scaled to window pixels), RMB drag
dollies.  A wheel report (bit 64 of the button code) has no action and
leaves the camera as it is.

Each pass's image and depth are copied to the host once; the copy waits
for the card, so the HUD's ms/pass is the pass's time, not its launch's.
``TerminalViewer.run(max_passes=N, interactive=False)`` drives the same
loop without a tty.
"""

from __future__ import annotations

import select
import shutil
import sys
import time

import numpy as np

# Pixels of simulated mouse drag per orbit keypress.
ORBIT_PX = 40.0
DOLLY_STEP = 6.0
# Window pixels per terminal cell for mouse drags: a cell column is ~8 px
# of a typical window, a half-block cell row covers two image rows (~16 px).
CELL_PX_X = 8.0
CELL_PX_Y = 16.0

# The SGR button-code bit of a wheel report (bit 32, motion while a button
# is held, keeps the button in bits 0-1).
_SGR_WHEEL = 64


class TerminalViewer:
    """Progressive render loop + ANSI display + key handling."""

    def __init__(self, renderer, out=None, max_cols: int = 0,
                 max_rows: int = 0):
        self.r = renderer
        self.out = out if out is not None else sys.stdout
        self.show_depth = False
        self.quit = False
        self._max_cols = max_cols
        self._max_rows = max_rows
        self._passes = 0
        self._last_ms = 0.0
        self._drag = {}  # mouse button -> last (col, row) while held

    # -- display ------------------------------------------------------------

    def _term_size(self):
        if self._max_cols and self._max_rows:
            return self._max_cols, self._max_rows
        size = shutil.get_terminal_size()
        cols, rows = size.columns, size.lines
        if self._max_cols:
            cols = min(cols, self._max_cols)
        if self._max_rows:
            rows = min(rows, self._max_rows)
        return max(cols, 8), max(rows - 2, 4)  # leave room for the HUD

    @staticmethod
    def _downsample(img, cols, rows2):
        """Nearest-sample img [H,W,3] to (rows2, cols) for display."""
        h, w = img.shape[:2]
        ys = np.clip((np.arange(rows2) + 0.5) * (h / rows2), 0, h - 1)
        xs = np.clip((np.arange(cols) + 0.5) * (w / cols), 0, w - 1)
        return img[ys.astype(int)[:, None], xs.astype(int)[None, :]]

    def draw(self, img, depth):
        """One ANSI frame from host arrays: half-block image + HUD line."""
        cols, rows = self._term_size()
        if self.show_depth:
            shown = np.repeat((1.0 - depth)[..., None], 3, axis=-1)
        else:
            shown = img
        # Image rows are y-up (pixel 0 = bottom): flip for display.
        shown = np.clip(np.asarray(shown, np.float32)[::-1], 0.0, 1.0)
        small = self._downsample(shown, cols, rows * 2)
        rgb = (small * 255.0 + 0.5).astype(np.uint8)
        lines = ["\x1b[H"]  # cursor home
        for rr in range(rows):
            top = rgb[2 * rr]
            bot = rgb[2 * rr + 1]
            cells = []
            for cc in range(cols):
                tr, tg, tb = top[cc]
                br, bg, bb = bot[cc]
                cells.append(
                    f"\x1b[38;2;{tr};{tg};{tb}m\x1b[48;2;{br};{bg};{bb}m▀")
            lines.append("".join(cells) + "\x1b[0m\n")
        lines.append("\x1b[0m\x1b[K" + self.hud() + "\n")
        self.out.write("".join(lines))
        self.out.flush()

    def hud(self) -> str:
        """fps / ms / spp overlay; reads the two sliders off the device."""
        fps = 1000.0 / self._last_ms if self._last_ms > 0 else 0.0
        channel = "depth" if self.show_depth else "color"
        return (f"{fps:5.1f} fps | {self._last_ms:7.1f} ms/pass | "
                f"{self.r.samples_per_pixel} spp | {channel} | "
                f"fresnel {float(self.r.fresnel_coef):.2f}/"
                f"{float(self.r.fresnel_pow):.1f} | q quits")

    # -- input --------------------------------------------------------------

    def handle_key(self, key) -> None:
        """Apply one key (escape sequences already translated to names, mouse
        reports to tuples)."""
        r = self.r
        if isinstance(key, tuple):
            if key[0] == "mouse":
                self._handle_mouse(*key[1:])
            return  # a wheel report: no action
        if key in ("q", "esc"):
            self.quit = True
        elif key in ("left", "h"):
            r.set_camera(r.camera.orbit(-ORBIT_PX, 0.0))
        elif key in ("right", "l"):
            r.set_camera(r.camera.orbit(ORBIT_PX, 0.0))
        elif key in ("up", "k"):
            r.set_camera(r.camera.orbit(0.0, ORBIT_PX))
        elif key in ("down", "j"):
            r.set_camera(r.camera.orbit(0.0, -ORBIT_PX))
        elif key == "w":
            r.set_camera(r.camera.move_forward(DOLLY_STEP))
        elif key == "s":
            r.set_camera(r.camera.move_forward(-DOLLY_STEP))
        elif key == "enter":
            self.show_depth = not self.show_depth
        elif key == "f":
            r.toggle_fxaa(not r.settings.use_fxaa)
        elif key == "[":
            r.set_fresnel_coef(max(float(r.fresnel_coef) - 0.05, 0.0))
        elif key == "]":
            r.set_fresnel_coef(min(float(r.fresnel_coef) + 0.05, 1.0))
        elif key == ";":
            r.set_fresnel_power(max(float(r.fresnel_pow) - 0.5, 0.0))
        elif key == "'":
            r.set_fresnel_power(float(r.fresnel_pow) + 0.5)

    def _handle_mouse(self, btn: int, col: int, row: int, pressed: bool):
        """The reference's drags: LMB -> ``yaw(-diffx * rad_per_px)``,
        ``pitch(diffy * rad_per_px)`` (diffy grows downward, as terminal
        rows do); RMB -> ``moveForward(diffy)`` in window pixels.  A press
        anchors the drag, a release ends it."""
        r = self.r
        if not pressed:
            self._drag.pop(btn, None)
            return
        if btn in self._drag:
            lx, ly = self._drag[btn]
            diffx = (col - lx) * CELL_PX_X
            diffy = (row - ly) * CELL_PX_Y
            if (diffx or diffy) and btn == 0:      # LMB: orbit
                r.set_camera(r.camera.orbit(-diffx, diffy))
            elif diffy and btn == 2:               # RMB: dolly
                r.set_camera(r.camera.move_forward(diffy))
        self._drag[btn] = (col, row)

    @staticmethod
    def _parse_sgr_mouse(payload: str):
        """Decode one SGR mouse report body ``Cb;Cx;Cy`` + final ``M``/``m``.

        A button report (motion carries bit 32 of Cb, the button bits 0-1)
        gives ``("mouse", button, col, row, pressed)``; a wheel report (bit
        64) gives ``("wheel", direction, col, row)``, direction 0 up and 1
        down; a malformed body gives None.
        """
        if not payload or payload[-1] not in "Mm":
            return None
        try:
            cb, cx, cy = (int(v) for v in payload[:-1].split(";"))
        except ValueError:
            return None
        if cb & _SGR_WHEEL:
            return ("wheel", cb & 3, cx, cy)
        return ("mouse", cb & 3, cx, cy, payload[-1] == "M")

    def _read_keys_nonblocking(self):
        """Pending keys from a raw-mode stdin, escape sequences decoded."""
        keys = []
        while select.select([sys.stdin], [], [], 0)[0]:
            ch = sys.stdin.read(1)
            if ch == "\x1b":
                if select.select([sys.stdin], [], [], 0.01)[0]:
                    seq = sys.stdin.read(1)
                    if seq == "[" and select.select([sys.stdin], [], [], 0.01)[0]:
                        code = sys.stdin.read(1)
                        if code == "<":  # SGR mouse report: Cb;Cx;CyM|m
                            payload = ""
                            while select.select([sys.stdin], [], [], 0.01)[0]:
                                c2 = sys.stdin.read(1)
                                payload += c2
                                if c2 in "Mm" or len(payload) > 32:
                                    break
                            ev = self._parse_sgr_mouse(payload)
                            if ev:
                                keys.append(ev)
                            continue
                        keys.append({"A": "up", "B": "down", "C": "right",
                                     "D": "left"}.get(code, ""))
                        continue
                keys.append("esc")
            elif ch in ("\r", "\n"):
                keys.append("enter")
            else:
                keys.append(ch)
        return [k for k in keys if k]

    # -- the loop -----------------------------------------------------------

    def step(self, keys=()) -> None:
        """One viewer iteration: apply keys, render a pass, copy its image
        and depth to the host (which waits for the device), draw."""
        for k in keys:
            self.handle_key(k)
            if self.quit:
                return
        t0 = time.perf_counter()
        img, depth = self.r.render()
        img = img.cpu().numpy()
        depth = depth.cpu().numpy()
        self._last_ms = (time.perf_counter() - t0) * 1e3
        self._passes += 1
        self.draw(img, depth)

    def run(self, max_passes: int | None = None, interactive: bool | None = None):
        """Drive the loop; interactive defaults to stdin being a tty."""
        if interactive is None:
            interactive = sys.stdin.isatty()
        if not interactive:
            n = max_passes if max_passes is not None else 8
            for _ in range(n):
                if self.quit:
                    break
                self.step()
            return

        import termios
        import tty

        fd = sys.stdin.fileno()
        saved = termios.tcgetattr(fd)
        # Clear, hide cursor, enable xterm button-event mouse tracking with
        # SGR encoding (drag reports; terminals without support ignore it).
        self.out.write("\x1b[2J\x1b[?25l\x1b[?1002h\x1b[?1006h")
        try:
            tty.setcbreak(fd)
            while not self.quit:
                self.step(self._read_keys_nonblocking())
                if max_passes is not None and self._passes >= max_passes:
                    break
        finally:
            termios.tcsetattr(fd, termios.TCSADRAIN, saved)
            self.out.write("\x1b[?1002l\x1b[?1006l\x1b[?25h\x1b[0m\n")
            self.out.flush()

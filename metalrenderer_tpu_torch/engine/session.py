"""Interactive render session: the analog of the reference's live window
loop (MtlEngine::run, mtl_engine.mm:68-87), and torch counterpart of
``metalrenderer_tpu.engine.session``.

The reference ties GLFW input callbacks (mtl_engine.mm:164-202) and ImGui
sliders (mtl_engine.mm:883-885) to engine state that the next frame
consumes. Here the same loop runs headless: input events arrive as JSON
objects (one per line on stdin or from a script file), each event updates
host-side session state through the pure camera-update functions, and
every frame renders through ``audio_app.render_audio_app`` on the session's
device (on the card: one K1 and one K2 launch a frame). Nothing is cached
between frames: each frame builds its scene, bins and uniforms from the
current state, so a ``resize`` or a ``set`` takes effect on the next frame.

Event vocabulary (all fields optional unless noted):

  {"type": "cursor", "x": X, "y": Y, "shift": true|false}
      GLFW cursor-position callback (mtl_engine.mm:176-190): the drag
      delta from the previous cursor position rotates the orbit camera,
      but ONLY while shift is held (the reference gates rotation on
      GLFW_MOD_SHIFT, mtl_engine.mm:183-186).
  {"type": "drag", "dx": DX, "dy": DY}
      Pre-computed drag offsets -> Camera::processMouseMovement
      (Camera.cpp:33-38).
  {"type": "scroll", "dy": DY}
      Scroll-wheel dolly -> Camera::processMouseScroll (Camera.cpp:41-46).
  {"type": "set", "cube_pos": [x,y,z], "light_pos": [x,y,z],
   "light_color": [r,g,b], "displacement": D}
      The ImGui slider panel (mtl_engine.mm:883-885): cube/light position
      and light color; displacement is the audio scalar the live app
      derives from the mic (mtl_engine.mm:761-762).
  {"type": "resize", "width": W, "height": H}
      Framebuffer resize (mtl_engine.mm:199-218): the render config and
      the camera's aspect change.
  {"type": "frame", "n": N}
      Render N frames with unchanged state (default 1). Every OTHER event
      type also renders one frame after applying itself, matching the
      reference's render-every-vsync loop where input mutates state between
      frames.

Each rendered frame emits one JSON telemetry line (the ImGui overlay's
replacement): frame index, camera spherical state, scene parameters, and
the render stats.
"""
from __future__ import annotations

import json

from ..config import RenderConfig, ShadowConfig
from ..passes.pipeline import resolve_device
from ..scene.camera import OrbitCamera
from . import audio_app


class InteractiveSession:
    """Host-side mutable shell around the pure render function: all
    mutation happens here, and every frame is rendered from the current
    state alone."""

    def __init__(self, config: RenderConfig = RenderConfig(),
                 shadow_config: ShadowConfig = ShadowConfig(),
                 camera: OrbitCamera = None, backend: str = "kernels",
                 cube_pos=(0.0, 0.0, -1.0), light_pos=(0.0, 2.0, 0.0),
                 light_color=(1.0, 1.0, 1.0), displacement=0.0,
                 device="cuda"):
        self.config = config
        self.shadow_config = shadow_config
        self.backend = backend
        self.device = resolve_device(device)
        self.camera = camera if camera is not None else \
            audio_app.default_camera(config.width, config.height)
        self.cube_pos = tuple(float(v) for v in cube_pos)
        self.light_pos = tuple(float(v) for v in light_pos)
        self.light_color = tuple(float(v) for v in light_color)
        self.displacement = float(displacement)
        self.frame_index = 0
        self._cursor = None          # last (x, y) for cursor-delta events

    # --- event handling ---------------------------------------------------
    def handle_event(self, event: dict) -> int:
        """Apply one input event; returns how many frames to render."""
        kind = event.get("type")
        if kind == "cursor":
            prev_xy = self._cursor if self._cursor is not None else (0.0,
                                                                     0.0)
            x = float(event.get("x", prev_xy[0]))
            y = float(event.get("y", prev_xy[1]))
            prev, self._cursor = self._cursor, (x, y)
            # Shift-gated rotation (mtl_engine.mm:183-186); the first cursor
            # event only establishes the anchor position. The vertical delta
            # is REVERSED (prev_y - y) exactly as the reference's
            # mouseCallback computes yoffset = lastY - ypos "since
            # y-coordinates go from bottom to top" (mtl_engine.mm:177).
            if prev is not None and event.get("shift"):
                self.camera = self.camera.process_mouse_movement(
                    x - prev[0], prev[1] - y)
        elif kind == "drag":
            self.camera = self.camera.process_mouse_movement(
                float(event.get("dx", 0.0)), float(event.get("dy", 0.0)))
        elif kind == "scroll":
            self.camera = self.camera.process_mouse_scroll(
                float(event.get("dy", 0.0)))
        elif kind == "set":
            for key in ("cube_pos", "light_pos", "light_color"):
                if key in event:
                    setattr(self, key,
                            tuple(float(v) for v in event[key]))
            if "displacement" in event:
                self.displacement = float(event["displacement"])
        elif kind == "resize":
            w = int(event.get("width", self.config.width))
            h = int(event.get("height", self.config.height))
            self.config = self.config.replace(width=w, height=h)
            self.camera = self.camera.with_aspect(float(w) / float(h))
        elif kind == "frame":
            return int(event.get("n", 1))
        else:
            raise ValueError(f"unknown event type: {kind!r}")
        return 1

    # --- rendering ---------------------------------------------------------
    def render_frame(self):
        """One frame from the current state: (rgba f32[H, W, 4], stats) on
        the session's device."""
        fb, stats = audio_app.render_audio_app(
            cube_position=self.cube_pos,
            light_position=self.light_pos,
            light_color=self.light_color,
            displacement=self.displacement,
            camera=self.camera, config=self.config,
            shadow_config=self.shadow_config, backend=self.backend,
            device=self.device)
        self.frame_index += 1
        return fb, stats

    def telemetry(self, stats) -> dict:
        """The ImGui overlay's replacement: one JSON-able dict a frame."""
        return {
            "frame": self.frame_index,
            "camera": {"radius": float(self.camera.radius),
                       "theta": float(self.camera.theta),
                       "phi": float(self.camera.phi)},
            "cube_pos": list(self.cube_pos),
            "light_pos": list(self.light_pos),
            "light_color": list(self.light_color),
            "displacement": self.displacement,
            "width": self.config.width, "height": self.config.height,
            "stats": {k: v.tolist() for k, v in stats.items()},
        }

    def run(self, event_lines, on_frame=None):
        """Drive the loop: one JSON event per line. Yields (frame_pixels,
        telemetry) per rendered frame; ``on_frame(fb, telem)`` is called
        first if given (PNG writer hook)."""
        for line in event_lines:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            n_frames = self.handle_event(json.loads(line))
            for _ in range(n_frames):
                fb, stats = self.render_frame()
                telem = self.telemetry(stats)
                if on_frame is not None:
                    on_frame(fb, telem)
                yield fb, telem

"""The program's entries that a cell's window drives, each behind one
driver with the same face: ``warmup()``, then ``request(i)`` for the i-th
request of the window, returning (frames f32[n, H, W, 4] on the device,
the request's audio-track parameters or None), and what the reference
needs to render the same frames again: ``audio(frames)``, the signal the
window's frames heard, or ``frame_inputs(first, count)``, each frame's
displacement and camera angle (``inputs.frames``).

Which driver a cell takes is its workload file's ``entry``; the scene, the
camera and the light come from its configuration file, built here with the
port's own API (``metalrenderer_tpu_torch``), and what it sends from its
traffic file (``inputs``). Nothing here imports the program until a
driver is made.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from . import inputs


def port_scene(config, mesh_arrays, device):
    """(Scene, OrbitCamera, Lighting, RenderConfig, ShadowConfig,
    shadow_target) of a configuration file, as the port's objects; the
    scene's textures are the port's mip chains (``io.textures.from_array``)
    of the base images the benchmark made (``mesh_arrays["textures"]``).
    An OBJ mesh is read back from its file by the port's ``io.obj.
    load_obj`` (its native parser where that builds), which has to give
    the arrays the file was written from, bit for bit."""
    import torch
    import metalrenderer_tpu_torch as mr
    from metalrenderer_tpu_torch.io import obj as obj_mod
    from metalrenderer_tpu_torch.io import textures as textures_mod
    from metalrenderer_tpu_torch.math import transforms
    from metalrenderer_tpu_torch.scene import mesh as mesh_mod

    render = mr.RenderConfig(**config["render"])
    shadow = mr.ShadowConfig(**config.get("shadow", {}))
    ld = config["light"]
    color = tuple(ld.get("color", (1.0, 1.0, 1.0)))
    if ld["kind"] == "point":
        light = mr.PointLight(tuple(ld["position"]), color,
                              ld.get("intensity", 1.0))
    elif ld["kind"] == "directional":
        light = mr.DirectionalLight(tuple(ld["direction"]), color,
                                    ld.get("intensity", 1.0))
    else:
        raise ValueError(f"no cell takes a {ld['kind']!r} light")
    lighting = mr.Lighting(light, config.get("ambient_intensity", 0.1),
                           config.get("shininess", 32.0))
    kinds = {"blinn_phong": mr.BLINN_PHONG,
             "blinn_phong_shadow": mr.BLINN_PHONG_SHADOW,
             "emissive": mr.EMISSIVE}
    instances = []
    for i, d in enumerate(config["instances"]):
        kind = d["mesh"]["kind"]
        if kind == "obj":
            path = mesh_arrays["obj_files"][i]
            m = obj_mod.load_obj(path)
            inputs.same_bits([t.numpy() for t in (m.positions, m.uvs,
                                                  m.normals)],
                             mesh_arrays[i], f"io.obj.load_obj({path!r})")
        else:
            m = (mesh_mod.cube() if kind == "cube" else
                 mesh_mod.plane() if kind == "plane" else
                 mesh_mod.from_numpy(*mesh_arrays[i]))
        mat = d["material"]
        c = color if mat["color"] == "light" else mat["color"]
        model = transforms.matmul(
            transforms.translation(*d.get("translate", (0.0, 0.0, 0.0))),
            transforms.scale(*d.get("scale", (1.0, 1.0, 1.0))))
        if "rotate" in d:
            model = transforms.matmul(model, transforms.rotation(
                d["rotate"]["angle"], d["rotate"]["axis"]))
        instances.append(mr.Instance(
            mesh=m, model_matrix=model,
            material=mr.Material(color=torch.tensor(c, dtype=torch.float32),
                                 kind=kinds[mat["kind"]],
                                 texture_id=d.get("texture_id", -1),
                                 normal_map_id=d.get("normal_map_id", -1)),
            cast_shadow=d.get("cast_shadow", False),
            use_displacement=d.get("use_displacement", False)))
    camera = mr.OrbitCamera(**config["camera"],
                            aspect=render.width / render.height)
    textures = tuple(textures_mod.from_array(a, generate_mips=True)
                     for a in mesh_arrays.get("textures", ()))
    return (mr.Scene(instances=tuple(instances),
                     textures=textures).to(device), camera,
            lighting, render, shadow,
            tuple(config.get("shadow_target", (0.0, 0.0, 0.0))))


class StreamDriver:
    """``engine.renderer.stream_audio_reactive`` over the traffic's audio
    signal, ``frames_per_request`` buffers (one frame each) a request: the
    AudioApp scene of the configuration (its displaced instance is the
    cube, its point light the light cube)."""

    def __init__(self, config, traffic, workload, seed, device):
        from metalrenderer_tpu_torch.engine import renderer
        self.renderer = renderer
        self.traffic, self.device = traffic, device
        self.per_request = int(traffic["frames_per_request"])
        self.warmup_requests = int(workload["warmup_requests"])
        _, self.camera, _, self.render, self.shadow, _ = port_scene(
            config, {}, "cpu")
        cube = next(d for d in config["instances"]
                    if d.get("use_displacement"))
        self.kw = dict(
            chunk_frames=self.per_request, camera=self.camera,
            cube_position=tuple(cube.get("translate", (0.0, 0.0, 0.0))),
            light_position=tuple(config["light"]["position"]),
            config=self.render, shadow_config=self.shadow, device=device)
        self.window_samples, self.warm_samples = inputs.audio_window(
            traffic, self.warmup_requests, seed)
        self.sample_rate = float(traffic["sample_rate"])
        self.n = int(traffic["buffer_samples"])
        self.stream = None

    def warmup(self):
        for _ in self.renderer.stream_audio_reactive(
                self.warm_samples, self.sample_rate, **self.kw):
            pass

    def request(self, i):
        if self.stream is None:
            self.stream = self.renderer.stream_audio_reactive(
                self.window_samples, self.sample_rate, **self.kw)
        try:
            frames, telem = next(self.stream)
        except StopIteration:
            raise RuntimeError("the traffic's signal ran out inside the "
                               "window: raise max_frames_per_s") from None
        return frames, (telem["light_color"], telem["light_intensity"],
                        telem["displacement"])

    def audio(self, frames):
        """The window's first ``frames`` buffers of the signal."""
        return self.window_samples[:frames * self.n]

    def close(self):
        if self.stream is not None:
            self.stream.close()
        self.stream = None


class FrameDriver:
    """``passes.pipeline.render_frame`` (one frame a request) or
    ``render_batch`` (``frames_per_request`` frames, ``chunk="auto"``) of
    the configuration's scene, frame i displaced and seen from the orbit
    angle that the traffic says (``inputs.frames``)."""

    def __init__(self, config, traffic, workload, seed, device, batch,
                 mesh_arrays):
        from metalrenderer_tpu_torch.passes import pipeline
        self.pipeline, self.batch = pipeline, batch
        self.config, self.traffic = config, traffic
        self.seed, self.device = seed, device
        self.per_request = int(traffic["frames_per_request"])
        if not batch and self.per_request != 1:
            raise ValueError("render_frame takes one frame a request")
        self.warmup_requests = int(workload["warmup_requests"])
        (self.scene, self.camera, self.lighting, self.render, self.shadow,
         self.shadow_target) = port_scene(config, mesh_arrays, device)

    def _frames(self, ins):
        disps = [f["displacement"] for f in ins]
        thetas = [f["theta"] for f in ins] if "theta" in ins[0] else None
        if self.batch:
            rgba, _ = self.pipeline.render_batch(
                self.scene, self.camera, self.lighting, disps, thetas,
                config=self.render, shadow_config=self.shadow,
                shadow_target=self.shadow_target, chunk="auto",
                device=self.device)
            return rgba
        camera = self.camera if thetas is None else dataclasses.replace(
            self.camera, theta=thetas[0])
        fb, _ = self.pipeline.render_frame(
            self.scene, camera, self.lighting, self.render, self.shadow,
            disps[0], self.shadow_target, device=self.device)
        return fb[None]

    def warmup(self):
        # Frames before any the window sends: the same shapes.
        for k in range(self.warmup_requests):
            self._frames(self.frame_inputs(-(k + 1) * self.per_request,
                                           self.per_request))

    def request(self, i):
        return self._frames(self.frame_inputs(i * self.per_request,
                                              self.per_request)), None

    def frame_inputs(self, first, count):
        return inputs.frames(self.traffic, self.config, first, count,
                             self.seed)

    def close(self):
        self.scene = None


def make(entry, config, traffic, workload, seed, device, mesh_arrays):
    """The driver of a workload file's ``entry``; ``mesh_arrays``: the
    benchmark's meshes of the configuration (``inputs.mesh_arrays``)."""
    if entry == "stream_audio_reactive":
        if traffic["generator"] != "audio":
            raise ValueError(f"{entry} takes audio traffic")
        return StreamDriver(config, traffic, workload, seed, device)
    if entry in ("render_frame", "render_batch"):
        if traffic["generator"] not in inputs.FRAME_GENERATORS:
            raise ValueError(f"{entry} takes one of "
                             f"{inputs.FRAME_GENERATORS} traffic")
        return FrameDriver(config, traffic, workload, seed, device,
                           entry == "render_batch", mesh_arrays)
    raise ValueError(f"unknown entry {entry!r}")


def stack_track(parts):
    """The kept per-request track parameters -> numpy (color [n, 3],
    intensity [n], displacement [n])."""
    import torch
    return tuple(torch.cat([p[k].reshape(-1, *p[k].shape[1:]) for p in parts])
                 .cpu().numpy().astype(np.float32) for k in range(3))

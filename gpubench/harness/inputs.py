"""What the benchmark makes from a cell's traffic file and seed: the audio
signal and the per-frame displacements and orbit angles the window sends,
and the meshes' arrays (a dense sphere, a UV sphere, either written out as
an OBJ file) and the textures' base images that both the program and the
reference read.

One general generator per traffic kind, driven by the parameters in
``traffic/<name>.json``; the seed sets phases and noise, never sizes or
counts, so every seed sends the same amount of work.
"""
from __future__ import annotations

import pathlib

import numpy as np


def rng(seed, stream):
    """A numpy Generator for one use of the seed (``stream`` keeps the
    traffic, the sample of checked requests and the rest apart). Seeds of
    any size are taken whole."""
    return np.random.default_rng([int(seed) % (1 << 64), stream])


TRAFFIC_STREAM, CHECK_STREAM = 1, 2


def audio_signal(traffic, buffers, seed):
    """``buffers`` x ``buffer_samples`` mono samples, float32: parts of
    ``part_buffers`` buffers that cycle through a tone at each of
    ``tones_hz`` (a random phase each part, the RMS level of the same place
    in ``tone_rms``), a noise burst (RMS ``noise_rms``) and silence. A copy
    of ``chip_smoke.audio_signal``'s six parts, repeated, so that a window
    of any length hears all of them."""
    r = rng(seed, TRAFFIC_STREAM)
    n = int(traffic["buffer_samples"])
    sr = float(traffic["sample_rate"])
    part = int(traffic["part_buffers"]) * n
    tones = [float(f) for f in traffic["tones_hz"]]
    kinds = len(tones) + 2
    total = buffers * n
    out = np.zeros(total, np.float32)
    t = np.arange(part) / sr
    for k, start in enumerate(range(0, total, part)):
        m = min(part, total - start)
        which = k % kinds
        if which < len(tones):
            seg = np.sqrt(2.0) * traffic["tone_rms"][which] * np.sin(
                2 * np.pi * tones[which] * t[:m] + r.uniform(0, 2 * np.pi))
        elif which == len(tones):
            seg = traffic["noise_rms"] * r.standard_normal(m)
        else:
            continue
        out[start:start + m] = seg
    return out


def audio_window(traffic, warmup_requests, seed):
    """(the window's signal, the warm-up's): the window's holds the most a
    window of ``max_seconds`` at ``max_frames_per_s`` can take, and a whole
    request more; the warm-up plays ``warmup_requests`` requests of its
    own, cut from the end, so the window's stream starts at sample 0."""
    f = int(traffic["frames_per_request"])
    n = int(traffic["buffer_samples"])
    window = int(traffic["max_frames_per_s"] * traffic["max_seconds"]) + f
    warm = int(warmup_requests) * f
    samples = audio_signal(traffic, window + warm, seed)
    return samples[:window * n], samples[window * n:]


def displacements(traffic, first, count, seed):
    """The displacement of frames ``first`` .. ``first + count - 1``:
    ``base + amplitude * sin(2 pi i / period_frames + phase)``, the phase
    drawn from the seed (float32 values as Python floats)."""
    phase = rng(seed, TRAFFIC_STREAM).uniform(0, 2 * np.pi)
    i = np.arange(first, first + count, dtype=np.float64)
    d = traffic["base"] + traffic["amplitude"] * np.sin(
        2 * np.pi * i / traffic["period_frames"] + phase)
    return [float(x) for x in d.astype(np.float32)]


def orbit_thetas(traffic, theta0, first, count, seed):
    """The orbit camera's angle at frames ``first`` .. ``first + count -
    1``: ``theta0 + 2 pi (i mod period_frames) / period_frames + phase``,
    the phase drawn from the seed (float32 values as Python floats). The
    frame index is taken modulo the period first, so frame -k (a warm-up
    frame) and frame ``period_frames - k`` take the same angle, bit for
    bit."""
    phase = rng(seed, TRAFFIC_STREAM).uniform(0, 2 * np.pi)
    period = int(traffic["period_frames"])
    i = np.mod(np.arange(first, first + count, dtype=np.int64), period)
    t = theta0 + 2 * np.pi * i.astype(np.float64) / period + phase
    return [float(x) for x in t.astype(np.float32)]


FRAME_GENERATORS = ("displacement", "orbit")


def frames(traffic, config, first, count, seed):
    """What frames ``first`` .. ``first + count - 1`` of a frame traffic
    send: [{"displacement": d}] (``displacement``: the configuration's
    camera, the scene displaced by ``displacements``), or [{"displacement":
    0.0, "theta": t}] (``orbit``: the configuration's orbit camera at
    ``orbit_thetas``, from its own ``theta``, nothing displaced)."""
    kind = traffic["generator"]
    if kind == "displacement":
        return [{"displacement": d}
                for d in displacements(traffic, first, count, seed)]
    if kind == "orbit":
        theta0 = float(config["camera"]["theta"])
        return [{"displacement": 0.0, "theta": t}
                for t in orbit_thetas(traffic, theta0, first, count, seed)]
    raise ValueError(f"no frame traffic {kind!r}")


def dense_sphere_arrays(target_tris):
    """A frozen copy of the port's ``engine/configs._dense_sphere_mesh``
    (BASELINE config 5's mesh): a sphere of radius 0.5 with about
    ``target_tris`` triangles (the poles' quads degenerate), float32 numpy
    (positions, uvs, normals), three vertices per triangle."""
    stacks = max(8, int(np.sqrt(target_tris / 4)))
    slices = 2 * stacks
    phi = np.linspace(0, np.pi, stacks + 1)
    th = np.linspace(0, 2 * np.pi, slices + 1)
    pp, tt = np.meshgrid(phi, th, indexing="ij")
    pts = np.stack([np.sin(pp) * np.cos(tt), np.cos(pp),
                    np.sin(pp) * np.sin(tt)], -1).astype(np.float32)
    uv = np.stack([tt / (2 * np.pi), 1 - pp / np.pi], -1).astype(np.float32)

    def quad_corners(a):  # [stacks+1, slices+1, C] -> two tris per quad
        c00, c01, c10, c11 = a[:-1, :-1], a[:-1, 1:], a[1:, :-1], a[1:, 1:]
        t1 = np.stack([c00, c11, c01], axis=2)
        t2 = np.stack([c00, c10, c11], axis=2)
        return np.concatenate([t1, t2], axis=2).reshape(-1, a.shape[-1])

    pos = quad_corners(pts)
    return pos * 0.5, quad_corners(uv), pos


def bumpy_normal_map(size):
    """A frozen copy of the port's ``engine/configs.bumpy_normal_map``
    (BASELINE config 4's normal map) before its mip chain: the
    tangent-space normals of h = 0.15 sin(12 pi x) sin(12 pi y) packed to
    [0, 1], with alpha 1, float32 numpy [size, size, 4]."""
    n = int(size)
    y, x = np.mgrid[0:n, 0:n] / n
    h = 0.15 * np.sin(12 * np.pi * x) * np.sin(12 * np.pi * y)
    dhdx = np.gradient(h, axis=1) * n
    dhdy = np.gradient(h, axis=0) * n
    nm = np.stack([-dhdx, -dhdy, np.ones_like(h)], -1)
    nm /= np.linalg.norm(nm, axis=-1, keepdims=True)
    nm01 = ((nm + 1) / 2).astype(np.float32)
    return np.concatenate([nm01, np.ones((n, n, 1), np.float32)], -1)


def uv_sphere_arrays(stacks, slices, radius=0.5):
    """A frozen copy of the port's ``scene/mesh.uv_sphere`` (BASELINE
    config 2's spheres): smooth normals, CCW winding seen from outside, two
    triangles a quad and none at the poles' degenerate quads, float32 numpy
    (positions, uvs, normals), three vertices per triangle."""
    verts = []
    for i in range(stacks):
        phi0 = np.pi * i / stacks
        phi1 = np.pi * (i + 1) / stacks
        for j in range(slices):
            th0 = 2 * np.pi * j / slices
            th1 = 2 * np.pi * (j + 1) / slices

            def pt(phi, th):
                n = np.array([np.sin(phi) * np.cos(th), np.cos(phi),
                              np.sin(phi) * np.sin(th)], np.float32)
                uv = np.array([th / (2 * np.pi), 1.0 - phi / np.pi],
                              np.float32)
                return n * radius, uv, n

            p00, p01 = pt(phi0, th0), pt(phi0, th1)
            p10, p11 = pt(phi1, th0), pt(phi1, th1)
            if i > 0:
                verts += [p00, p11, p01]
            if i < stacks - 1:
                verts += [p00, p10, p11]
    return tuple(np.stack([v[k] for v in verts]) for k in range(3))


def checkerboard(size, squares, color_a=(1.0, 1.0, 1.0),
                 color_b=(0.2, 0.6, 0.2)):
    """A frozen copy of the base image of the port's
    ``io/textures.checkerboard`` (BASELINE config 3's color texture),
    before its mip chain: ``squares`` x ``squares`` squares of
    ``color_a`` and ``color_b``, alpha 1, float32 numpy [size, size, 4]."""
    y, x = np.mgrid[0:size, 0:size]
    cell = size // squares
    mask = ((x // cell) + (y // cell)) % 2 == 0
    img = np.where(mask[..., None], np.asarray(color_a, np.float32),
                   np.asarray(color_b, np.float32))
    return np.concatenate([img, np.ones((size, size, 1), np.float32)],
                          axis=-1)


TEXTURE_KINDS = {"bumpy_normal_map": bumpy_normal_map,
                 "checkerboard": checkerboard}
MESH_KINDS = {
    "dense_sphere": lambda d: dense_sphere_arrays(int(d["target_tris"])),
    "uv_sphere": lambda d: uv_sphere_arrays(int(d["stacks"]),
                                            int(d["slices"])),
}


def write_obj(path, pos, uv, nrm):
    """The mesh as an OBJ file in the format of the port's
    ``io/obj.save_obj`` (a frozen copy, byte for byte): one ``v``, ``vt``
    and ``vn`` a corner, each float32 written as the shortest decimal form
    of its value as a double (Python's ``str`` of ``float(x)``), which
    reads back to the same float32, then ``f a/a/a b/b/b c/c/c`` a
    triangle."""
    lines = []
    for tag, a in (("v", pos), ("vt", uv), ("vn", nrm)):
        lines += [f"{tag} " + " ".join(map(str, row))
                  for row in np.asarray(a, np.float32).tolist()]
    lines += [f"f {a}/{a}/{a} {a + 1}/{a + 1}/{a + 1} {a + 2}/{a + 2}/{a + 2}"
              for a in range(1, len(pos) + 1, 3)]
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


def same_bits(read, made, what):
    """Raises unless each of the arrays ``read`` (positions, uvs, normals)
    equals the one in ``made`` bit for bit: the same shape and the same
    float32 words."""
    for name, a, b in zip(("positions", "uvs", "normals"), read, made,
                          strict=True):
        a, b = np.asarray(a), np.asarray(b, np.float32)
        if (a.dtype != np.float32 or a.shape != b.shape
                or not np.array_equal(a.view(np.uint32), b.view(np.uint32))):
            raise RuntimeError(f"{what}: its {name} differ from the arrays "
                               "the OBJ file was written from")


def mesh_arrays(config, obj_dir=None):
    """The arrays the benchmark makes for a configuration, which the
    program and the reference both read: {instance index: (pos, uv, nrm)}
    for its meshes of a kind in ``MESH_KINDS`` and of kind ``obj`` (the
    arrays of the kind its ``of`` names, also written by ``write_obj`` to
    a file in ``obj_dir``, listed under ``"obj_files"``: {instance index:
    path}, which the program and the reference each read back), and, where
    it lists ``textures``, under ``"textures"`` each texture's base image
    (float32 [H, W, 4]), in the list's order: the ids that an instance's
    ``texture_id`` and ``normal_map_id`` name. Each side builds its own
    mip chains."""
    out = {}
    for i, d in enumerate(config["instances"]):
        mesh = d["mesh"]
        if mesh["kind"] in MESH_KINDS:
            out[i] = MESH_KINDS[mesh["kind"]](mesh)
        elif mesh["kind"] == "obj":
            if obj_dir is None:
                raise ValueError("an OBJ mesh needs a directory to be "
                                 "written to")
            out[i] = MESH_KINDS[mesh["of"]](mesh)
            path = pathlib.Path(obj_dir) / f"instance{i}.obj"
            write_obj(path, *out[i])
            out.setdefault("obj_files", {})[i] = str(path)
    if config.get("textures"):
        out["textures"] = [
            TEXTURE_KINDS[t["kind"]](**{k: v for k, v in t.items()
                                        if k != "kind"})
            for t in config["textures"]]
    return out

"""The bands of a tile-sharded frame against the unsharded frame, in the JAX
package and in the port, on the CPU.

``render_tile_sharded`` renders band b of n through a ``BandedCamera``
whose projection maps the band onto a band-sized viewport. That projection
rounds clip space otherwise than the whole frame's, so a band need not equal
the same rows of the unsharded frame at every pixel. This script measures
how far each package's bands stand from its own unsharded frame: the JAX
package's (``BandedCamera`` + ``prune_to_band`` + ``render_frame(
main_geom=)``, its reference backend) beside the port's (``render_band``,
the reference backend and the kernels' plain twins), and the pixels they
share.

    JAX_PLATFORMS=cpu python tests/torch_band_witness.py flagship 1920 1080
    JAX_PLATFORMS=cpu python tests/torch_band_witness.py config3 480 272 \\
        --bands 4 --triangles 100000

The flagship is rendered at 4xMSAA with a 1024^2 shadow map, config 3 with
its own configuration at the given size. Prints one JSON line per band
count. At 1920x1080 the JAX package's reference frames take minutes.
"""
import argparse
import json
import pathlib
import sys
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def jax_frames(case, w, h, bands, tris, backend):
    """The JAX package's unsharded frame and, per band count, its assembled
    bands, on its ``backend`` ("reference", or "pallas": its kernels in
    interpret mode)."""
    from metalrenderer_tpu.config import RenderConfig, ShadowConfig
    from metalrenderer_tpu.engine import audio_app
    from metalrenderer_tpu.parallel import sharding
    from metalrenderer_tpu.passes.pipeline import render_frame
    from metalrenderer_tpu.scene.camera import OrbitCamera
    from metalrenderer_tpu.scene.lights import Lighting, PointLight
    from metalrenderer_tpu.scene.scene import bake
    if case == "flagship":
        scene = audio_app.build_scene()
        cam = OrbitCamera(radius=5.0, theta=2.5, phi=1.2, aspect=w / h)
        cfg = RenderConfig(width=w, height=h, msaa=4, shadow_map_size=1024)
        lighting = Lighting(light=PointLight(), ambient_intensity=0.1,
                            shininess=32.0)
        target = (0.0, 0.0, -1.0)
    else:
        sys.path.insert(0, str(ROOT / "benchmarks"))
        import configs
        scene, cam, lighting, cfg = configs.config3_high_poly(
            target_tris=tris, width=w, height=h)
        target = (0.0, 0.0, 0.0)
    full, _ = render_frame(scene, cam, lighting, cfg, ShadowConfig(), 0.0,
                           target, backend)
    out = {}
    for n in bands:
        bh = h // n
        cap = sharding.band_capacity(scene.num_triangles, n)
        geom = bake(scene, 0.0)
        rows = []
        for b in range(n):
            pruned, _, _ = sharding.prune_to_band(
                geom, cam.view_matrix(), cam.projection_matrix(), w, h, b,
                bh, cap)
            fb, _ = render_frame(
                scene, sharding.BandedCamera(base=cam, band=b, n_bands=n),
                lighting, cfg.replace(height=bh), ShadowConfig(), 0.0,
                target, backend, main_geom=pruned)
            rows.append(np.asarray(fb))
        out[n] = np.concatenate(rows)
    return np.asarray(full), out


def port_frames(case, w, h, bands, tris, backend):
    """The port's unsharded frame and, per band count, its assembled bands
    (``render_band``), on the CPU."""
    from metalrenderer_tpu_torch.config import RenderConfig
    from metalrenderer_tpu_torch.engine import audio_app, configs
    from metalrenderer_tpu_torch.parallel import sharding
    from metalrenderer_tpu_torch.passes import pipeline
    from metalrenderer_tpu_torch.scene.camera import OrbitCamera
    from metalrenderer_tpu_torch.scene.lights import Lighting, PointLight
    if case == "flagship":
        scene = audio_app.build_scene(device="cpu")
        cam = OrbitCamera(radius=5.0, theta=2.5, phi=1.2, aspect=w / h)
        cfg = RenderConfig(width=w, height=h, msaa=4, shadow_map_size=1024)
        lighting = Lighting(light=PointLight(), ambient_intensity=0.1,
                            shininess=32.0)
        target = (0.0, 0.0, -1.0)
    else:
        scene, cam, lighting, cfg = configs.config3_high_poly(
            target_tris=tris, width=w, height=h, device="cpu")
        target = (0.0, 0.0, 0.0)
    full, _ = pipeline.render_frame(scene, cam, lighting, cfg,
                                    shadow_target=target, backend=backend,
                                    device="cpu")
    out = {n: np.concatenate([sharding.render_band(
        scene, cam, lighting, b, n, cfg, shadow_target=target,
        backend=backend, device="cpu")[0].numpy() for b in range(n)])
        for n in bands}
    return full.numpy(), out


def over(banded, full, n, tol=1e-4):
    """Where the assembled bands differ from the unsharded frame by more
    than ``tol`` in a channel: the pixels, and the record printed for them.
    A band's last row takes its screen-space differences (texture LOD,
    normal-map frames) from the band's first row, where the frame takes
    them from the next band's, so those rows are counted apart."""
    d = np.abs(banded - full).max(-1)
    last = np.zeros(d.shape[0], bool)
    last[d.shape[0] // n - 1::d.shape[0] // n] = True
    ys, xs = np.nonzero(d > tol)
    return set(zip(ys.tolist(), xs.tolist())), {
        "pixels_over_1e-4": len(ys),
        "off_band_last_rows": int((d[~last] > tol).sum()),
        "max_abs_diff": float(d.max()),
        "max_off_band_last_rows": float(d[~last].max()),
        "first_pixels": sorted(zip(ys.tolist(), xs.tolist()))[:12]}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("case", choices=["flagship", "config3"])
    ap.add_argument("width", type=int)
    ap.add_argument("height", type=int)
    ap.add_argument("--bands", default="2,4",
                    help="band counts, comma-separated (default 2,4)")
    ap.add_argument("--triangles", type=int, default=100_000,
                    help="config 3's triangle target (default 100000)")
    ap.add_argument("--jax-backends", default="reference",
                    help="the JAX package's backends, comma-separated: "
                    "reference, pallas (interpret mode: slow); default "
                    "reference")
    a = ap.parse_args(argv)
    bands = [int(n) for n in a.bands.split(",")]
    if any(a.height % n for n in bands):
        ap.error(f"every band count must divide the height {a.height}")
    t0 = time.perf_counter()
    runs = {f"jax_{b}": jax_frames(a.case, a.width, a.height, bands,
                                   a.triangles, b)
            for b in a.jax_backends.split(",")}
    for backend in ("reference", "kernels"):
        runs[f"port_{backend}"] = port_frames(a.case, a.width, a.height,
                                              bands, a.triangles, backend)
    for n in bands:
        line = {"case": a.case, "size": f"{a.width}x{a.height}", "bands": n}
        sets = {}
        for name, (full, banded) in runs.items():
            sets[name], line[name] = over(banded[n], full, n)
        for name in sets:
            if name.startswith("port_"):
                line[name]["shared_with"] = {
                    jax: len(sets[name] & sets[jax])
                    for jax in sets if jax.startswith("jax_")}
        line["seconds"] = round(time.perf_counter() - t0, 1)
        print(json.dumps(line), flush=True)


if __name__ == "__main__":
    main()

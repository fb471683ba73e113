"""Typed configuration for the renderer.

The same frozen dataclasses as ``metalrenderer_tpu.config``: the reference
hard-codes every constant (window 800x600 mtl_engine.mm:133, MSAA 4
mtl_engine.hpp:146, shadow map 1024^2 mtl_engine.mm:582, clear color
41/42/48 mtl_engine.mm:609); here they are one hashable config object.
"""
from __future__ import annotations

import dataclasses

# Metal's standard 4x MSAA sample pattern (rotated grid), offsets within a
# pixel in [0,1)^2. 1x sampling uses the pixel center, matching Metal.
SAMPLE_POSITIONS = {
    1: ((0.5, 0.5),),
    4: ((0.375, 0.125), (0.875, 0.375), (0.125, 0.625), (0.625, 0.875)),
}


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Static render settings."""

    width: int = 800               # mtl_engine.mm:133 default window size
    height: int = 600
    msaa: int = 4                  # mtl_engine.hpp:146 sampleCount
    shadow_map_size: int = 1024    # mtl_engine.mm:582
    clear_color: tuple = (41.0 / 255.0, 42.0 / 255.0, 48.0 / 255.0, 1.0)
    clear_depth: float = 1.0       # mtl_engine.mm:612 / :633
    # Depth compare: LessEqual with write-on (mtl_engine.mm:436-439).
    # Culling: CCW front faces, back-cull (mtl_engine.mm:829-830).
    cull_backfaces: bool = True
    # Shadow compare semantics from BlinnPhong.metal:80-96.
    shadow_bias: float = 0.005
    shadow_factor: float = 0.5
    # Evaluate the shadow test once per PIXEL (first covered sample's
    # world position) instead of per MSAA sample. Matches Metal's
    # per-pixel fragment shading.
    shadow_per_pixel: bool = True
    # Run the WHOLE fragment stage once per PIXEL at the first covered
    # sample's attributes, keeping coverage/depth per sample — Metal's
    # fragment semantics (BlinnPhong.metal:40-97 runs per fragment, not
    # per sample; hardware resolves per-sample coverage,
    # mtl_engine.mm:615). False = supersampled shading.
    shading_per_pixel: bool = True
    # Fuse the whole fragment stage INTO the raster kernel when the scene
    # qualifies (untextured Blinn-Phong/emissive/shadow materials, point
    # light): only shaded RGBA leaves the kernel.
    fused_shade: bool = True
    # Binning tile of the main pass. The tile is also the anchor of the
    # plane arithmetic (planes are evaluated relative to the tile corner).
    tile_h: int = 8
    tile_w: int = 128
    # Binning tile (and plane anchor) of the depth-only shadow pass.
    shadow_tile_h: int = 64
    shadow_tile_w: int = 128
    # Binning: max tiles a triangle may span before it goes to the shared
    # "big" list; capacity of that list (overflow counted in stats).
    span_cap: int = 8
    big_capacity: int = 256
    # Near-plane epsilon: triangles with any vertex w <= eps are rejected.
    near_eps: float = 1e-6
    # True x/y guard-band clipping (raster/geometry.py guard_clip_xy):
    # triangles with a vertex beyond guard_band_px screen pixels are
    # homogeneously clipped to the guard box; up to xyclip_capacity such
    # triangles per frame, overflow counted in stats. 0 capacity disables.
    # Clipped pieces whose footprint spans many tiles land in the BIG
    # list, which fills in submission order; any piece that misses out is
    # counted in big_dropped.
    guard_band_px: float = 32768.0
    xyclip_capacity: int = 64

    def __post_init__(self):
        if self.msaa not in SAMPLE_POSITIONS:
            raise ValueError(
                f"msaa={self.msaa} unsupported; must be one of "
                f"{tuple(SAMPLE_POSITIONS)} (patterns are pinned — "
                "config.SAMPLE_POSITIONS)")
        # The guard box is centered on the viewport; it must CONTAIN it
        # or guard clipping would cut visible on-screen geometry.
        if self.xyclip_capacity > 0 and \
                self.guard_band_px < max(self.width, self.height) / 2:
            raise ValueError(
                f"guard_band_px={self.guard_band_px} is smaller than "
                f"half the viewport ({self.width}x{self.height}); the "
                "guard box must contain the screen")

    @property
    def sample_positions(self):
        return SAMPLE_POSITIONS[self.msaa]

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class ShadowConfig:
    """Directional/ortho shadow projection settings (mtl_engine.mm:645-646:
    ortho -8..8, near 0.1, far 15)."""

    left: float = -8.0
    right: float = 8.0
    bottom: float = -8.0
    top: float = 8.0
    near: float = 0.1
    far: float = 15.0

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)

"""Telemetry PNG dashboard — the ImGui overlay panel as an image; the
port's own copy of ``metalrenderer_tpu.utils.dashboard`` (the drawing is
the same numpy code, bit for bit).

The reference's live panel (mtl_engine.mm:880-933) shows RMS, rolling
average, a 20-4180 Hz spectrum PlotLines (auto-scaled from 0 to the
window max, mtl_engine.mm:915-916), band-energy readouts with display
boosts 5.0/0.8/3.0 (:921-924), pitch + confidence (:925-926), and the
MusicalContext (:928-930). SURVEY §5 calls for the same telemetry as an
optional PNG dashboard; this module renders one frame of it with pure
NumPy (no matplotlib — not in the image) and a built-in 3x5 bitmap
font, so the output is deterministic and golden-testable.

Wired into ``cli analyze --dashboard DIR`` (one PNG per 1024-sample
chunk, mirroring the per-buffer refresh of the live panel).
"""
from __future__ import annotations

import numpy as np

from . import stats as stats_mod

BG = (30, 31, 36)          # panel gray-blue, close to ImGui's dark theme
FG = (220, 220, 225)
DIM = (90, 92, 100)
ACCENT = (120, 180, 255)   # spectrum line
BAR_COLORS = ((235, 110, 95), (235, 200, 95), (110, 220, 140))

# 3x5 font: rows top->bottom, 3-bit masks (MSB = left pixel).
_FONT = {
    "0": (0b111, 0b101, 0b101, 0b101, 0b111),
    "1": (0b010, 0b110, 0b010, 0b010, 0b111),
    "2": (0b111, 0b001, 0b111, 0b100, 0b111),
    "3": (0b111, 0b001, 0b111, 0b001, 0b111),
    "4": (0b101, 0b101, 0b111, 0b001, 0b001),
    "5": (0b111, 0b100, 0b111, 0b001, 0b111),
    "6": (0b111, 0b100, 0b111, 0b101, 0b111),
    "7": (0b111, 0b001, 0b010, 0b010, 0b010),
    "8": (0b111, 0b101, 0b111, 0b101, 0b111),
    "9": (0b111, 0b101, 0b111, 0b001, 0b111),
    ".": (0b000, 0b000, 0b000, 0b000, 0b010),
    "-": (0b000, 0b000, 0b111, 0b000, 0b000),
    ":": (0b000, 0b010, 0b000, 0b010, 0b000),
    "|": (0b010, 0b010, 0b010, 0b010, 0b010),
    "X": (0b101, 0b101, 0b010, 0b101, 0b101),
    " ": (0b000, 0b000, 0b000, 0b000, 0b000),
    "A": (0b010, 0b101, 0b111, 0b101, 0b101),
    "B": (0b110, 0b101, 0b110, 0b101, 0b110),
    "C": (0b011, 0b100, 0b100, 0b100, 0b011),
    "D": (0b110, 0b101, 0b101, 0b101, 0b110),
    "E": (0b111, 0b100, 0b110, 0b100, 0b111),
    "F": (0b111, 0b100, 0b110, 0b100, 0b100),
    "G": (0b011, 0b100, 0b101, 0b101, 0b011),
    "H": (0b101, 0b101, 0b111, 0b101, 0b101),
    "I": (0b111, 0b010, 0b010, 0b010, 0b111),
    "K": (0b101, 0b110, 0b100, 0b110, 0b101),
    "L": (0b100, 0b100, 0b100, 0b100, 0b111),
    "M": (0b101, 0b111, 0b111, 0b101, 0b101),
    "N": (0b101, 0b111, 0b111, 0b111, 0b101),
    "O": (0b010, 0b101, 0b101, 0b101, 0b010),
    "P": (0b110, 0b101, 0b110, 0b100, 0b100),
    "R": (0b110, 0b101, 0b110, 0b110, 0b101),
    "S": (0b011, 0b100, 0b010, 0b001, 0b110),
    "T": (0b111, 0b010, 0b010, 0b010, 0b010),
    "U": (0b101, 0b101, 0b101, 0b101, 0b111),
    "V": (0b101, 0b101, 0b101, 0b101, 0b010),
    "W": (0b101, 0b101, 0b111, 0b111, 0b101),
    "Y": (0b101, 0b101, 0b010, 0b010, 0b010),
    "J": (0b001, 0b001, 0b001, 0b101, 0b010),
    "Q": (0b010, 0b101, 0b101, 0b011, 0b001),
    "Z": (0b111, 0b001, 0b010, 0b100, 0b111),
}


def draw_text(img, x, y, text, color=FG, scale=1):
    """Blit 3x5 bitmap text; 1-px letter spacing. Returns end x."""
    h, w = img.shape[:2]
    col = np.asarray(color, np.uint8)
    for ch in str(text).upper():
        glyph = _FONT.get(ch, _FONT[" "])
        for r, bits in enumerate(glyph):
            for c in range(3):
                if bits & (0b100 >> c):
                    y0 = y + r * scale
                    x0 = x + c * scale
                    img[max(0, y0):max(0, min(h, y0 + scale)),
                        max(0, x0):max(0, min(w, x0 + scale)), :3] = col
        x += (3 + 1) * scale
    return x


def _rect(img, x0, y0, x1, y1, color):
    img[max(0, y0):max(0, y1), max(0, x0):max(0, x1), :3] = \
        np.asarray(color, np.uint8)


def _plot(img, x0, y0, w, h, values, color=ACCENT, vmax=None):
    """ImGui-PlotLines-like area plot: y scaled [0, vmax] (vmax = data
    max when None, the FLT_MAX auto-scale of mtl_engine.mm:916)."""
    _rect(img, x0, y0, x0 + w, y0 + h, (22, 23, 27))
    values = np.asarray(values, np.float64)
    if values.size == 0:
        return
    if vmax is None:
        vmax = float(values.max())
    vmax = vmax if vmax > 0 else 1.0
    # Column-resample (min/max per column so narrow peaks survive);
    # bridge to the previous column's extent so the polyline is
    # connected like ImGui's line plot.
    cols = np.linspace(0, values.size, w + 1).astype(int)
    prev = None
    for cx in range(w):
        seg = values[cols[cx]:max(cols[cx] + 1, cols[cx + 1])]
        if seg.size == 0:
            continue
        lo = int(np.clip(seg.min() / vmax, 0, 1) * (h - 1))
        hi = int(np.clip(seg.max() / vmax, 0, 1) * (h - 1))
        dlo, dhi = (lo, hi) if prev is None else (min(lo, prev),
                                                 max(hi, prev))
        img[y0 + h - 1 - dhi:y0 + h - dlo, x0 + cx, :3] = \
            np.asarray(color, np.uint8)
        prev = (lo + hi) // 2


def render_dashboard(rms, rolling_avg, spectrum, bass, mid, treble,
                     pitch_hz, pitch_confidence, context=None,
                     sample_rate=48000.0, fps=None, size=(384, 232)):
    """Render one telemetry frame to RGBA uint8 [H, W, 4].

    Inputs are the AnalysisResult fields for ONE chunk (scalars +
    f32[513] spectrum) and an optional MusicalContext. Semantics mirror
    the panel: spectrum sliced to 20-4180 Hz and auto-scaled
    (mtl_engine.mm:902-916); band readouts use the DISPLAY boosts
    5.0/0.8/3.0 (:921-924), not the interpreter's.
    """
    w, h = size
    img = np.empty((h, w, 4), np.uint8)
    img[..., :3] = BG
    img[..., 3] = 255
    m = 8

    y = m
    draw_text(img, m, y, "AUDIO TELEMETRY", DIM)
    y += 10
    draw_text(img, m, y, f"RMS {float(rms):.4f}   AVG "
                         f"{float(rolling_avg):.4f}"
                         + (f"   FPS {fps:.1f}" if fps is not None else ""))
    y += 10

    # Spectrum 20-4180 Hz (PlotLines 300x80).
    draw_text(img, m, y, "SPECTRUM 20-4180 HZ", DIM)
    y += 8
    _, mags = stats_mod.spectrum_rows(spectrum, sample_rate)
    _plot(img, m, y, 300, 80, mags)
    y += 80 + 6

    # Band bars with display boosts.
    disp = stats_mod.display_bands(bass, mid, treble)
    bar_w, bar_h = 56, 36
    bmax = max(disp["bass"], disp["mid"], disp["treble"], 1e-6)
    for i, (name, key) in enumerate((("BASS", "bass"), ("MID", "mid"),
                                     ("TREB", "treble"))):
        x0 = m + i * (bar_w + 14)
        _rect(img, x0, y, x0 + bar_w, y + bar_h, (22, 23, 27))
        bh = int(np.clip(disp[key] / bmax, 0, 1) * bar_h)
        _rect(img, x0, y + bar_h - bh, x0 + bar_w, y + bar_h,
              BAR_COLORS[i])
        draw_text(img, x0, y + bar_h + 3, f"{name} {disp[key]:.2f}")
    y += bar_h + 14

    draw_text(img, m, y, f"PITCH {float(pitch_hz):.1f} HZ   CONF "
                         f"{float(pitch_confidence):.2f}")
    y += 10
    if context is not None:
        draw_text(
            img, m, y,
            f"ENERGY {float(context.energy):.2f}   BRIGHT "
            f"{float(context.brightness):.2f}   MELANCH "
            f"{float(context.melancholy):.2f}")
    return img


def render_result_dashboard(result, chunk_index, context=None,
                            sample_rate=48000.0, fps=None):
    """Dashboard for chunk ``chunk_index`` of a batched AnalysisResult (and
    MusicalContext), whose fields are tensors on any device: the chunk's
    values come to the host as numpy."""
    i = chunk_index

    def pick(x):
        if hasattr(x, "detach"):
            x = x.detach()
            x = x[i] if x.dim() > 0 and x.shape[0] > i else x
            return x.cpu().numpy()
        arr = np.asarray(x)
        return arr[i] if arr.ndim > 0 and arr.shape[0] > i else arr

    ctx = None
    if context is not None:
        class _C:  # noqa: N801 — tiny value holder
            energy = pick(context.energy)
            brightness = pick(context.brightness)
            melancholy = pick(context.melancholy)
        ctx = _C
    return render_dashboard(
        pick(result.rms), pick(result.rolling_avg),
        pick(result.spectrum), pick(result.bass),
        pick(result.mid), pick(result.treble), pick(result.pitch_hz),
        pick(result.pitch_confidence), context=ctx,
        sample_rate=sample_rate, fps=fps)

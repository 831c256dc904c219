"""Optional ICC -> sRGB read transform (rwpng.c:309-392, `#if USE_LCMS`).

The reference can be compiled against Little CMS; in that build it
transforms input pixels to sRGB when the PNG carries

  * an embedded iCCP profile in the RGB colorspace on a color image
    (rwpng.c:323-341), or
  * gAMA + cHRM chunks (and no sRGB chunk) on a color image, from which
    it synthesizes an RGB matrix profile (rwpng.c:343-369),

then tags the output sRGB and sets gamma to 0.45455 (rwpng.c:371-392).
A GRAY profile on a gray image is ignored with a warning but still tags
the output sRGB (rwpng.c:333-336).

This module reproduces that behavior in pure numpy, gated by
``PNGLOSS_ICC=1`` (the reference's default build has USE_LCMS off, and
byte parity with the default build requires the transform stay off).
Scope: matrix-shaper profiles (rXYZ/gXYZ/bXYZ + rTRC/gTRC/bTRC with
'curv'/'para' curves) — the kind every PNG-embedded display profile is —
plus LUT-based profiles through their A2B0 pipeline (lut8/lut16/lutAToB
tag types, tetrahedral CLUT interpolation — per-channel grid sizes for
lutAToB — XYZ and Lab PCS encodings); validated against real Little CMS
(tests/test_icc.py).

Rounding policy (the one deliberate deviation from lcms): the whole
transform runs in float64 and quantizes to 8 bits ONCE at the end with
``np.rint`` (round-half-to-even). lcms walks 16-bit intermediate tables
and rounds half-away at the final stage, so pixels whose true value
lands within ~1/2 LSB of a code boundary may differ by one code value
(tests/test_icc.py::test_rounding_boundary_envelope pins the envelope:
|ours - lcms| <= 1 on boundary-hugging inputs, <= 3 in general). This
is not byte-anchorable: the reference's USE_LCMS build is non-default,
no oracle for it exists on this box, and lcms's own output varies by
version/flags (its optimized device-link path differs from its own
un-optimized pipeline by up to 15 LSB on LUT profiles).
"""

from __future__ import annotations

import struct
import sys
import zlib

import numpy as np

# verbose notes, printed by the CLI exactly as pngloss.c:241-249 does
NOTE_ICCP = "iccp"
NOTE_GAMA_CHRM = "gama_chrm"
NOTE_ICCP_WARN_GRAY = "iccp_warn_gray"

_D50 = np.array([0.9642, 1.0, 0.8249])
_BRADFORD = np.array([
    [0.8951, 0.2664, -0.1614],
    [-0.7502, 1.7135, 0.0367],
    [0.0389, -0.0685, 1.0296],
])


def enabled() -> bool:
    import os

    return os.environ.get("PNGLOSS_ICC", "0") == "1"


# ---------------------------------------------------------------- chunks


def scan_color_chunks(data: bytes) -> dict:
    """Pull IHDR color type + iCCP/sRGB/gAMA/cHRM out of raw PNG bytes
    (pre-IDAT by spec). Returns {} if the stream is not a PNG."""
    out: dict = {"color_type": None, "iccp": None, "srgb": False,
                 "gamma": None, "chrm": None}
    if len(data) < 8 or data[:8] != b"\x89PNG\r\n\x1a\n":
        return out
    pos = 8
    n = len(data)
    while pos + 8 <= n:
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        name = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        if len(body) != length:
            break
        if name == b"IHDR" and length >= 13:
            out["color_type"] = body[9]
        elif name == b"iCCP":
            # name\0 compression-method, then zlib profile
            z = body.find(b"\x00")
            if 0 <= z and z + 2 <= len(body):
                try:
                    out["iccp"] = zlib.decompress(body[z + 2:])
                except zlib.error:
                    pass
        elif name == b"sRGB":
            out["srgb"] = True
        elif name == b"gAMA" and length == 4:
            (g,) = struct.unpack(">I", body)
            if g:
                out["gamma"] = g / 100000.0
        elif name == b"cHRM" and length == 32:
            vals = struct.unpack(">8I", body)
            out["chrm"] = tuple(v / 100000.0 for v in vals)
        elif name in (b"IDAT", b"IEND"):
            break
        pos += 12 + length
    return out


# ---------------------------------------------------------- ICC parsing


def _s15f16(b: bytes, off: int) -> float:
    (v,) = struct.unpack(">i", b[off:off + 4])
    return v / 65536.0


def _parse_curve(tag: bytes):
    """'curv'/'para' tag -> linearization f: [0,1] -> [0,1] (vectorized)."""
    sig = tag[:4]
    if sig == b"curv":
        (count,) = struct.unpack(">I", tag[8:12])
        if count == 0:
            return lambda x: x
        if len(tag) < 12 + 2 * count:
            return None   # truncated table: unusable curve, skip transform
        if count == 1:
            (g,) = struct.unpack(">H", tag[12:14])
            gamma = g / 256.0
            return lambda x: np.power(x, gamma)
        lut = np.frombuffer(tag[12:12 + 2 * count], dtype=">u2").astype(
            np.float64) / 65535.0
        xs = np.linspace(0.0, 1.0, count)
        return lambda x: np.interp(x, xs, lut)
    if sig == b"para":
        (ftype,) = struct.unpack(">H", tag[8:10])
        # Types 0-4 carry 1/3/4/5/7 params; real profiles are sized to
        # exactly that, so read only what is present (ICC.1 table 68).
        navail = max(0, min(7, (len(tag) - 12) // 4))
        nneed = {0: 1, 1: 3, 2: 4, 3: 5, 4: 7}.get(ftype)
        if nneed is None or navail < nneed:
            return None
        p = [_s15f16(tag, 12 + 4 * i) for i in range(navail)]
        g, a, b, c, d, e, f = (p + [0.0] * 7)[:7]
        if ftype in (1, 2) and a == 0.0:
            return None   # breakpoint -b/a undefined: unusable curve

        def _pw(base, g=g):
            # clamp: a malformed profile can select a negative power base
            # (a*d+b < 0) whose NaN would otherwise reach the pixel cast
            return np.power(np.maximum(base, 0.0), g)

        if ftype == 0:
            return lambda x: _pw(x)
        if ftype == 1:
            return lambda x: np.where(x >= -b / a, _pw(a * x + b), 0.0)
        if ftype == 2:
            return lambda x: np.where(x >= -b / a, _pw(a * x + b) + c, c)
        if ftype == 3:
            return lambda x: np.where(x >= d, _pw(a * x + b), c * x)
        if ftype == 4:
            return lambda x: np.where(x >= d, _pw(a * x + b) + e, c * x + f)
    return None


def _tag_table(profile: bytes) -> dict | None:
    if len(profile) < 132:
        return None
    (count,) = struct.unpack(">I", profile[128:132])
    tags = {}
    for i in range(count):
        off = 132 + 12 * i
        if off + 12 > len(profile):
            return None
        sig = profile[off:off + 4]
        o, sz = struct.unpack(">II", profile[off + 4:off + 12])
        if o + sz > len(profile):
            return None
        tags[sig] = profile[o:o + sz]
    return tags


def parse_matrix_shaper(profile: bytes):
    """(M 3x3 RGB->XYZ(D50), [fr, fg, fb] linearization curves) or None.

    Returns None for LUT-based profiles (no rXYZ) — callers then try
    parse_a2b (the A2B0 pipeline) before giving up."""
    tags = _tag_table(profile)
    if tags is None:
        return None
    need = (b"rXYZ", b"gXYZ", b"bXYZ", b"rTRC", b"gTRC", b"bTRC")
    if any(t not in tags for t in need):
        return None
    cols = []
    for t in (b"rXYZ", b"gXYZ", b"bXYZ"):
        body = tags[t]
        if body[:4] != b"XYZ " or len(body) < 20:
            return None
        cols.append([_s15f16(body, 8), _s15f16(body, 12), _s15f16(body, 16)])
    m = np.array(cols).T                      # columns = r/g/b XYZ
    curves = []
    for t in (b"rTRC", b"gTRC", b"bTRC"):
        f = _parse_curve(tags[t])
        if f is None:
            return None
        curves.append(f)
    return m, curves


def profile_colorspace(profile: bytes) -> bytes:
    return profile[16:20] if len(profile) >= 20 else b""


def profile_pcs(profile: bytes) -> bytes:
    return profile[20:24] if len(profile) >= 24 else b""


# ------------------------------------------------- LUT (A2B0) profiles


_D50_WHITE = _D50  # PCS illuminant (ICC.1: PCS is always D50)


def _lab_to_xyz(lab: np.ndarray) -> np.ndarray:
    """CIE Lab (D50) -> XYZ (D50); lab: (N, 3) float."""
    fy = (lab[:, 0] + 16.0) / 116.0
    fx = fy + lab[:, 1] / 500.0
    fz = fy - lab[:, 2] / 200.0
    f = np.stack([fx, fy, fz], axis=1)
    d = 6.0 / 29.0
    lin = np.where(f > d, f ** 3, 3.0 * d * d * (f - 4.0 / 29.0))
    return lin * _D50_WHITE[None, :]


def _interp_curve_tables(tables: np.ndarray, x: np.ndarray) -> np.ndarray:
    """Per-channel 1-D table lookup: tables (C, N) in [0,1], x (P, C)."""
    out = np.empty_like(x)
    for c in range(tables.shape[0]):
        n = tables.shape[1]
        xs = np.linspace(0.0, 1.0, n)
        out[:, c] = np.interp(x[:, c], xs, tables[c])
    return out


def _clut_tetrahedral(clut: np.ndarray, x: np.ndarray) -> np.ndarray:
    """Tetrahedral interpolation of a 3-D CLUT (the interpolator lcms uses
    for 3-channel tables). clut: (g0, g1, g2, out_ch) in [0,1] — per-axis
    grid sizes, as lutAToB allows (mft1/mft2 tables are always cubic) —
    first input channel on axis 0; x: (P, 3) in [0,1]. Returns
    (P, out_ch)."""
    g = np.array(clut.shape[:3], np.int64)
    t = np.clip(x, 0.0, 1.0) * (g - 1)[None, :]
    i0 = np.minimum(t.astype(np.int64), (g - 2)[None, :])
    f = t - i0                                  # fractional parts (P, 3)

    def at(di, dj, dk):
        return clut[i0[:, 0] + di, i0[:, 1] + dj, i0[:, 2] + dk]

    c000 = at(0, 0, 0)
    c111 = at(1, 1, 1)
    fx, fy, fz = f[:, 0:1], f[:, 1:2], f[:, 2:3]
    # six tetrahedra by the ordering of (fx, fy, fz)
    out = np.empty_like(c000)
    conds = [
        (fx >= fy) & (fy >= fz),
        (fx >= fz) & (fz > fy),
        (fz > fx) & (fx >= fy),
        (fy > fx) & (fx >= fz),
        (fy >= fz) & (fz > fx),
        (fz > fy) & (fy > fx),
    ]
    exprs = [
        lambda: c000 + fx * (at(1, 0, 0) - c000) + fy * (at(1, 1, 0) - at(1, 0, 0)) + fz * (c111 - at(1, 1, 0)),
        lambda: c000 + fx * (at(1, 0, 0) - c000) + fy * (c111 - at(1, 0, 1)) + fz * (at(1, 0, 1) - at(1, 0, 0)),
        lambda: c000 + fx * (at(1, 0, 1) - at(0, 0, 1)) + fy * (c111 - at(1, 0, 1)) + fz * (at(0, 0, 1) - c000),
        lambda: c000 + fx * (at(1, 1, 0) - at(0, 1, 0)) + fy * (at(0, 1, 0) - c000) + fz * (c111 - at(1, 1, 0)),
        lambda: c000 + fx * (c111 - at(0, 1, 1)) + fy * (at(0, 1, 0) - c000) + fz * (at(0, 1, 1) - at(0, 1, 0)),
        lambda: c000 + fx * (c111 - at(0, 1, 1)) + fy * (at(0, 1, 1) - at(0, 0, 1)) + fz * (at(0, 0, 1) - c000),
    ]
    filled = np.zeros(len(c000), bool)
    for cond, expr in zip(conds, exprs):
        m = cond[:, 0] & ~filled
        if m.any():
            out[m] = expr()[m]
            filled |= m
    return out


def _parse_mft(tag: bytes):
    """'mft1'/'mft2' (lut8/lut16Type) -> (in_tables (3,N), clut
    (g,g,g,3), out_tables (3,M)) or None. The tag's 3x3 matrix is not
    parsed: it applies only when the input space is XYZ (ICC.1
    10.8/10.9) and these profiles are device-RGB on the input side."""
    sig = tag[:4]
    if len(tag) < 52 or tag[8] != 3 or tag[9] != 3:
        return None                       # 3-in/3-out only (RGB -> PCS)
    grid = tag[10]
    if grid < 2:
        return None
    if sig == b"mft1":
        n_in = n_out = 256
        off = 48
        width, scale = 1, 255.0
        dt = np.uint8
    else:
        n_in, n_out = struct.unpack(">HH", tag[48:52])
        off = 52
        width, scale = 2, 65535.0
        dt = ">u2"
    need = width * (3 * n_in + grid ** 3 * 3 + 3 * n_out)
    if len(tag) < off + need or not (2 <= n_in <= 4096 and 2 <= n_out <= 4096):
        return None
    raw = np.frombuffer(tag, dt, count=3 * n_in, offset=off)
    in_t = raw.reshape(3, n_in).astype(np.float64) / scale
    off += width * 3 * n_in
    clut = np.frombuffer(tag, dt, count=grid ** 3 * 3, offset=off).reshape(
        grid, grid, grid, 3).astype(np.float64) / scale
    off += width * grid ** 3 * 3
    out_t = np.frombuffer(tag, dt, count=3 * n_out, offset=off).reshape(
        3, n_out).astype(np.float64) / scale
    return in_t, clut, out_t


def _parse_mab_curves(tag: bytes, off: int, n: int):
    """n concatenated 'curv'/'para' tags starting at off (each padded to a
    4-byte boundary) -> list of callables, or None."""
    fns = []
    for _ in range(n):
        if off + 12 > len(tag):
            return None
        sig = tag[off:off + 4]
        if sig == b"curv":
            (count,) = struct.unpack(">I", tag[off + 8:off + 12])
            size = 12 + 2 * count
        elif sig == b"para":
            (ftype,) = struct.unpack(">H", tag[off + 8:off + 10])
            nparam = {0: 1, 1: 3, 2: 4, 3: 5, 4: 7}.get(ftype)
            if nparam is None:
                return None
            size = 12 + 4 * nparam
        else:
            return None
        f = _parse_curve(tag[off:off + size])
        if f is None:
            return None
        fns.append(f)
        off += (size + 3) & ~3
    return fns


def _parse_mab(tag: bytes):
    """'mAB ' (lutAToBType) -> transform fn (P,3 in [0,1]) -> PCS floats.

    Pipeline (device->PCS): A curves -> CLUT -> M curves -> matrix ->
    B curves; absent stages (offset 0) are identity."""
    if len(tag) < 32 or tag[8] != 3 or tag[9] != 3:
        return None
    ob, omat, om, oclut, oa = struct.unpack(">5I", tag[12:32])

    a_fns = _parse_mab_curves(tag, oa, 3) if oa else None
    m_fns = _parse_mab_curves(tag, om, 3) if om else None
    b_fns = _parse_mab_curves(tag, ob, 3) if ob else None
    if (oa and a_fns is None) or (om and m_fns is None) \
            or (ob and b_fns is None):
        return None

    clut = None
    if oclut:
        if oclut + 20 > len(tag):
            return None
        # lutAToB grids may differ per input channel (ICC.1 10.12: one
        # grid-points byte per channel) — unlike the always-cubic mft LUTs
        g0, g1, g2 = tag[oclut], tag[oclut + 1], tag[oclut + 2]
        prec = tag[oclut + 16]
        if prec not in (1, 2):
            return None          # ICC.1 allows only 8- or 16-bit CLUTs
        dt, scale = ((np.uint8, 255.0) if prec == 1 else (">u2", 65535.0))
        count = g0 * g1 * g2 * 3
        if oclut + 20 + count * prec > len(tag) or min(g0, g1, g2) < 2:
            return None
        clut = np.frombuffer(tag, dt, count=count, offset=oclut + 20).reshape(
            g0, g1, g2, 3).astype(np.float64) / scale

    mat = None
    if omat:
        if omat + 48 > len(tag):
            return None
        v = [_s15f16(tag, omat + 4 * i) for i in range(12)]
        mat = (np.array(v[:9]).reshape(3, 3), np.array(v[9:]))

    def apply_fns(fns, x):
        if fns is None:
            return x
        out = np.empty_like(x)
        for c in range(3):
            out[:, c] = np.clip(fns[c](np.clip(x[:, c], 0.0, 1.0)), 0.0, 1.0)
        return out

    def transform(x):
        x = apply_fns(a_fns, x)
        if clut is not None:
            x = _clut_tetrahedral(clut, x)
        x = apply_fns(m_fns, x)
        if mat is not None:
            x = x @ mat[0].T + mat[1][None, :]
        return apply_fns(b_fns, x)

    return transform


# ICC v4 perceptual reference medium black point (v4 spec; what lcms
# subtracts when building the input pipeline of a v4 LUT profile under
# INTENT_PERCEPTUAL — the intent rwpng's transform always requests)
_V4_PERCEPTUAL_BLACK = np.array([0.00336, 0.0034731, 0.00287])


def profile_version(profile: bytes) -> int:
    """Encoded ICC version from the header (e.g. 0x04300000)."""
    if len(profile) < 12:
        return 0
    return struct.unpack(">I", profile[8:12])[0]


def parse_a2b(profile: bytes):
    """A2B0 pipeline of a LUT-based RGB profile -> fn (P,3 device floats)
    -> (P,3) XYZ(D50), or None. Handles lut8/lut16/lutAToB tag types and
    both PCS encodings (XYZ, Lab legacy/v4).

    For version >= 4 profiles the returned XYZ is normalized from the v4
    perceptual PCS (reference-medium black, nonzero) to zero-black:
    XYZ' = (XYZ - bp) * wp / (wp - bp).  This reproduces what Little CMS
    does to a v4 LUT profile under INTENT_PERCEPTUAL (the intent the
    reference's transform requests, rwpng.c:309-392) — fitted and
    verified against ImageCms in tests/test_icc.py (matrix-shaper
    profiles do NOT get the adjustment, matching lcms's behavior)."""
    tags = _tag_table(profile)
    if tags is None or b"A2B0" not in tags:
        return None
    tag = tags[b"A2B0"]
    pcs = profile_pcs(profile)
    sig = tag[:4]
    if sig in (b"mft1", b"mft2"):
        parsed = _parse_mft(tag)
        if parsed is None:
            return None
        in_t, clut, out_t = parsed

        def pipeline(x):
            x = _interp_curve_tables(in_t, x)
            x = _clut_tetrahedral(clut, x)
            return _interp_curve_tables(out_t, x)

        legacy_lab = sig == b"mft2"
    elif sig == b"mAB ":
        pipeline = _parse_mab(tag)
        if pipeline is None:
            return None
        legacy_lab = False
    else:
        return None

    v4_percep = profile_version(profile) >= 0x04000000

    def to_xyz(x):
        y = pipeline(x)
        if pcs == b"Lab ":
            if legacy_lab:
                # lut16 legacy encoding: L max at 0xFF00/0xFFFF
                lab = np.stack([
                    y[:, 0] * (65535.0 / 65280.0) * 100.0,
                    y[:, 1] * (65535.0 / 65280.0) * 255.0 - 128.0,
                    y[:, 2] * (65535.0 / 65280.0) * 255.0 - 128.0,
                ], axis=1)
            else:
                lab = np.stack([
                    y[:, 0] * 100.0,
                    y[:, 1] * 255.0 - 128.0,
                    y[:, 2] * 255.0 - 128.0,
                ], axis=1)
            xyz = _lab_to_xyz(lab)
        else:
            # PCS XYZ: encoding max 0xFFFF = 1.99997 (u1Fixed15)
            xyz = y * (65535.0 / 32768.0)
        if v4_percep:
            bp, wp = _V4_PERCEPTUAL_BLACK, _D50
            xyz = (xyz - bp[None, :]) * (wp / (wp - bp))[None, :]
        return xyz

    return to_xyz


# ----------------------------------------------------------- colorimetry


def _xy_to_xyz(x: float, y: float) -> np.ndarray:
    return np.array([x / y, 1.0, (1.0 - x - y) / y])


def _bradford_adapt(src_white: np.ndarray, dst_white: np.ndarray) -> np.ndarray:
    cs = _BRADFORD @ src_white
    cd = _BRADFORD @ dst_white
    return np.linalg.inv(_BRADFORD) @ np.diag(cd / cs) @ _BRADFORD


def rgb_matrix_from_chrm(chrm, dst_white: np.ndarray = _D50) -> np.ndarray:
    """RGB->XYZ(dst_white) matrix from cHRM primaries + white point, the
    way cmsCreateRGBProfile builds matrix profiles (white-scaled columns,
    Bradford-adapted into the PCS)."""
    wx, wy, rx, ry, gx, gy, bx, by = chrm
    prim = np.stack([_xy_to_xyz(rx, ry), _xy_to_xyz(gx, gy),
                     _xy_to_xyz(bx, by)], axis=1)
    white = _xy_to_xyz(wx, wy)
    scale = np.linalg.solve(prim, white)
    m = prim * scale[None, :]
    return _bradford_adapt(white, dst_white) @ m


_SRGB_CHRM = (0.3127, 0.3290, 0.64, 0.33, 0.30, 0.60, 0.15, 0.06)
_M_SRGB_D50 = rgb_matrix_from_chrm(_SRGB_CHRM)          # sRGB -> XYZ(D50)
_M_D50_SRGB = np.linalg.inv(_M_SRGB_D50)                # XYZ(D50) -> sRGB


def _srgb_encode(lin: np.ndarray) -> np.ndarray:
    lin = np.clip(lin, 0.0, 1.0)
    return np.where(lin <= 0.0031308,
                    12.92 * lin,
                    1.055 * np.power(lin, 1.0 / 2.4) - 0.055)


def transform_rgba_lut(rgba: np.ndarray, to_xyz) -> np.ndarray:
    """A2B0-pipeline transform of (H, W, 4) uint8 RGBA to sRGB (alpha
    untouched): device RGB -> LUT pipeline -> XYZ(D50) -> sRGB."""
    h, w = rgba.shape[:2]
    out = rgba.copy()
    x = rgba[:, :, :3].reshape(-1, 3).astype(np.float64) / 255.0
    xyz = to_xyz(x)
    srgb_lin = xyz @ _M_D50_SRGB.T
    enc = _srgb_encode(srgb_lin).reshape(h, w, 3)
    out[:, :, :3] = np.clip(np.rint(enc * 255.0), 0, 255).astype(np.uint8)
    return out


def transform_rgba(rgba: np.ndarray, m_in: np.ndarray, curves) -> np.ndarray:
    """Relative-colorimetric matrix transform of (H, W, 4) uint8 RGBA to
    sRGB (alpha untouched). LCMS's perceptual intent degrades to this for
    matrix-shaper profiles (no gamut mapping tables to apply)."""
    h, w = rgba.shape[:2]
    out = rgba.copy()
    rgb = rgba[:, :, :3].astype(np.float64) / 255.0
    lin = np.empty_like(rgb)
    for c in range(3):
        # 256-entry LUT: exact for 8-bit inputs, one curve eval per level
        lut = np.clip(curves[c](np.linspace(0.0, 1.0, 256)), 0.0, 1.0)
        lin[:, :, c] = lut[rgba[:, :, c]]
    xyz = lin.reshape(-1, 3) @ m_in.T
    srgb_lin = xyz @ _M_D50_SRGB.T
    enc = _srgb_encode(srgb_lin).reshape(h, w, 3)
    out[:, :, :3] = np.clip(np.rint(enc * 255.0), 0, 255).astype(np.uint8)
    return out


# ------------------------------------------------------------ entry point


def apply(data: bytes, img) -> str | None:
    """rwpng.c:309-392 decision tree. Mutates img (rgba / gamma /
    color_transform) in place; returns the verbose-note id or None."""
    from pngloss_jax.codec import pypng

    info = scan_color_chunks(data)
    ct = info["color_type"]
    if ct is None:
        return None
    color_png = bool(ct & 2)                  # PNG_COLOR_MASK_COLOR

    profile = info["iccp"]
    m_curves = None
    note = None
    if profile is not None:
        cs = profile_colorspace(profile)
        if cs == b"RGB " and color_png:
            parsed = parse_matrix_shaper(profile)
            if parsed is None:
                to_xyz = parse_a2b(profile)
                if to_xyz is None:
                    print("pngloss-jax: unusable iCCP profile (neither "
                          "matrix-shaper nor A2B0 LUT); skipping ICC "
                          "transform", file=sys.stderr)
                    return None     # lcms would transform; we cannot — bail
                # LUT-based profile (rwpng.c:309-392 handles these through
                # lcms's A2B0 pipeline; same pipeline here in float)
                img.rgba = transform_rgba_lut(img.rgba, to_xyz)
                img.gamma = 0.45455
                img.color_transform = pypng.COLOR_SRGB
                return NOTE_ICCP
            m_curves = parsed
            note = NOTE_ICCP
        elif cs == b"GRAY" and not color_png:
            # ignored with a warning, but the output is tagged sRGB
            # (rwpng.c:333-336)
            img.color_transform = pypng.COLOR_SRGB
            return NOTE_ICCP_WARN_GRAY

    if (m_curves is None and note is None and color_png
            and not info["srgb"] and info["gamma"] is not None
            and info["chrm"] is not None):
        gamma = info["gamma"]
        m = rgb_matrix_from_chrm(info["chrm"])
        g = 1.0 / gamma
        curves = [lambda x, g=g: np.power(x, g)] * 3
        m_curves = (m, curves)
        note = NOTE_GAMA_CHRM

    if m_curves is None:
        return None
    m, curves = m_curves
    img.rgba = transform_rgba(img.rgba, m, curves)
    img.gamma = 0.45455
    img.color_transform = pypng.COLOR_SRGB
    return note

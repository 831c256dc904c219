"""Pure-Python/numpy PNG codec.

This is the correctness-reference host codec for pngloss-jax. It replaces the
reference's libpng wrapper (see the reference's src/rwpng.c) with a standalone
implementation on top of the system zlib, reproducing exactly the normalizations
the reference applies on read and the packing/filtering/deflate behavior libpng
exhibits on write, so that output files are byte-identical to the C tool.

Decode (rwpng.c:179-400 behavior):
  * every input is normalized to 8-bit RGBA rows:
      - palette expanded to RGB (+tRNS alpha)           (rwpng.c:240-241)
      - low-bit-depth gray expanded to 8 bits
      - tRNS expanded to a full alpha channel
      - 16-bit samples stripped to their high byte      (rwpng.c:250-252)
      - gray replicated to RGB                          (rwpng.c:254-256)
      - opaque filler alpha=255 added when no alpha     (rwpng.c:241)
      - Adam7 interlacing resolved
  * gamma/sRGB bookkeeping mirrors rwpng.c:258-275 (color transform tag only;
    no pixel-value gamma conversion happens in the reference without LCMS).
  * ancillary chunk preservation: pHYs/iTXt/tEXt/zTXt and unknown
    safe-to-copy chunks are kept unless strip=True; iCCP/cHRM/gAMA are never
    kept as raw chunks (rwpng.c:129-156, 210-218).

Encode (rwpng.c:445-637 behavior):
  * gray/alpha re-detected on the final pixels (rwpng.c:557-573)
  * packed to GRAY / GRAY+ALPHA / RGB / RGBA (rwpng.c:576-624)
  * row 0 filter chosen by libpng's minimum-sum-of-absolute-differences
    heuristic; rows >= 1 use the caller-forced filter (rwpng.c:488-495)
  * zlib level 9, memLevel 9, 8192-byte IDAT chunking — matches libpng's
    default zbuffer flushing, giving byte-identical streams with the same
    system zlib (rwpng.c:471-472)
  * maximum_file_size enforcement -> TOO_LARGE_FILE (rwpng.c:631-633)
"""

from __future__ import annotations

import struct
import zlib
from dataclasses import dataclass, field

import numpy as np

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"

# color transform tags, mirroring rwpng_color_transform (rwpng.h:52-60)
COLOR_NONE = "none"
COLOR_SRGB = "srgb"
COLOR_GAMA_ONLY = "gama_only"

# filter ids (PNG spec) — also the order of the reference's pngloss_filter enum
FILTER_NONE, FILTER_SUB, FILTER_UP, FILTER_AVG, FILTER_PAETH = range(5)

# libpng PNG_FILTER_* masks, used for row_filters interchange with the CLI
PNG_FILTER_MASKS = (0x08, 0x10, 0x20, 0x40, 0x80)

_ADAM7 = (  # (x_start, y_start, x_step, y_step) — PNG spec §8.2
    (0, 0, 8, 8),
    (4, 0, 8, 8),
    (0, 4, 4, 8),
    (2, 0, 4, 4),
    (0, 2, 2, 4),
    (1, 0, 2, 2),
    (0, 1, 1, 2),
)

# Chunks the system libpng (1.6 + Debian APNG patch) has READ HANDLERS for.
# These never reach the reference's keep-callback (read_chunk_callback,
# rwpng.c:129-156) and their handlers all begin with a fatal missing-IHDR
# check.  Everything else travels the unknown-chunk path: kept iff
# safe-to-copy, seen after IHDR, and before the first IDAT (libpng's WRITE
# side silently drops unsafe-to-copy unknowns, and rwpng's
# png_write_end(NULL) never writes post-IDAT unknowns).
_KNOWN_HANDLED = {
    b"IHDR", b"PLTE", b"IDAT", b"IEND", b"tRNS", b"gAMA", b"sRGB", b"cHRM",
    b"iCCP", b"sBIT", b"bKGD", b"hIST", b"tIME", b"oFFs", b"pCAL", b"sCAL",
    b"sPLT", b"sTER", b"eXIf", b"acTL", b"fcTL", b"fdAT",
}
# keep-listed chunks (png_set_keep_unknown_chunks IF_SAFE, rwpng.c:213):
# routed down the unknown path when strip=False, known-handled when strip=True
_KEPT_KNOWN = {b"pHYs", b"iTXt", b"tEXt", b"zTXt"}

# pngloss_error codes that decode failures map to (rwpng.h:23-38)
PNG_OUT_OF_MEMORY_ERROR = 24
LIBPNG_FATAL_ERROR = 25


class PngDecodeError(ValueError):
    """Typed decode failure.  `exit_code` is the pngloss_error the reference
    CLI would exit with for the same input: 25 for libpng longjmp errors,
    24 for the rwpng.c:287-290 overflow guard / allocation failure."""

    def __init__(self, msg: str, exit_code: int = LIBPNG_FATAL_ERROR):
        super().__init__(msg)
        self.exit_code = exit_code


class TooLargeFile(Exception):
    """Output exceeded maximum_file_size (exit code 98 in the CLI).

    `data` carries the complete encoded bytes: the reference checks the size
    only after everything is written (rwpng.c:631-633), so in stdout mode the
    whole oversized attempt still reaches the output (pngloss.c:290-297).
    """

    def __init__(self, msg: str, data: bytes = b""):
        super().__init__(msg)
        self.data = data


@dataclass
class Chunk:
    name: bytes       # 4-byte chunk type
    data: bytes
    location: int     # 1 = before PLTE, 2 = after PLTE, 8 = after IDAT (libpng mode bits)


@dataclass
class DecodedImage:
    rgba: np.ndarray                      # (H, W, 4) uint8
    gamma: float = 0.45455
    color_transform: str = COLOR_NONE     # input == output transform in reference
    chunks: list[Chunk] = field(default_factory=list)
    file_size: int = 0
    icc_note: str | None = None           # codec.icc verbose note (PNGLOSS_ICC=1)

    @property
    def width(self) -> int:
        return int(self.rgba.shape[1])

    @property
    def height(self) -> int:
        return int(self.rgba.shape[0])


def _iter_chunks(data: bytes):
    """Raw chunk walk for WELL-FORMED inputs (test helpers only; decode()
    does its own walk with libpng's malformed-input policies)."""
    pos = len(PNG_SIGNATURE)
    n = len(data)
    while pos + 8 <= n:
        (length,) = struct.unpack(">I", data[pos : pos + 4])
        name = data[pos + 4 : pos + 8]
        body = data[pos + 8 : pos + 8 + length]
        if len(body) != length or pos + 12 + length > n:
            raise PngDecodeError("Read error")
        yield name, body
        pos += 12 + length
        if name == b"IEND":
            return
    raise PngDecodeError("Read error")


def _check_ihdr(width, height, bit_depth, color_type, comp, filt, interlace):
    """png_check_IHDR emulation (error texts follow libpng's; all are the
    reference's exit code 25 via rwpng.c:201-204 longjmp recovery)."""
    if width == 0 or height == 0:
        raise PngDecodeError("Image width or height is zero in IHDR")
    if width > 0x7FFFFFFF or height > 0x7FFFFFFF:
        raise PngDecodeError("PNG unsigned integer out of range")
    # libpng 1.6 default user limits (png_set_user_limits not overridden)
    if width > 1000000:
        raise PngDecodeError("Image width exceeds user limit in IHDR")
    if height > 1000000:
        raise PngDecodeError("Image height exceeds user limit in IHDR")
    if bit_depth not in (1, 2, 4, 8, 16):
        raise PngDecodeError("Invalid bit depth in IHDR")
    if color_type not in (0, 2, 3, 4, 6):
        raise PngDecodeError("Invalid color type in IHDR")
    if (color_type == 3 and bit_depth > 8) or (
            color_type in (2, 4, 6) and bit_depth < 8):
        raise PngDecodeError("Invalid color type/bit depth combination in IHDR")
    if comp != 0:
        raise PngDecodeError("Unknown compression method in IHDR")
    if filt != 0:
        raise PngDecodeError("Unknown filter method in IHDR")
    if interlace > 1:
        raise PngDecodeError("Unknown interlace method in IHDR")


def _chrm_valid(v: tuple) -> bool:
    """png_XYZ_from_xy validity: failure marks the whole colorspace invalid
    (sticky), which clears/blocks the byte-visible sRGB tag."""
    wx, wy, rx, ry, gx, gy, bx, by = (x / 100000.0 for x in v)
    for x in (wx, wy, rx, ry, gx, gy, bx, by):
        if x < 0 or x > 1:
            return False
    if wy <= 0:
        return False
    # the endpoint matrix must be invertible (png_XYZ_from_xy denominators)
    d = (rx - bx) * (gy - by) - (ry - by) * (gx - bx)
    return abs(d) > 1e-9


def _bits_to_samples(raw: np.ndarray, bit_depth: int, count: int) -> np.ndarray:
    """Unpack a row of packed samples (bit_depth in 1,2,4,8,16) to int32 values."""
    if bit_depth == 8:
        return raw[:count].astype(np.int32)
    if bit_depth == 16:
        return ((raw[0 : 2 * count : 2].astype(np.int32) << 8) | raw[1 : 2 * count : 2]).astype(np.int32)
    # packed small depths
    per_byte = 8 // bit_depth
    bits = np.unpackbits(raw)
    bits = bits[: (len(raw) * 8)].reshape(-1, bit_depth)
    vals = np.zeros(len(bits), dtype=np.int32)
    for i in range(bit_depth):
        vals = (vals << 1) | bits[:, i]
    del per_byte
    return vals[:count]


def _unfilter(raw: bytes, width: int, height: int, bpp_bytes: int, rowbytes: int) -> np.ndarray:
    """Undo PNG per-row filtering. Returns (height, rowbytes) uint8."""
    stride = max(bpp_bytes, 1)
    raw_arr = np.frombuffer(raw, dtype=np.uint8)
    if len(raw_arr) < height * (rowbytes + 1):
        raise PngDecodeError("Not enough image data")  # libpng's text
    out = np.zeros((height, rowbytes), dtype=np.uint8)
    rows = raw_arr[: height * (rowbytes + 1)].reshape(height, rowbytes + 1)
    prev = np.zeros(rowbytes, dtype=np.int32)
    for y in range(height):
        ftype = int(rows[y, 0])
        line = rows[y, 1:].astype(np.int32)
        if ftype == FILTER_NONE:
            cur = line
        elif ftype == FILTER_SUB:
            cur = line.copy()
            for x in range(stride, rowbytes):
                cur[x] = (cur[x] + cur[x - stride]) & 0xFF
        elif ftype == FILTER_UP:
            cur = (line + prev) & 0xFF
        elif ftype == FILTER_AVG:
            cur = line.copy()
            for x in range(rowbytes):
                left = cur[x - stride] if x >= stride else 0
                cur[x] = (cur[x] + ((left + prev[x]) >> 1)) & 0xFF
        elif ftype == FILTER_PAETH:
            cur = line.copy()
            for x in range(rowbytes):
                left = cur[x - stride] if x >= stride else 0
                up = prev[x]
                diag = prev[x - stride] if x >= stride else 0
                p = left + up - diag
                pa, pb, pc = abs(p - left), abs(p - up), abs(p - diag)
                if pa <= pb and pa <= pc:
                    pred = left
                elif pb <= pc:
                    pred = up
                else:
                    pred = diag
                cur[x] = (cur[x] + pred) & 0xFF
        else:
            raise PngDecodeError(f"bad filter type {ftype}")
        out[y] = cur.astype(np.uint8)
        prev = cur
    return out


def _samples_to_rgba(
    samples: np.ndarray,  # (H, W, channels) int32 at native bit depth
    color_type: int,
    bit_depth: int,
    palette: np.ndarray | None,
    trns: bytes | None,
) -> np.ndarray:
    """Apply libpng's transform pipeline: expand -> strip16 -> gray_to_rgb -> filler."""
    h, w = samples.shape[0], samples.shape[1]
    if color_type == 3:  # palette
        if palette is None:
            raise PngDecodeError("palette image without PLTE")
        idx = samples[:, :, 0]
        # libpng calloc's a 256-entry palette (png_set_PLTE): out-of-range
        # indices decode to black, never an error; tRNS entries beyond its
        # length are opaque (png_do_expand_palette)
        pal256 = np.zeros((256, 3), dtype=np.uint8)
        pal256[: len(palette)] = palette[:256]
        rgb = pal256[idx]  # (H, W, 3) uint8
        pal_alpha = np.full(256, 255, dtype=np.uint8)
        if trns is not None:
            tr = np.frombuffer(trns, dtype=np.uint8)[:256]
            pal_alpha[: len(tr)] = tr
        alpha = pal_alpha[idx]
        return np.dstack([rgb, alpha[..., None]])

    maxval = (1 << bit_depth) - 1
    if color_type == 0:  # gray
        g = samples[:, :, 0]
        alpha = np.full((h, w), maxval, dtype=np.int32)
        if trns is not None and len(trns) >= 2:
            (tg,) = struct.unpack(">H", trns[:2])
            alpha = np.where(g == (tg & maxval), 0, maxval)
        if bit_depth < 8:
            g = g * (255 // maxval)
            alpha = alpha * (255 // maxval)
        elif bit_depth == 16:
            g >>= 8
            alpha >>= 8
        g8 = g.astype(np.uint8)
        a8 = alpha.astype(np.uint8)
        return np.dstack([g8, g8, g8, a8])

    if color_type == 4:  # gray+alpha (bit depth 8 or 16)
        g, a = samples[:, :, 0], samples[:, :, 1]
        if bit_depth == 16:
            g, a = g >> 8, a >> 8
        g8 = g.astype(np.uint8)
        return np.dstack([g8, g8, g8, a.astype(np.uint8)])

    if color_type == 2:  # RGB
        rgb = samples
        alpha = np.full((h, w), maxval, dtype=np.int32)
        if trns is not None and len(trns) >= 6:
            tr, tg, tb = struct.unpack(">HHH", trns[:6])
            m = (rgb[:, :, 0] == (tr & maxval)) & (rgb[:, :, 1] == (tg & maxval)) & (rgb[:, :, 2] == (tb & maxval))
            alpha = np.where(m, 0, maxval)
        if bit_depth == 16:
            rgb = rgb >> 8
            alpha = alpha >> 8
        return np.dstack([rgb.astype(np.uint8), alpha.astype(np.uint8)])

    if color_type == 6:  # RGBA
        px = samples
        if bit_depth == 16:
            px = px >> 8
        return px.astype(np.uint8)

    raise PngDecodeError(f"bad color type {color_type}")


_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def _inflate_idat(idat: bytes, needed: int) -> bytes:
    """Inflate the IDAT run with libpng's termination semantics (verified
    empirically vs the oracle; the two-phase split mirrors libpng's
    png_read_IDAT_data(output)/png_read_finish_IDAT(NULL) calls):

    MAIN phase (until `needed` output bytes): any zlib error is fatal —
    including a bad adler32 reachable without further output space, since
    inflate() runs through no-output states (block end, check) within the
    call that produced the last row byte.

    FINISH phase (rows complete, stream not yet ended): remaining input is
    swallowed with output discarded; zlib errors here are BENIGN (libpng
    png_chunk_benign_error of zstream.msg with output == NULL) — a damaged
    tail after the image data is tolerated — but running out of input
    before the stream ends is still "Not enough image data" (a one-byte
    cut of the trailer is fatal).  Output beyond `needed` is discarded,
    bounding memory on decompression bombs."""
    d = zlib.decompressobj()
    try:
        out = d.decompress(bytes(idat), needed)
    except zlib.error as e:
        msg = str(e)
        if "check" in msg.lower():
            raise PngDecodeError("IDAT: incorrect data check") from e
        raise PngDecodeError("IDAT: invalid stream") from e
    if len(out) < needed:
        raise PngDecodeError("Not enough image data")
    if not d.eof:
        tail = d.unconsumed_tail
        try:
            while tail and not d.eof:
                d.decompress(tail, 1 << 20)  # discard
                tail = d.unconsumed_tail
        except zlib.error:
            pass  # benign: damaged data after the image is complete
        else:
            if not d.eof:
                raise PngDecodeError("Not enough image data")
    return out


def decode(data: bytes, strip: bool = False) -> DecodedImage:
    """Decode PNG bytes to a normalized 8-bit RGBA image (rwpng_read_image24).

    Matches the reference's ACCEPT/REJECT decisions and decoded bytes on
    malformed input too (libpng 1.6 policies: benign-error discards for
    ancillary chunks, fatal errors for critical ones, the colorspace
    invalidation state machine, rwpng.c:287-290 overflow guard -> exit 24).
    All failures raise PngDecodeError; nothing else escapes."""
    try:
        return _decode_impl(data, strip)
    except PngDecodeError:
        raise
    except MemoryError as e:
        raise PngDecodeError("insufficient memory",
                             exit_code=PNG_OUT_OF_MEMORY_ERROR) from e
    except Exception as e:  # belt and braces: never leak untyped errors
        raise PngDecodeError(f"malformed PNG ({type(e).__name__}: {e})") from e


def _decode_impl(data: bytes, strip: bool) -> DecodedImage:
    if len(data) < 8 or not data.startswith(PNG_SIGNATURE):
        raise PngDecodeError("Not a PNG file")  # libpng's message text

    # with strip=True the reference sets no keep-list/callback, so the four
    # keep-listed chunks fall back to their libpng handlers and unknown
    # CRITICAL chunks become fatal (png_handle_unknown)
    known_handled = _KNOWN_HANDLED | (_KEPT_KNOWN if strip else set())

    width = height = bit_depth = color_type = interlace = 0
    have_ihdr = False
    palette: np.ndarray | None = None
    num_palette = 0
    have_plte = False        # a palette was actually STORED (png_set_PLTE)
    # libpng's PNG_HAVE_PLTE mode bit: set by png_handle_PLTE for EVERY
    # PLTE that passes the duplicate/after-IDAT checks — including ones
    # later ignored (grayscale, bad length).  It gates the colorspace
    # handlers' "out of place" checks and flips kept-chunk location 1 -> 2
    # (oracle-pinned: gray PLTE + gAMA ignores the gAMA; two ignored PLTEs
    # are a fatal duplicate)
    plte_mode = False
    trns: bytes | None = None
    # libpng colorspace state machine (byte-visible through the sRGB tag)
    cs_invalid = False       # PNG_COLORSPACE_INVALID — sticky
    from_srgb = False
    have_gamma = False
    have_endpoints = False
    srgb_tag = False
    gamma_fixed = 45455
    idat = bytearray()
    seen_idat = False
    idat_done = False        # a non-IDAT chunk ended the consecutive run
    kept: list[Chunk] = []

    pos = 8
    n = len(data)
    while True:
        if pos + 8 > n:
            raise PngDecodeError("Read error")  # EOF without IEND
        (length,) = struct.unpack(">I", data[pos : pos + 4])
        name = data[pos + 4 : pos + 8]
        if length > 0x7FFFFFFF:
            raise PngDecodeError(f"{name.decode('latin-1')}: invalid chunk length")
        for b in name:
            if not (65 <= b <= 90 or 97 <= b <= 122):
                raise PngDecodeError("invalid chunk type")
        # ---- header-time dispatch (libpng acts on length+name BEFORE
        # reading chunk data or CRC; everything in this block must precede
        # the data-bounds check and the CRC policy) ----

        # libpng handlers check missing-IHDR at dispatch
        if not have_ihdr and name != b"IHDR" and name in known_handled:
            if name == b"IDAT":
                raise PngDecodeError("IDAT: Missing IHDR before IDAT")
            if name == b"IEND":
                raise PngDecodeError("IEND: out of place")
            raise PngDecodeError(f"{name.decode('latin-1')}: missing IHDR")

        # png_read_row terminates the consecutive IDAT run at the next
        # chunk's HEADER — an intervening chunk ends the run even when its
        # own data/CRC later turn out to be truncated or corrupt
        if seen_idat and name != b"IDAT":
            idat_done = True

        if name == b"IDAT" and not seen_idat:
            # png_read_info returns at the first IDAT *header*: libpng's
            # Missing-PLTE check and rwpng's 32-bit-rowbytes guard
            # (rwpng.c:287-290, exit 24) both fire there, before any IDAT
            # data, bounds, or CRC is examined
            if color_type == 3 and not have_plte:
                raise PngDecodeError("IDAT: Missing PLTE before IDAT")
            if width * 4 > 0x7FFFFFFF // height:
                raise PngDecodeError(
                    "image too large for 32-bit rowbytes",
                    exit_code=PNG_OUT_OF_MEMORY_ERROR)
            seen_idat = True

        if pos + 12 + length > n:
            raise PngDecodeError("Read error")
        body = data[pos + 8 : pos + 8 + length]
        (expect,) = struct.unpack(">I", data[pos + 8 + length : pos + 12 + length])
        pos += 12 + length

        # libpng's tEXt/iTXt handlers (they run under strip — no
        # keep-callback) hit the zero-length read-past-EOF bug-compat while
        # reading chunk data, BEFORE the CRC is verified
        if (strip and length == 0 and not seen_idat
                and name in (b"tEXt", b"iTXt")):
            raise PngDecodeError("Read error")

        ancillary = bool(name[0] & 0x20)
        if expect != (zlib.crc32(name + body) & 0xFFFFFFFF):
            if not ancillary:
                # critical-bit chunks (incl. unknown ones): fatal
                raise PngDecodeError(f"{name.decode('latin-1')}: CRC error")
            if name in known_handled:
                continue  # handler path: warn + discard, no state change
            # unknown path: rwpng's callback stores the chunk before libpng
            # sees the CRC result, so the data is kept/used despite the error

        if name == b"IHDR":
            if have_ihdr:
                raise PngDecodeError("IHDR: out of place")
            if length != 13:
                raise PngDecodeError("IHDR: invalid")
            width, height, bit_depth, color_type, comp, filt, interlace = \
                struct.unpack(">IIBBBBB", body)
            _check_ihdr(width, height, bit_depth, color_type, comp, filt, interlace)
            have_ihdr = True

        elif name == b"PLTE":
            # png_handle_PLTE ordering: after IDAT -> benign; duplicate ->
            # fatal; grayscale -> benign; bad length -> fatal iff palette img
            if seen_idat:
                continue
            if plte_mode:
                raise PngDecodeError("PLTE: duplicate")
            # mode bit set before the grayscale/length checks, so even an
            # ignored PLTE moves later kept chunks to location 2 and makes
            # a second PLTE a fatal duplicate
            plte_mode = True
            if color_type in (0, 4):
                continue  # "ignored in grayscale PNG"
            if length > 768 or length % 3:
                if color_type == 3:
                    raise PngDecodeError("PLTE: invalid")
                continue
            if length == 0:
                # a zero-length PLTE passes png_handle_PLTE's length check
                # (0 % 3 == 0) and dies in png_set_PLTE's num_palette == 0
                # guard — fatal for every color type that stores it
                raise PngDecodeError("Invalid palette")
            palette = np.frombuffer(body, dtype=np.uint8).reshape(-1, 3)
            num_palette = length // 3
            have_plte = True

        elif name == b"IDAT":
            # first-IDAT checks (Missing PLTE, rowbytes guard) fired at
            # header-dispatch time above
            if idat_done:
                continue  # IDATs after the run ended are tolerated (read_end)
            idat += body

        elif name == b"IEND":
            if not seen_idat:
                raise PngDecodeError("IEND: out of place")
            break

        elif name == b"tRNS":
            # png_handle_tRNS: every malformed shape is a benign discard
            # ("out of place" after IDAT, "duplicate" keeps the first,
            # "invalid" lengths, alpha color types)
            if seen_idat or trns is not None or length == 0:
                continue
            if color_type == 0:
                if length != 2:
                    continue
                trns = body
            elif color_type == 2:
                if length != 6:
                    continue
                trns = body
            elif color_type == 3:
                if not have_plte or length > num_palette:
                    continue
                trns = body
            else:
                continue  # "invalid with alpha channel"

        elif name == b"gAMA":
            if plte_mode or seen_idat or length != 4:
                continue  # "out of place" / "invalid": benign, no state change
            (g,) = struct.unpack(">I", body)
            if cs_invalid or from_srgb:
                continue  # FROM_sRGB: gAMA ignored entirely
            if not (16 <= g <= 625000000) or have_gamma:
                # out-of-range or duplicate: png_colorspace_set_gamma's error
                # exit marks the colorspace INVALID (sticky) — clears sRGB
                cs_invalid = True
                srgb_tag = False
                continue
            have_gamma = True
            gamma_fixed = g

        elif name == b"sRGB":
            if plte_mode or seen_idat or length != 1 or body[0] > 3:
                continue
            if cs_invalid:
                continue
            if from_srgb:
                # second sRGB (any intent) invalidates the colorspace
                cs_invalid = True
                srgb_tag = False
                continue
            from_srgb = True
            have_gamma = True
            srgb_tag = True
            gamma_fixed = 45455

        elif name == b"cHRM":
            if plte_mode or seen_idat or length != 32:
                continue
            if cs_invalid or from_srgb:
                continue  # FROM_sRGB: cHRM ignored
            vals = struct.unpack(">8I", body)
            if not _chrm_valid(vals) or have_endpoints:
                cs_invalid = True
                srgb_tag = False
                continue
            have_endpoints = True

        elif name in _KNOWN_HANDLED:
            # iCCP/sBIT/bKGD/hIST/tIME/oFFs/pCAL/sCAL/sPLT/sTER/eXIf/acTL/
            # fcTL/fdAT (+ the keep-list under strip): handled by libpng,
            # never re-emitted, malformed shapes are benign discards
            continue

        else:
            # unknown path (read_chunk_callback + libpng write-side policy):
            # keep iff safe-to-copy, after IHDR (location != 0), before IDAT
            if strip:
                # no keep-callback under strip: unknown CRITICAL chunks are
                # fatal in png_read_info but tolerated after IDAT (read_end)
                if not ancillary and not seen_idat:
                    raise PngDecodeError(
                        f"{name.decode('latin-1')}: unhandled critical chunk")
                # keep-listed chunks run their libpng handlers under strip
                # (the zero-length tEXt/iTXt read-past-EOF bug-compat fired
                # pre-CRC, above)
                continue
            if not have_ihdr or seen_idat:
                continue
            if name in _KEPT_KNOWN or bool(name[3] & 0x20):
                # libpng normalises the location to its top-most mode bit
                # (pngset.c check_location): before any PLTE -> 1
                # (PNG_HAVE_IHDR), after one -> 2 (PNG_HAVE_PLTE) — the two
                # groups are written at different png_write_info points
                kept.append(Chunk(name=name, data=body,
                                  location=2 if plte_mode else 1))

    channels = _CHANNELS[color_type]

    # gamma/sRGB bookkeeping (rwpng.c:258-275)
    gamma = 0.45455
    if srgb_tag:
        color_transform = COLOR_SRGB
    else:
        g = gamma_fixed / 100000.0 if (have_gamma and not cs_invalid) else 0.45455
        if 0 < g <= 1.0:
            gamma = g
            color_transform = COLOR_GAMA_ONLY
        else:
            color_transform = COLOR_NONE

    sample_bits = bit_depth * channels
    if interlace == 0:
        needed = height * ((width * sample_bits + 7) // 8 + 1)
    else:
        needed = 0
        for (x0, y0, dx, dy) in _ADAM7:
            w = (width - x0 + dx - 1) // dx if width > x0 else 0
            h = (height - y0 + dy - 1) // dy if height > y0 else 0
            if w and h:
                needed += h * ((w * sample_bits + 7) // 8 + 1)
    raw = _inflate_idat(idat, needed)

    def read_subimage(buf: bytes, w: int, h: int) -> np.ndarray:
        rowbytes = (w * sample_bits + 7) // 8
        bpp_bytes = max(sample_bits // 8, 1)
        unf = _unfilter(buf, w, h, bpp_bytes, rowbytes)
        out = np.zeros((h, w, channels), dtype=np.int32)
        for y in range(h):
            vals = _bits_to_samples(unf[y], bit_depth, w * channels)
            out[y] = vals.reshape(w, channels)
        return out

    if interlace == 0:
        samples = read_subimage(raw, width, height)
    elif interlace == 1:
        samples = np.zeros((height, width, channels), dtype=np.int32)
        pos = 0
        for (x0, y0, dx, dy) in _ADAM7:
            w = (width - x0 + dx - 1) // dx
            h = (height - y0 + dy - 1) // dy
            if w == 0 or h == 0:
                continue
            rowbytes = (w * sample_bits + 7) // 8
            nbytes = h * (rowbytes + 1)
            sub = read_subimage(raw[pos : pos + nbytes], w, h)
            pos += nbytes
            samples[y0::dy, x0::dx] = sub
        del pos
    else:
        raise PngDecodeError(f"bad interlace method {interlace}")

    rgba = _samples_to_rgba(samples, color_type, bit_depth, palette, trns)
    # rwpng's read_chunk_callback PREPENDS each kept chunk to a linked list
    # (rwpng.c:152-153) and the writer walks that list in order, so the
    # emitted order within a location group is the REVERSE of read order
    return DecodedImage(
        rgba=np.ascontiguousarray(rgba),
        gamma=gamma,
        color_transform=color_transform,
        chunks=kept[::-1],
        file_size=len(data),
    )


def scanline_filters(data: bytes) -> np.ndarray:
    """Return the per-scanline filter ids of a non-interlaced PNG (inspection
    helper used by tests to compare filter decisions against the C tool)."""
    if not data.startswith(PNG_SIGNATURE):
        raise PngDecodeError("Not a PNG file")  # libpng's message text
    width = height = bit_depth = color_type = None
    idat = bytearray()
    for name, body in _iter_chunks(data):
        if name == b"IHDR":
            width, height, bit_depth, color_type, _c, _f, interlace = struct.unpack(">IIBBBBB", body)
            if interlace != 0:
                raise PngDecodeError("interlaced")
        elif name == b"IDAT":
            idat += body
    raw = np.frombuffer(zlib.decompress(bytes(idat)), dtype=np.uint8)
    rowbytes = (width * bit_depth * _CHANNELS[color_type] + 7) // 8
    return raw[: height * (rowbytes + 1)].reshape(height, rowbytes + 1)[:, 0].copy()


# ---------------------------------------------------------------------------
# Encoding
# ---------------------------------------------------------------------------

def detect_colorspace(rgba: np.ndarray) -> tuple[bool, bool]:
    """(grayscale, strip_alpha) detection, as rwpng.c:557-573 / pngloss_image.c:64-80."""
    grayscale = bool(
        np.all(rgba[:, :, 0] == rgba[:, :, 1]) and np.all(rgba[:, :, 1] == rgba[:, :, 2])
    )
    strip_alpha = bool(np.all(rgba[:, :, 3] == 255))
    return grayscale, strip_alpha


def pack_pixels(rgba: np.ndarray, grayscale: bool, strip_alpha: bool) -> tuple[np.ndarray, int]:
    """Pack RGBA to the output scanline format. Returns (rows (H,W,C) uint8, color_type)."""
    if grayscale:
        # green carries luminance (rwpng.c:587)
        if strip_alpha:
            return rgba[:, :, 1:2].copy(), 0
        return rgba[:, :, (1, 3)].copy(), 4
    if strip_alpha:
        return rgba[:, :, :3].copy(), 2
    return rgba.copy(), 6


def apply_filter(prev_row: np.ndarray | None, row: np.ndarray, ftype: int, bpp: int) -> np.ndarray:
    """Apply PNG filter `ftype` to a scanline. row: (rowbytes,) uint8."""
    cur = row.astype(np.int32)
    up = prev_row.astype(np.int32) if prev_row is not None else np.zeros_like(cur)
    left = np.zeros_like(cur)
    left[bpp:] = cur[:-bpp]
    diag = np.zeros_like(cur)
    diag[bpp:] = up[:-bpp]
    if ftype == FILTER_NONE:
        out = cur
    elif ftype == FILTER_SUB:
        out = cur - left
    elif ftype == FILTER_UP:
        out = cur - up
    elif ftype == FILTER_AVG:
        out = cur - ((left + up) >> 1)
    elif ftype == FILTER_PAETH:
        p = left + up - diag
        pa = np.abs(p - left)
        pb = np.abs(p - up)
        pc = np.abs(p - diag)
        pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, diag))
        out = cur - pred
    else:
        raise ValueError(f"bad filter {ftype}")
    return (out & 0xFF).astype(np.uint8)


def msad_filter_choice(prev_row: np.ndarray | None, row: np.ndarray, bpp: int,
                       single_row_image: bool = False) -> int:
    """libpng's minimum-sum-of-absolute-differences filter heuristic.

    Matches png_write_find_filter with PNG_ALL_FILTERS: for each candidate the
    score is sum over filtered bytes v of (v < 128 ? v : 256 - v); candidates
    are evaluated in order none, sub, up, avg, paeth and a strictly smaller sum
    is required to replace the current best. This is the same cascade as the
    reference's adaptive_filter_for_rows (optimize_state.c:492-562).
    """
    # Candidate restrictions, verified empirically against libpng 1.6:
    #  * SINGLE-ROW IMAGES (height 1) try only NONE and SUB — AVG loses
    #    even with the strictly lowest sum; row 0 of taller images uses
    #    all five with a zeroed previous row (AVG can and does win there);
    #  * on single-pixel rows (rowbytes <= bpp) SUB/AVG/PAETH are never
    #    produced (see tests/test_codec.py width-1 cases).
    single = len(row) <= bpp
    if single_row_image:
        candidates = (FILTER_NONE,) if single else (FILTER_NONE, FILTER_SUB)
    elif single:
        candidates = (FILTER_NONE, FILTER_UP)
    else:
        candidates = range(5)
    best, best_sum = FILTER_NONE, None
    for f in candidates:
        filtered = apply_filter(prev_row, row, f, bpp).astype(np.int32)
        s = int(np.where(filtered < 128, filtered, 256 - filtered).sum())
        if best_sum is None or s < best_sum:
            best, best_sum = f, s
    return best


def encode(
    rgba: np.ndarray,
    row_filters: np.ndarray | list[int] | None = None,
    gamma: float = 0.45455,
    color_transform: str = COLOR_GAMA_ONLY,
    chunks: list[Chunk] | None = None,
    maximum_file_size: int = 0,
) -> bytes:
    """Encode RGBA8 + per-row filter choices to PNG bytes (rwpng_write_image24).

    row_filters holds one PNG filter id (0..4) per row, or None to choose every
    row adaptively. Row 0 is ALWAYS chosen adaptively (PNG spec section 5.9;
    rwpng.c:488-495 passes PNG_ALL_FILTERS for row 0).
    """
    h, w = rgba.shape[0], rgba.shape[1]
    grayscale, strip_alpha = detect_colorspace(rgba)
    rows, color_type = pack_pixels(rgba, grayscale, strip_alpha)
    bpp = rows.shape[2]
    flat = rows.reshape(h, w * bpp)

    out = bytearray(PNG_SIGNATURE)

    def put_chunk(name: bytes, body: bytes):
        out.extend(struct.pack(">I", len(body)))
        out.extend(name)
        out.extend(body)
        out.extend(struct.pack(">I", zlib.crc32(name + body) & 0xFFFFFFFF))

    put_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0))

    # gamma/sRGB chunks (rwpng_set_gamma, rwpng.c:505-513)
    if color_transform not in (COLOR_GAMA_ONLY, COLOR_NONE):
        put_chunk(b"gAMA", struct.pack(">I", int(round(gamma * 100000))))
    if color_transform == COLOR_SRGB:
        put_chunk(b"sRGB", b"\x00")

    # libpng writes unknown chunks at three points, by normalised location:
    # end of png_write_info_before_PLTE (1), end of png_write_info (2), and
    # png_write_end (8) — so the location-1 group precedes the location-2
    # group even though rwpng's list interleaves them (reversed read order
    # is preserved WITHIN each group)
    for ch in chunks or ():
        if ch.location not in (2, 8):
            put_chunk(ch.name, ch.data)
    for ch in chunks or ():
        if ch.location == 2:
            put_chunk(ch.name, ch.data)

    # filter + deflate; libpng's defaults are level 9 via the reference's
    # png_set_compression_level, memLevel 9, and strategy Z_FILTERED
    # (libpng's PNG_Z_DEFAULT_STRATEGY when row filtering is in use).
    comp = zlib.compressobj(9, zlib.DEFLATED, 15, 9, zlib.Z_FILTERED)
    stream = bytearray()
    prev = None
    for y in range(h):
        if y == 0 or row_filters is None:
            f = msad_filter_choice(prev, flat[y], bpp, single_row_image=(h == 1))
        else:
            f = int(row_filters[y])
            if w * bpp <= bpp and f in (FILTER_SUB, FILTER_AVG, FILTER_PAETH):
                # libpng ignores forced SUB/AVG/PAETH on single-pixel rows
                f = FILTER_NONE
        filtered = apply_filter(prev, flat[y], f, bpp)
        stream.extend(comp.compress(bytes([f]) + filtered.tobytes()))
        prev = flat[y]
    stream.extend(comp.flush())

    # libpng rewrites the zlib header to claim the smallest deflate window
    # that covers the scanline data (optimize_cmf in pngwutil.c) — the deflate
    # bytes themselves are unaffected because the data fits in any window.
    data_size = h * (w * bpp + 1)
    if data_size <= 16384 and (stream[0] & 0x0F) == 8 and (stream[0] & 0xF0) <= 0x70:
        z_cinfo = stream[0] >> 4
        half = 1 << (z_cinfo + 7)
        if data_size <= half:
            while True:
                half >>= 1
                z_cinfo -= 1
                if not (z_cinfo > 0 and data_size <= half):
                    break
            cmf = (stream[0] & 0x0F) | (z_cinfo << 4)
            stream[0] = cmf
            tmp = stream[1] & 0xE0
            tmp += 0x1F - ((cmf << 8) + tmp) % 0x1F
            stream[1] = tmp

    # 8192-byte IDAT chunks, like libpng's default zbuffer flushing
    for i in range(0, len(stream), 8192):
        put_chunk(b"IDAT", bytes(stream[i : i + 8192]))

    for ch in chunks or ():
        if ch.location == 8:
            put_chunk(ch.name, ch.data)

    put_chunk(b"IEND", b"")

    if maximum_file_size and len(out) > maximum_file_size:
        raise TooLargeFile(f"{len(out)} > {maximum_file_size}", bytes(out))
    return bytes(out)

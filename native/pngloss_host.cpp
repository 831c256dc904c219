// Native host codec for pngloss-jax: PNG decode to normalized RGBA8 and
// encode from pixels + per-row filter ids, built directly on zlib.
//
// This replaces the reference's libpng wrapper (rwpng.c) with a standalone
// implementation whose byte-level behavior matches both the reference tool
// and the pure-Python codec (pngloss_jax/codec/pypng.py) exactly:
//   * decode normalizations: palette expand (+tRNS alpha), sub-8-bit gray
//     expansion, 16->8 bit strip, gray->RGB replication, opaque filler
//     alpha, Adam7 de-interlacing (rwpng.c:238-277 behavior)
//   * ancillary chunk keep/strip rules (read_chunk_callback, rwpng.c:129-156)
//   * gamma/sRGB bookkeeping (rwpng.c:258-275)
//   * encode: gray/alpha re-detection (rwpng.c:557-573), packing
//     (rwpng.c:576-624), per-row forced filters with row 0 adaptive
//     (rwpng.c:488-495), deflate level 9 / memLevel 9 / Z_FILTERED,
//     8192-byte IDAT chunking, and libpng's optimize_cmf window rewrite
//   * maximum_file_size checked only after the full encode (rwpng.c:631-633)
//
// Exposed as a C ABI for ctypes (no pybind11 in this image).

#include <zlib.h>

#include <algorithm>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <exception>
#include <new>
#include <string>
#include <vector>

// fast_deflate.cpp: byte-identical zlib-9/Z_FILTERED clone
extern "C" int fast_deflate9_filtered(const uint8_t* in, size_t n,
                                      uint8_t** out_data, size_t* out_len);

namespace {

constexpr uint8_t kSig[8] = {0x89, 'P', 'N', 'G', '\r', '\n', 0x1a, '\n'};

thread_local std::string g_error;

enum PlStatus {
  PL_OK = 0,
  PL_DECODE_ERROR = 2,   // == READ_ERROR exit code (legacy; decode now
                         //    returns the precise rwpng.h codes below)
  PL_TOO_LARGE = 98,     // == TOO_LARGE_FILE
  PL_BAD_ARGS = 4,
  PL_PNG_OOM = 24,       // == PNG_OUT_OF_MEMORY_ERROR (rwpng.c:287-290)
  PL_LIBPNG_FATAL = 25,  // == LIBPNG_FATAL_ERROR (longjmp-recovered errors)
};

int fail(const std::string& msg) {
  g_error = msg;
  return PL_LIBPNG_FATAL;
}

int fail_oom(const std::string& msg) {
  g_error = msg;
  return PL_PNG_OOM;
}

uint32_t be32(const uint8_t* p) {
  return (uint32_t(p[0]) << 24) | (uint32_t(p[1]) << 16) |
         (uint32_t(p[2]) << 8) | uint32_t(p[3]);
}

void put_be32(std::vector<uint8_t>& out, uint32_t v) {
  out.push_back(uint8_t(v >> 24));
  out.push_back(uint8_t(v >> 16));
  out.push_back(uint8_t(v >> 8));
  out.push_back(uint8_t(v));
}

// ---------------------------------------------------------------------------
// Chunk blob interchange with Python:
//   repeated records of [u32le data_len][4 bytes name][u8 location][data]
// ---------------------------------------------------------------------------

struct KeptChunk {
  char name[4];
  uint8_t location;  // 1 = before PLTE, 2 = after PLTE, 8 = after IDAT
  std::vector<uint8_t> data;
};

void serialize_chunks(const std::vector<KeptChunk>& chunks,
                      std::vector<uint8_t>& blob) {
  for (const auto& c : chunks) {
    uint32_t n = uint32_t(c.data.size());
    blob.push_back(uint8_t(n));
    blob.push_back(uint8_t(n >> 8));
    blob.push_back(uint8_t(n >> 16));
    blob.push_back(uint8_t(n >> 24));
    blob.insert(blob.end(), c.name, c.name + 4);
    blob.push_back(c.location);
    blob.insert(blob.end(), c.data.begin(), c.data.end());
  }
}

bool parse_chunks(const uint8_t* blob, size_t len, std::vector<KeptChunk>* out) {
  size_t pos = 0;
  while (pos < len) {
    if (pos + 9 > len) return false;
    uint32_t n = uint32_t(blob[pos]) | (uint32_t(blob[pos + 1]) << 8) |
                 (uint32_t(blob[pos + 2]) << 16) | (uint32_t(blob[pos + 3]) << 24);
    if (pos + 9 + n > len) return false;
    KeptChunk c;
    std::memcpy(c.name, blob + pos + 4, 4);
    c.location = blob[pos + 8];
    c.data.assign(blob + pos + 9, blob + pos + 9 + n);
    out->push_back(std::move(c));
    pos += 9 + n;
  }
  return true;
}

// ---------------------------------------------------------------------------
// zlib helpers
// ---------------------------------------------------------------------------

// Inflate the IDAT run with libpng's termination semantics (verified
// empirically against the reference tool; the two-phase split mirrors
// libpng's png_read_IDAT_data(output) / png_read_finish_IDAT(NULL)):
//   MAIN phase (until `needed` output bytes): any zlib error is fatal —
//   including a bad adler32 reachable without further output space, since
//   inflate() runs through no-output states (block end, check) within the
//   call that produced the last row byte (avail_out spans all of `needed`).
//   FINISH phase (rows complete, stream not ended): remaining input is
//   swallowed with output discarded; zlib errors here are BENIGN (damaged
//   tail after the image is tolerated), but running out of input before
//   the stream ends is still "Not enough image data".
// Returns 0 ok, 1 not-enough/unterminated, 2 incorrect data check, 3 invalid.
int inflate_idat(const std::vector<uint8_t>& in, size_t needed,
                 std::vector<uint8_t>* out) {
  z_stream zs{};
  if (inflateInit(&zs) != Z_OK) return 3;
  out->resize(needed);
  std::vector<uint8_t> scratch;
  zs.next_out = out->data();
  size_t out_left = needed;
  zs.avail_out = uInt(out_left > 0xFFFFFFF0u ? 0xFFFFFFF0u : out_left);
  out_left -= zs.avail_out;
  size_t fed = 0;
  bool finish_phase = false;
  for (;;) {
    if (zs.avail_in == 0) {
      if (fed >= in.size()) {
        inflateEnd(&zs);
        return 1;  // input exhausted before stream end (either phase)
      }
      size_t chunk = in.size() - fed;
      if (chunk > 0xFFFFFFFFu) chunk = 0xFFFFFFFFu;
      zs.next_in = const_cast<uint8_t*>(in.data() + fed);
      zs.avail_in = uInt(chunk);
      fed += chunk;
    }
    if (zs.avail_out == 0) {
      if (!finish_phase && out_left > 0) {
        // >4 GiB outputs: extend the main-phase window
        zs.avail_out = uInt(out_left > 0xFFFFFFF0u ? 0xFFFFFFF0u : out_left);
        out_left -= zs.avail_out;
      } else {
        finish_phase = true;
        if (scratch.empty()) scratch.resize(1 << 16);
        zs.next_out = scratch.data();
        zs.avail_out = uInt(scratch.size());
      }
    }
    int ret = inflate(&zs, Z_NO_FLUSH);
    if (ret == Z_STREAM_END) {
      bool complete = finish_phase || (out_left == 0 && zs.avail_out == 0);
      inflateEnd(&zs);
      return complete ? 0 : 1;  // early end = "Not enough image data"
    }
    if (ret != Z_OK && ret != Z_BUF_ERROR) {
      inflateEnd(&zs);
      if (finish_phase) return 0;  // benign: image data already complete
      return ret == Z_DATA_ERROR && zs.msg &&
                     std::strstr(zs.msg, "check") != nullptr
                 ? 2
                 : 3;
    }
    if (ret == Z_BUF_ERROR && zs.avail_in == 0 && fed >= in.size()) {
      inflateEnd(&zs);
      return 1;
    }
  }
}

// ---------------------------------------------------------------------------
// Decoding
// ---------------------------------------------------------------------------

const int kChannels[7] = {1, 0, 3, 1, 2, 0, 4};

// Chunks the system libpng (1.6 + Debian APNG patch) has READ HANDLERS for:
// they never reach the reference's keep-callback (rwpng.c:129-156) and their
// handlers all start with a fatal missing-IHDR check.
bool is_known_handled(const char* n) {
  static const char* kSet[] = {"IHDR", "PLTE", "IDAT", "IEND", "tRNS",
                               "gAMA", "sRGB", "cHRM", "iCCP", "sBIT",
                               "bKGD", "hIST", "tIME", "oFFs", "pCAL",
                               "sCAL", "sPLT", "sTER", "eXIf", "acTL",
                               "fcTL", "fdAT"};
  for (const char* s : kSet)
    if (std::memcmp(n, s, 4) == 0) return true;
  return false;
}

// keep-listed chunks (png_set_keep_unknown_chunks IF_SAFE, rwpng.c:213)
bool is_kept_known(const char* n) {
  static const char* kSet[] = {"pHYs", "iTXt", "tEXt", "zTXt"};
  for (const char* s : kSet)
    if (std::memcmp(n, s, 4) == 0) return true;
  return false;
}

// png_check_IHDR emulation; returns nullptr when valid, else the error text
const char* check_ihdr(uint32_t w, uint32_t h, int depth, int color, int comp,
                       int filt, int inter) {
  if (w == 0 || h == 0) return "Image width or height is zero in IHDR";
  if (w > 0x7FFFFFFFu || h > 0x7FFFFFFFu)
    return "PNG unsigned integer out of range";
  if (w > 1000000u) return "Image width exceeds user limit in IHDR";
  if (h > 1000000u) return "Image height exceeds user limit in IHDR";
  if (depth != 1 && depth != 2 && depth != 4 && depth != 8 && depth != 16)
    return "Invalid bit depth in IHDR";
  if (color != 0 && color != 2 && color != 3 && color != 4 && color != 6)
    return "Invalid color type in IHDR";
  if ((color == 3 && depth > 8) ||
      ((color == 2 || color == 4 || color == 6) && depth < 8))
    return "Invalid color type/bit depth combination in IHDR";
  if (comp != 0) return "Unknown compression method in IHDR";
  if (filt != 0) return "Unknown filter method in IHDR";
  if (inter > 1) return "Unknown interlace method in IHDR";
  return nullptr;
}

// png_XYZ_from_xy validity: failure marks the colorspace invalid (sticky),
// clearing/blocking the byte-visible sRGB tag
bool chrm_valid(const uint32_t v[8]) {
  double f[8];
  for (int i = 0; i < 8; i++) {
    f[i] = v[i] / 100000.0;
    if (f[i] < 0 || f[i] > 1) return false;
  }
  if (f[1] <= 0) return false;  // white y
  double d = (f[2] - f[6]) * (f[5] - f[7]) - (f[3] - f[7]) * (f[4] - f[6]);
  return d > 1e-9 || d < -1e-9;
}

// Undo PNG per-row filtering in place over raw (h x (rowbytes+1)).
bool unfilter(uint8_t* raw, size_t raw_len, uint32_t w, uint32_t h,
              int bpp_bytes, size_t rowbytes, std::vector<uint8_t>* out) {
  (void)w;
  if (raw_len < size_t(h) * (rowbytes + 1)) {
    return false;
  }
  out->assign(size_t(h) * rowbytes, 0);
  const int stride = bpp_bytes < 1 ? 1 : bpp_bytes;
  std::vector<uint8_t> zero(rowbytes, 0);
  const uint8_t* prev = zero.data();
  for (uint32_t y = 0; y < h; y++) {
    const uint8_t* src = raw + size_t(y) * (rowbytes + 1);
    uint8_t* cur = out->data() + size_t(y) * rowbytes;
    int f = src[0];
    const uint8_t* line = src + 1;
    switch (f) {
      case 0:
        std::memcpy(cur, line, rowbytes);
        break;
      case 1:
        for (size_t x = 0; x < rowbytes; x++) {
          int left = x >= size_t(stride) ? cur[x - stride] : 0;
          cur[x] = uint8_t(line[x] + left);
        }
        break;
      case 2:
        for (size_t x = 0; x < rowbytes; x++) cur[x] = uint8_t(line[x] + prev[x]);
        break;
      case 3:
        for (size_t x = 0; x < rowbytes; x++) {
          int left = x >= size_t(stride) ? cur[x - stride] : 0;
          cur[x] = uint8_t(line[x] + ((left + prev[x]) >> 1));
        }
        break;
      case 4:
        for (size_t x = 0; x < rowbytes; x++) {
          int left = x >= size_t(stride) ? cur[x - stride] : 0;
          int up = prev[x];
          int diag = x >= size_t(stride) ? prev[x - stride] : 0;
          int p = left + up - diag;
          int pa = std::abs(p - left), pb = std::abs(p - up), pc = std::abs(p - diag);
          int pred = (pa <= pb && pa <= pc) ? left : (pb <= pc ? up : diag);
          cur[x] = uint8_t(line[x] + pred);
        }
        break;
      default:
        return false;
    }
    prev = cur;
  }
  return true;
}

// Unpack one unfiltered row of packed samples to int32 values.
void bits_to_samples(const uint8_t* row, int bit_depth, size_t count,
                     int32_t* out) {
  if (bit_depth == 8) {
    for (size_t i = 0; i < count; i++) out[i] = row[i];
  } else if (bit_depth == 16) {
    for (size_t i = 0; i < count; i++)
      out[i] = (int32_t(row[2 * i]) << 8) | row[2 * i + 1];
  } else {
    const int per_byte = 8 / bit_depth;
    const int mask = (1 << bit_depth) - 1;
    for (size_t i = 0; i < count; i++) {
      size_t byte = i / per_byte;
      int shift = 8 - bit_depth * (int(i % per_byte) + 1);
      out[i] = (row[byte] >> shift) & mask;
    }
  }
}

struct Adam7Pass {
  int x0, y0, dx, dy;
};
// PNG spec §8.2 pass origins/steps
const Adam7Pass kAdam7[7] = {{0, 0, 8, 8}, {4, 0, 8, 8}, {0, 4, 4, 8},
                             {2, 0, 4, 4}, {0, 2, 2, 4}, {1, 0, 2, 2},
                             {0, 1, 1, 2}};

// color_transform codes shared with Python: 0=none, 1=srgb, 2=gama_only
int pl_decode_impl(const uint8_t* data, size_t len, int strip,
                   uint8_t** out_rgba, uint32_t* out_w, uint32_t* out_h,
                   double* out_gamma, int* out_transform,
                   uint8_t** out_chunks, size_t* out_chunks_len) {
  if (len < 8 || std::memcmp(data, kSig, 8) != 0) return fail("Not a PNG file");

  uint32_t width = 0, height = 0;
  int bit_depth = 0, color_type = -1, interlace = 0;
  bool have_ihdr = false, have_plte = false;
  // libpng's PNG_HAVE_PLTE mode bit: set by png_handle_PLTE for EVERY PLTE
  // passing the duplicate/after-IDAT checks, including ones later ignored
  // (grayscale, bad length).  Gates the colorspace handlers' "out of
  // place" checks and flips kept-chunk location 1 -> 2 (oracle-pinned).
  bool plte_mode = false;
  bool seen_idat = false, idat_done = false;
  size_t num_palette = 0;
  // libpng colorspace state machine (byte-visible through the sRGB tag)
  bool cs_invalid = false, from_srgb = false, have_gamma = false;
  bool have_endpoints = false, srgb_tag = false;
  uint32_t gamma_fixed = 45455;
  std::vector<uint8_t> palette, trns, idat;
  bool have_trns = false;
  std::vector<KeptChunk> kept;

  size_t pos = 8;
  while (true) {
    if (pos + 8 > len) return fail("Read error");  // EOF without IEND
    uint32_t length = be32(data + pos);
    const uint8_t* namep = data + pos + 4;
    char name[5] = {char(namep[0]), char(namep[1]), char(namep[2]),
                    char(namep[3]), 0};
    if (length > 0x7FFFFFFFu)
      return fail(std::string(name) + ": invalid chunk length");
    for (int i = 0; i < 4; i++) {
      uint8_t b = namep[i];
      if (!((b >= 65 && b <= 90) || (b >= 97 && b <= 122)))
        return fail("invalid chunk type");
    }
    // ---- header-time dispatch (libpng acts on length+name BEFORE reading
    // chunk data or CRC; everything here must precede the data-bounds
    // check and the CRC policy) ----

    bool known = is_known_handled(name) || (strip && is_kept_known(name));
    // libpng handlers check missing-IHDR at dispatch
    if (!have_ihdr && std::memcmp(name, "IHDR", 4) != 0 && known) {
      if (std::memcmp(name, "IDAT", 4) == 0)
        return fail("IDAT: Missing IHDR before IDAT");
      if (std::memcmp(name, "IEND", 4) == 0) return fail("IEND: out of place");
      return fail(std::string(name) + ": missing IHDR");
    }

    // png_read_row terminates the consecutive IDAT run at the next chunk's
    // HEADER — an intervening chunk ends the run even when its own
    // data/CRC later turn out to be truncated or corrupt
    if (seen_idat && std::memcmp(name, "IDAT", 4) != 0) idat_done = true;

    if (std::memcmp(name, "IDAT", 4) == 0 && !seen_idat) {
      // png_read_info returns at the first IDAT *header*: libpng's
      // Missing-PLTE check and rwpng's 32-bit-rowbytes guard
      // (rwpng.c:287-290, exit 24) both fire there, before any IDAT data,
      // bounds, or CRC is examined
      if (color_type == 3 && !have_plte)
        return fail("IDAT: Missing PLTE before IDAT");
      if (size_t(width) * 4 > size_t(0x7FFFFFFF) / height)
        return fail_oom("image too large for 32-bit rowbytes");
      seen_idat = true;
    }

    if (pos + 12 + size_t(length) > len) return fail("Read error");
    const uint8_t* body = data + pos + 8;
    uint32_t expect = be32(data + pos + 8 + length);
    pos += 12 + length;

    // libpng's tEXt/iTXt handlers (they run under strip — no keep-callback)
    // hit the zero-length read-past-EOF bug-compat while reading chunk
    // data, BEFORE the CRC is verified
    if (strip && length == 0 && !seen_idat &&
        (std::memcmp(name, "tEXt", 4) == 0 ||
         std::memcmp(name, "iTXt", 4) == 0))
      return fail("Read error");

    bool ancillary = (namep[0] & 0x20) != 0;
    if (expect != crc32(crc32(0, namep, 4), body, length)) {
      // critical-bit chunks (incl. unknown ones): fatal; handler-path
      // ancillary: warn + discard; unknown-path ancillary: rwpng's callback
      // stores the chunk before libpng sees the CRC result, so keep/use it
      if (!ancillary) return fail(std::string(name) + ": CRC error");
      if (known) continue;
    }

    if (std::memcmp(name, "IHDR", 4) == 0) {
      if (have_ihdr) return fail("IHDR: out of place");
      if (length != 13) return fail("IHDR: invalid");
      width = be32(body);
      height = be32(body + 4);
      bit_depth = body[8];
      color_type = body[9];
      interlace = body[12];
      const char* err = check_ihdr(width, height, bit_depth, color_type,
                                   body[10], body[11], interlace);
      if (err) return fail(err);
      have_ihdr = true;
    } else if (std::memcmp(name, "PLTE", 4) == 0) {
      // png_handle_PLTE: after IDAT benign; duplicate fatal; grayscale
      // benign; bad length fatal iff palette image
      if (seen_idat) continue;
      if (plte_mode) return fail("PLTE: duplicate");
      // mode bit set before the grayscale/length checks, so an ignored
      // PLTE still moves later kept chunks to location 2 and makes a
      // second PLTE a fatal duplicate
      plte_mode = true;
      if (color_type == 0 || color_type == 4) continue;
      if (length > 768 || length % 3) {
        if (color_type == 3) return fail("PLTE: invalid");
        continue;
      }
      // zero length passes the handler's length check (0 % 3 == 0) and is
      // fatal in png_set_PLTE's num_palette == 0 guard, every color type
      if (length == 0) return fail("Invalid palette");
      palette.assign(body, body + length);
      num_palette = length / 3;
      have_plte = true;
    } else if (std::memcmp(name, "IDAT", 4) == 0) {
      // first-IDAT checks (Missing PLTE, rowbytes guard) fired at
      // header-dispatch time above
      if (idat_done) continue;  // IDATs after the run ended are tolerated
      idat.insert(idat.end(), body, body + length);
    } else if (std::memcmp(name, "IEND", 4) == 0) {
      if (!seen_idat) return fail("IEND: out of place");
      break;
    } else if (std::memcmp(name, "tRNS", 4) == 0) {
      // png_handle_tRNS: every malformed shape is a benign discard
      if (seen_idat || have_trns || length == 0) continue;
      if (color_type == 0) {
        if (length != 2) continue;
      } else if (color_type == 2) {
        if (length != 6) continue;
      } else if (color_type == 3) {
        if (!have_plte || length > num_palette) continue;
      } else {
        continue;  // "invalid with alpha channel"
      }
      trns.assign(body, body + length);
      have_trns = true;
    } else if (std::memcmp(name, "gAMA", 4) == 0) {
      if (plte_mode || seen_idat || length != 4) continue;
      uint32_t g = be32(body);
      if (cs_invalid || from_srgb) continue;  // FROM_sRGB: gAMA ignored
      if (g < 16 || g > 625000000u || have_gamma) {
        // out-of-range or duplicate: colorspace INVALID (sticky), sRGB lost
        cs_invalid = true;
        srgb_tag = false;
        continue;
      }
      have_gamma = true;
      gamma_fixed = g;
    } else if (std::memcmp(name, "sRGB", 4) == 0) {
      if (plte_mode || seen_idat || length != 1 || body[0] > 3) continue;
      if (cs_invalid) continue;
      if (from_srgb) {  // second sRGB (any intent) invalidates
        cs_invalid = true;
        srgb_tag = false;
        continue;
      }
      from_srgb = true;
      have_gamma = true;
      srgb_tag = true;
      gamma_fixed = 45455;
    } else if (std::memcmp(name, "cHRM", 4) == 0) {
      if (plte_mode || seen_idat || length != 32) continue;
      if (cs_invalid || from_srgb) continue;
      uint32_t v[8];
      for (int i = 0; i < 8; i++) v[i] = be32(body + 4 * i);
      if (!chrm_valid(v) || have_endpoints) {
        cs_invalid = true;
        srgb_tag = false;
        continue;
      }
      have_endpoints = true;
    } else if (is_known_handled(name) || (strip && is_kept_known(name))) {
      // iCCP/sBIT/bKGD/hIST/tIME/oFFs/pCAL/sCAL/sPLT/sTER/eXIf/acTL/fcTL/
      // fdAT (+ keep-list under strip): handled by libpng, never re-emitted
      // (the zero-length tEXt/iTXt read-past-EOF bug-compat fired pre-CRC,
      // above)
      continue;
    } else {
      // unknown path (read_chunk_callback + libpng write-side policy):
      // keep iff safe-to-copy, after IHDR (location != 0), before IDAT
      if (strip) {
        // no keep-callback under strip: unknown CRITICAL chunks are fatal
        // in png_read_info but tolerated after IDAT (read_end)
        if (!ancillary && !seen_idat)
          return fail(std::string(name) + ": unhandled critical chunk");
        continue;
      }
      if (!have_ihdr || seen_idat) continue;
      if (is_kept_known(name) || (namep[3] & 0x20) != 0) {
        KeptChunk c;
        std::memcpy(c.name, name, 4);
        // libpng normalises the location to its top-most mode bit
        // (pngset.c check_location): before any PLTE -> 1 (PNG_HAVE_IHDR),
        // after one -> 2 (PNG_HAVE_PLTE); the groups are written at
        // different png_write_info points
        c.location = plte_mode ? 2 : 1;
        c.data.assign(body, body + length);
        kept.push_back(std::move(c));
      }
    }
  }
  int channels = kChannels[color_type];

  // gamma/sRGB bookkeeping (rwpng.c:258-275)
  double gamma = 0.45455;
  int transform;
  if (srgb_tag) {
    transform = 1;  // srgb
  } else {
    double g = (have_gamma && !cs_invalid) ? gamma_fixed / 100000.0 : 0.45455;
    if (g > 0 && g <= 1.0) {
      gamma = g;
      transform = 2;  // gama_only
    } else {
      transform = 0;  // none
    }
  }

  const int sample_bits_pre = bit_depth * channels;
  size_t needed;
  if (interlace == 0) {
    needed = size_t(height) * ((size_t(width) * sample_bits_pre + 7) / 8 + 1);
  } else {
    needed = 0;
    for (const auto& p : kAdam7) {
      uint32_t w = (width > uint32_t(p.x0)) ? (width - p.x0 + p.dx - 1) / p.dx : 0;
      uint32_t h = (height > uint32_t(p.y0)) ? (height - p.y0 + p.dy - 1) / p.dy : 0;
      if (w && h) needed += size_t(h) * ((size_t(w) * sample_bits_pre + 7) / 8 + 1);
    }
  }
  std::vector<uint8_t> raw;
  switch (inflate_idat(idat, needed, &raw)) {
    case 0: break;
    case 1: return fail("Not enough image data");
    case 2: return fail("IDAT: incorrect data check");
    default: return fail("IDAT: invalid stream");
  }
  // check completeness BEFORE allocating the sample planes
  if (raw.size() < needed) return fail("Not enough image data");

  const int sample_bits = bit_depth * channels;
  std::vector<int32_t> samples(size_t(width) * height * channels, 0);

  auto read_subimage = [&](const uint8_t* buf, size_t buf_len, uint32_t w,
                           uint32_t h, std::vector<int32_t>* sub) -> bool {
    size_t rowbytes = (size_t(w) * sample_bits + 7) / 8;
    int bpp_bytes = sample_bits / 8 < 1 ? 1 : sample_bits / 8;
    std::vector<uint8_t> unf;
    if (!unfilter(const_cast<uint8_t*>(buf), buf_len, w, h, bpp_bytes, rowbytes, &unf))
      return false;
    sub->assign(size_t(w) * h * channels, 0);
    for (uint32_t y = 0; y < h; y++) {
      bits_to_samples(unf.data() + size_t(y) * rowbytes, bit_depth,
                      size_t(w) * channels, sub->data() + size_t(y) * w * channels);
    }
    return true;
  };

  if (interlace == 0) {
    if (!read_subimage(raw.data(), raw.size(), width, height, &samples))
      return fail("Not enough image data");
  } else if (interlace == 1) {
    size_t off = 0;
    for (const auto& p : kAdam7) {
      uint32_t w = (width > uint32_t(p.x0)) ? (width - p.x0 + p.dx - 1) / p.dx : 0;
      uint32_t h = (height > uint32_t(p.y0)) ? (height - p.y0 + p.dy - 1) / p.dy : 0;
      if (w == 0 || h == 0) continue;
      size_t rowbytes = (size_t(w) * sample_bits + 7) / 8;
      size_t nbytes = size_t(h) * (rowbytes + 1);
      if (off + nbytes > raw.size()) return fail("Not enough image data");
      std::vector<int32_t> sub;
      if (!read_subimage(raw.data() + off, nbytes, w, h, &sub))
        return fail("Not enough image data");
      off += nbytes;
      for (uint32_t y = 0; y < h; y++)
        for (uint32_t x = 0; x < w; x++)
          for (int c = 0; c < channels; c++)
            samples[(size_t(p.y0 + y * p.dy) * width + (p.x0 + x * p.dx)) * channels + c] =
                sub[(size_t(y) * w + x) * channels + c];
    }
  } else {
    return fail("bad interlace method");
  }

  // samples -> normalized RGBA8
  uint8_t* rgba = static_cast<uint8_t*>(std::malloc(size_t(width) * height * 4));
  if (!rgba) return fail_oom("unable to allocate image data");
  const int maxval = (1 << bit_depth) - 1;

  if (color_type == 3) {
    // libpng calloc's a 256-entry palette (png_set_PLTE): out-of-range
    // indices decode to black, never an error; tRNS entries beyond its
    // length are opaque (png_do_expand_palette)
    uint8_t pal256[256][3] = {};
    uint8_t alpha256[256];
    std::memset(alpha256, 255, sizeof(alpha256));
    for (size_t c = 0; c < num_palette && c < 256; c++)
      for (int k = 0; k < 3; k++) pal256[c][k] = palette[c * 3 + k];
    for (size_t c = 0; c < trns.size() && c < 256; c++) alpha256[c] = trns[c];
    for (size_t i = 0; i < size_t(width) * height; i++) {
      int32_t idx = samples[i] & 0xFF;
      rgba[i * 4 + 0] = pal256[idx][0];
      rgba[i * 4 + 1] = pal256[idx][1];
      rgba[i * 4 + 2] = pal256[idx][2];
      rgba[i * 4 + 3] = alpha256[idx];
    }
  } else if (color_type == 0) {
    int tg = -1;
    if (trns.size() >= 2) tg = ((trns[0] << 8) | trns[1]) & maxval;
    for (size_t i = 0; i < size_t(width) * height; i++) {
      int32_t g = samples[i];
      int32_t a = (tg >= 0 && g == tg) ? 0 : maxval;
      if (bit_depth < 8) {
        g *= 255 / maxval;
        a *= 255 / maxval;
      } else if (bit_depth == 16) {
        g >>= 8;
        a >>= 8;
      }
      rgba[i * 4 + 0] = rgba[i * 4 + 1] = rgba[i * 4 + 2] = uint8_t(g);
      rgba[i * 4 + 3] = uint8_t(a);
    }
  } else if (color_type == 4) {
    for (size_t i = 0; i < size_t(width) * height; i++) {
      int32_t g = samples[i * 2], a = samples[i * 2 + 1];
      if (bit_depth == 16) {
        g >>= 8;
        a >>= 8;
      }
      rgba[i * 4 + 0] = rgba[i * 4 + 1] = rgba[i * 4 + 2] = uint8_t(g);
      rgba[i * 4 + 3] = uint8_t(a);
    }
  } else if (color_type == 2) {
    int tr = -1, tg = -1, tb = -1;
    if (trns.size() >= 6) {
      tr = ((trns[0] << 8) | trns[1]) & maxval;
      tg = ((trns[2] << 8) | trns[3]) & maxval;
      tb = ((trns[4] << 8) | trns[5]) & maxval;
    }
    for (size_t i = 0; i < size_t(width) * height; i++) {
      int32_t r = samples[i * 3], g = samples[i * 3 + 1], b = samples[i * 3 + 2];
      int32_t a = (tr >= 0 && r == tr && g == tg && b == tb) ? 0 : maxval;
      if (bit_depth == 16) {
        r >>= 8;
        g >>= 8;
        b >>= 8;
        a >>= 8;
      }
      rgba[i * 4 + 0] = uint8_t(r);
      rgba[i * 4 + 1] = uint8_t(g);
      rgba[i * 4 + 2] = uint8_t(b);
      rgba[i * 4 + 3] = uint8_t(a);
    }
  } else {  // color_type == 6
    for (size_t i = 0; i < size_t(width) * height; i++) {
      for (int c = 0; c < 4; c++) {
        int32_t v = samples[i * 4 + c];
        if (bit_depth == 16) v >>= 8;
        rgba[i * 4 + c] = uint8_t(v);
      }
    }
  }

  // rwpng's read_chunk_callback PREPENDS kept chunks to a linked list
  // (rwpng.c:152-153) and the writer walks it in order: emitted order is
  // the REVERSE of read order within a location group
  std::reverse(kept.begin(), kept.end());
  std::vector<uint8_t> blob;
  serialize_chunks(kept, blob);
  uint8_t* blob_out = nullptr;
  if (!blob.empty()) {
    blob_out = static_cast<uint8_t*>(std::malloc(blob.size()));
    std::memcpy(blob_out, blob.data(), blob.size());
  }

  *out_rgba = rgba;
  *out_w = width;
  *out_h = height;
  *out_gamma = gamma;
  *out_transform = transform;
  *out_chunks = blob_out;
  *out_chunks_len = blob.size();
  return PL_OK;
}

}  // namespace

extern "C" {

const char* pl_last_error() { return g_error.c_str(); }
void pl_free(void* p) { std::free(p); }

// Exception-safe ABI boundary: nothing may escape into ctypes (a crafted
// PNG declaring huge dimensions previously escaped std::bad_alloc here,
// aborting the whole process; the reference exits cleanly with code 24,
// rwpng.c:287-296 / pngloss.c:196-205).
int pl_decode(const uint8_t* data, size_t len, int strip,
              uint8_t** out_rgba, uint32_t* out_w, uint32_t* out_h,
              double* out_gamma, int* out_transform,
              uint8_t** out_chunks, size_t* out_chunks_len) {
  try {
    return pl_decode_impl(data, len, strip, out_rgba, out_w, out_h,
                          out_gamma, out_transform, out_chunks,
                          out_chunks_len);
  } catch (const std::bad_alloc&) {
    return fail_oom("insufficient memory");
  } catch (const std::exception& e) {
    return fail(std::string("internal decode error: ") + e.what());
  } catch (...) {
    return fail("internal decode error");
  }
}

}  // extern "C"

namespace {

// ---------------------------------------------------------------------------
// Encoding
// ---------------------------------------------------------------------------

void apply_filter_row(const uint8_t* prev, const uint8_t* row, int f, int bpp,
                      size_t rowbytes, uint8_t* out) {
  switch (f) {
    case 0:
      std::memcpy(out, row, rowbytes);
      break;
    case 1:
      for (size_t x = 0; x < rowbytes; x++) {
        int left = x >= size_t(bpp) ? row[x - bpp] : 0;
        out[x] = uint8_t(row[x] - left);
      }
      break;
    case 2:
      for (size_t x = 0; x < rowbytes; x++) {
        int up = prev ? prev[x] : 0;
        out[x] = uint8_t(row[x] - up);
      }
      break;
    case 3:
      for (size_t x = 0; x < rowbytes; x++) {
        int left = x >= size_t(bpp) ? row[x - bpp] : 0;
        int up = prev ? prev[x] : 0;
        out[x] = uint8_t(row[x] - ((left + up) >> 1));
      }
      break;
    default:
      for (size_t x = 0; x < rowbytes; x++) {
        int left = x >= size_t(bpp) ? row[x - bpp] : 0;
        int up = prev ? prev[x] : 0;
        int diag = (prev && x >= size_t(bpp)) ? prev[x - bpp] : 0;
        int p = left + up - diag;
        int pa = std::abs(p - left), pb = std::abs(p - up), pc = std::abs(p - diag);
        int pred = (pa <= pb && pa <= pc) ? left : (pb <= pc ? up : diag);
        out[x] = uint8_t(row[x] - pred);
      }
      break;
  }
}

// ---------------------------------------------------------------------------
// zlib-version canary (round-3 verdict Weak #6 / advisor finding #3):
// fast_deflate.cpp clones zlib 1.2.13's level-9/Z_FILTERED emission
// decision-for-decision, and the repo's byte-parity goldens assume the
// SYSTEM libz behaves the same (the oracle links against it).  On a host
// whose libz is zlib-ng or a future zlib with changed deflate output, the
// clone and libz would silently diverge; compress one canary buffer through
// both ONCE and auto-fall back to libz (matching the local toolchain) with
// a warning if they disagree.
// ---------------------------------------------------------------------------

static bool fast_deflate_canary_run() {
  const char* force = std::getenv("PNGLOSS_FD_CANARY_FORCE_FAIL");
  bool forced_fail = force != nullptr && *force != '\0' &&
                     std::strcmp(force, "0") != 0;
  // canary: filtered-residual-like data — noise, zero runs, repeated
  // motifs at several distances (exercises match emission, lazy matching
  // and run handling, where deflate forks diverge first)
  std::vector<uint8_t> canary;
  canary.reserve(8192);
  uint32_t lcg = 0x12345678u;
  for (int i = 0; i < 2048; i++) {
    lcg = lcg * 1664525u + 1013904223u;
    canary.push_back(uint8_t((lcg >> 13) & 0x1F) - 16);
  }
  canary.insert(canary.end(), 1024, 0);
  for (int rep = 0; rep < 16; rep++)
    canary.insert(canary.end(), canary.begin() + rep * 37,
                  canary.begin() + rep * 37 + 200);
  for (int i = 0; i < 1024; i++) canary.push_back(uint8_t(i * 7));

  std::vector<uint8_t> viaz;
  z_stream zs{};
  if (deflateInit2(&zs, 9, Z_DEFLATED, 15, 9, Z_FILTERED) != Z_OK)
    return false;
  std::vector<uint8_t> zbuf(1 << 16);
  zs.next_in = canary.data();
  zs.avail_in = uInt(canary.size());
  int ret;
  do {
    zs.next_out = zbuf.data();
    zs.avail_out = uInt(zbuf.size());
    ret = deflate(&zs, Z_FINISH);
    viaz.insert(viaz.end(), zbuf.data(),
                zbuf.data() + (zbuf.size() - zs.avail_out));
  } while (zs.avail_out == 0 || ret != Z_STREAM_END);
  deflateEnd(&zs);

  uint8_t* fd_data = nullptr;
  size_t fd_len = 0;
  bool match = false;
  if (fast_deflate9_filtered(canary.data(), canary.size(), &fd_data,
                             &fd_len) == 0) {
    match = fd_len == viaz.size() &&
            std::memcmp(fd_data, viaz.data(), fd_len) == 0;
    std::free(fd_data);
  }
  if (forced_fail) match = false;
  if (!match) {
    std::fprintf(stderr,
                 "pngloss-jax: system zlib (%s) deviates from the cloned "
                 "1.2.13 deflate on the canary buffer — falling back to "
                 "libz so output stays byte-identical to the local "
                 "toolchain\n", zlibVersion());
  }
  return match;
}

bool fast_deflate_canary_ok() {
  // C++ magic-static init: thread-safe single evaluation even when the
  // first encodes arrive concurrently (the website's ThreadingHTTPServer
  // can issue two first uploads at once)
  static const bool ok = fast_deflate_canary_run();
  return ok;
}

int msad_choice(const uint8_t* prev, const uint8_t* row, int bpp,
                size_t rowbytes, uint8_t* scratch, bool single_row_image) {
  // libpng candidate restrictions (verified empirically): SINGLE-ROW
  // images try only NONE and SUB (AVG is excluded even when its sum
  // wins); row 0 of taller images uses all five with a zeroed previous
  // row; single-pixel rows never produce SUB/AVG/PAETH
  const int all[5] = {0, 1, 2, 3, 4};
  const int h1_row[2] = {0, 1};
  const int h1_single[1] = {0};
  const int single_pixel[2] = {0, 2};
  bool single = rowbytes <= size_t(bpp);
  const int* cand = all;
  int ncand = 5;
  if (single_row_image) {
    cand = single ? h1_single : h1_row;
    ncand = single ? 1 : 2;
  } else if (single) {
    cand = single_pixel;
    ncand = 2;
  }
  int best = 0;
  uint64_t best_sum = ~0ULL;
  for (int i = 0; i < ncand; i++) {
    int f = cand[i];
    apply_filter_row(prev, row, f, bpp, rowbytes, scratch);
    uint64_t s = 0;
    for (size_t x = 0; x < rowbytes; x++) {
      uint8_t v = scratch[x];
      s += v < 128 ? v : 256 - v;
    }
    if (s < best_sum) {
      best = f;
      best_sum = s;
    }
  }
  return best;
}

}  // namespace

extern "C" {

// rgba: (h, w, 4) uint8. row_filters: h int8 entries or NULL for all-adaptive.
// transform: 0=none, 1=srgb, 2=gama_only. Returns PL_OK or PL_TOO_LARGE (the
// output buffer is filled in BOTH cases, matching rwpng.c:631-633 semantics).
static int pl_encode_impl(const uint8_t* rgba, uint32_t w, uint32_t h,
                          const int8_t* row_filters, double gamma,
                          int transform, const uint8_t* chunks_blob,
                          size_t chunks_len, size_t maximum_file_size,
                          uint8_t** out_data, size_t* out_len) {
  if (!rgba || w == 0 || h == 0) {
    g_error = "bad arguments";
    return PL_BAD_ARGS;
  }
  std::vector<KeptChunk> chunks;
  if (chunks_blob && !parse_chunks(chunks_blob, chunks_len, &chunks)) {
    g_error = "bad chunk blob";
    return PL_BAD_ARGS;
  }

  // gray/alpha re-detection (rwpng.c:557-573)
  const size_t npix = size_t(w) * h;
  bool grayscale = true, opaque = true;
  for (size_t i = 0; i < npix && (grayscale || opaque); i++) {
    const uint8_t* p = rgba + i * 4;
    if (p[0] != p[1] || p[1] != p[2]) grayscale = false;
    if (p[3] != 255) opaque = false;
  }
  int bpp, color_type;
  if (grayscale && opaque) {
    bpp = 1;
    color_type = 0;
  } else if (grayscale) {
    bpp = 2;
    color_type = 4;
  } else if (opaque) {
    bpp = 3;
    color_type = 2;
  } else {
    bpp = 4;
    color_type = 6;
  }
  const size_t rowbytes = size_t(w) * bpp;
  std::vector<uint8_t> packed(size_t(h) * rowbytes);
  for (size_t i = 0; i < npix; i++) {
    const uint8_t* p = rgba + i * 4;
    uint8_t* q = packed.data() + i * bpp;
    if (color_type == 0) {
      q[0] = p[1];  // green carries luminance (rwpng.c:587)
    } else if (color_type == 4) {
      q[0] = p[1];
      q[1] = p[3];
    } else if (color_type == 2) {
      q[0] = p[0];
      q[1] = p[1];
      q[2] = p[2];
    } else {
      std::memcpy(q, p, 4);
    }
  }

  std::vector<uint8_t> out;
  out.reserve(npix + 1024);
  out.insert(out.end(), kSig, kSig + 8);

  auto put_chunk = [&](const char* name, const uint8_t* body, size_t n) {
    put_be32(out, uint32_t(n));
    size_t name_pos = out.size();
    out.insert(out.end(), name, name + 4);
    out.insert(out.end(), body, body + n);
    uint32_t crc = crc32(0, out.data() + name_pos, uInt(4 + n));
    put_be32(out, crc);
  };

  uint8_t ihdr[13];
  ihdr[0] = uint8_t(w >> 24); ihdr[1] = uint8_t(w >> 16);
  ihdr[2] = uint8_t(w >> 8); ihdr[3] = uint8_t(w);
  ihdr[4] = uint8_t(h >> 24); ihdr[5] = uint8_t(h >> 16);
  ihdr[6] = uint8_t(h >> 8); ihdr[7] = uint8_t(h);
  ihdr[8] = 8;
  ihdr[9] = uint8_t(color_type);
  ihdr[10] = ihdr[11] = ihdr[12] = 0;
  put_chunk("IHDR", ihdr, 13);

  // gamma/sRGB chunks (rwpng_set_gamma, rwpng.c:505-513): only non-default
  // transforms emit gAMA; sRGB additionally emits the sRGB chunk
  if (transform != 0 && transform != 2) {
    uint32_t g = uint32_t(gamma * 100000.0 + 0.5);
    uint8_t body[4] = {uint8_t(g >> 24), uint8_t(g >> 16), uint8_t(g >> 8), uint8_t(g)};
    put_chunk("gAMA", body, 4);
  }
  if (transform == 1) {
    uint8_t z = 0;
    put_chunk("sRGB", &z, 1);
  }
  for (const auto& c : chunks)
    if (c.location != 2 && c.location != 8)
      put_chunk(c.name, c.data.data(), c.data.size());
  // location-2 chunks at png_write_info's later write point — after the
  // whole location-1 group, reversed read order preserved within groups
  for (const auto& c : chunks)
    if (c.location == 2) put_chunk(c.name, c.data.data(), c.data.size());

  // filter + deflate (level 9, memLevel 9, Z_FILTERED — rwpng.c:471-472 and
  // libpng's strategy default when row filtering is in use). The filtered
  // scanlines are buffered and compressed in one shot: deflate emits no
  // flush points under Z_NO_FLUSH, so streamed and one-shot bytes are
  // identical, and the one-shot form can route through fast_deflate.cpp's
  // byte-identical level-9 clone (~1.4-3x faster on lossy scanline data).
  std::vector<uint8_t> filt;
  filt.reserve(size_t(h) * (rowbytes + 1));
  std::vector<uint8_t> line(rowbytes + 1);
  std::vector<uint8_t> scratch(rowbytes);

  const uint8_t* prev = nullptr;
  for (uint32_t y = 0; y < h; y++) {
    const uint8_t* row = packed.data() + size_t(y) * rowbytes;
    int f;
    if (y == 0 || row_filters == nullptr) {
      f = msad_choice(prev, row, bpp, rowbytes, scratch.data(), h == 1);
    } else {
      f = row_filters[y];
      // libpng ignores forced SUB/AVG/PAETH on single-pixel rows
      if (rowbytes <= size_t(bpp) && (f == 1 || f == 3 || f == 4)) f = 0;
    }
    line[0] = uint8_t(f);
    apply_filter_row(prev, row, f, bpp, rowbytes, line.data() + 1);
    filt.insert(filt.end(), line.begin(), line.end());
    prev = row;
  }

  std::vector<uint8_t> stream;
  const char* no_fast = std::getenv("PNGLOSS_NO_FAST_DEFLATE");
  bool skip_fast = (no_fast != nullptr && *no_fast != '\0' &&
                    std::strcmp(no_fast, "0")) ||
                   !fast_deflate_canary_ok();
  if (skip_fast) {
    // reference path: the system zlib, for debugging/differential checks
    z_stream zs{};
    if (deflateInit2(&zs, 9, Z_DEFLATED, 15, 9, Z_FILTERED) != Z_OK) {
      g_error = "deflateInit2 failed";
      return PL_BAD_ARGS;
    }
    // feed in sub-4GiB slices: a single avail_in assignment would silently
    // truncate filtered streams >= 4 GiB (uInt is 32-bit)
    std::vector<uint8_t> zbuf(1 << 16);
    size_t fed = 0;
    for (;;) {
      size_t slice = filt.size() - fed;
      if (slice > (size_t(1) << 31)) slice = size_t(1) << 31;
      zs.next_in = filt.data() + fed;
      zs.avail_in = uInt(slice);
      fed += slice;
      int flush = (fed == filt.size()) ? Z_FINISH : Z_NO_FLUSH;
      int ret;
      do {
        zs.next_out = zbuf.data();
        zs.avail_out = uInt(zbuf.size());
        ret = deflate(&zs, flush);
        stream.insert(stream.end(), zbuf.data(),
                      zbuf.data() + (zbuf.size() - zs.avail_out));
      } while (zs.avail_out == 0 ||
               (flush == Z_FINISH && ret != Z_STREAM_END));
      if (flush == Z_FINISH) break;
    }
    deflateEnd(&zs);
  } else {
    uint8_t* zdata = nullptr;
    size_t zlen = 0;
    if (fast_deflate9_filtered(filt.data(), filt.size(), &zdata, &zlen) != 0) {
      g_error = "fast_deflate failed";
      return PL_BAD_ARGS;
    }
    stream.assign(zdata, zdata + zlen);
    std::free(zdata);
  }

  // libpng's optimize_cmf: claim the smallest deflate window covering the
  // scanline data (pngwutil.c); deflate bytes are unaffected.
  size_t data_size = size_t(h) * (rowbytes + 1);
  if (data_size <= 16384 && !stream.empty() && (stream[0] & 0x0F) == 8 &&
      (stream[0] & 0xF0) <= 0x70) {
    unsigned z_cinfo = stream[0] >> 4;
    unsigned half = 1u << (z_cinfo + 7);
    if (data_size <= half) {
      do {
        half >>= 1;
        z_cinfo--;
      } while (z_cinfo > 0 && data_size <= half);
      uint8_t cmf = uint8_t((stream[0] & 0x0F) | (z_cinfo << 4));
      stream[0] = cmf;
      unsigned tmp = stream[1] & 0xE0;
      tmp += 0x1F - ((unsigned(cmf) << 8) + tmp) % 0x1F;
      stream[1] = uint8_t(tmp);
    }
  }

  for (size_t i = 0; i < stream.size(); i += 8192) {
    size_t n = stream.size() - i < 8192 ? stream.size() - i : 8192;
    put_chunk("IDAT", stream.data() + i, n);
  }
  for (const auto& c : chunks)
    if (c.location == 8) put_chunk(c.name, c.data.data(), c.data.size());
  put_chunk("IEND", nullptr, 0);

  uint8_t* buf = static_cast<uint8_t*>(std::malloc(out.size()));
  std::memcpy(buf, out.data(), out.size());
  *out_data = buf;
  *out_len = out.size();
  if (maximum_file_size && out.size() > maximum_file_size) {
    g_error = "output exceeds maximum_file_size";
    return PL_TOO_LARGE;
  }
  return PL_OK;
}

// 1 when the fast-deflate clone is active (canary matched the system
// libz), 0 when encoding falls back to libz.  For tests and diagnostics.
int pl_fast_deflate_active() {
  const char* no_fast = std::getenv("PNGLOSS_NO_FAST_DEFLATE");
  if (no_fast != nullptr && *no_fast != '\0' && std::strcmp(no_fast, "0"))
    return 0;
  return fast_deflate_canary_ok() ? 1 : 0;
}

int pl_encode(const uint8_t* rgba, uint32_t w, uint32_t h,
              const int8_t* row_filters, double gamma, int transform,
              const uint8_t* chunks_blob, size_t chunks_len,
              size_t maximum_file_size, uint8_t** out_data, size_t* out_len) {
  try {
    return pl_encode_impl(rgba, w, h, row_filters, gamma, transform,
                          chunks_blob, chunks_len, maximum_file_size,
                          out_data, out_len);
  } catch (const std::bad_alloc&) {
    g_error = "insufficient memory";
    return PL_PNG_OOM;
  } catch (const std::exception& e) {
    g_error = std::string("internal encode error: ") + e.what();
    return PL_BAD_ARGS;
  } catch (...) {
    g_error = "internal encode error";
    return PL_BAD_ARGS;
  }
}

}  // extern "C"

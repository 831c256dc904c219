"""pngloss-compatible command line driver.

Option surface, validation, exit codes, output naming, overwrite guard,
atomic writes, stdin/stdout modes and verbose reporting mirror the reference
CLI (pngloss.c:94-225, pngloss_opts.c:38-138, rwpng.h:23-38) on top of the
batched device pipeline.
"""

from __future__ import annotations

import getopt
import io
import os
import sys
import tempfile

from pngloss_jax import codec
from pngloss_jax.version import __version__

# pngloss_error (rwpng.h:23-38) — enum values double as process exit codes
SUCCESS = 0
MISSING_ARGUMENT = 1
READ_ERROR = 2
INVALID_ARGUMENT = 4
NOT_OVERWRITING_ERROR = 15
CANT_WRITE_ERROR = 16
OUT_OF_MEMORY_ERROR = 17
PNG_OUT_OF_MEMORY_ERROR = 24
LIBPNG_FATAL_ERROR = 25
WRONG_INPUT_COLOR_TYPE = 26
LIBPNG_INIT_ERROR = 35
TOO_LARGE_FILE = 98
TOO_LOW_QUALITY = 99

# user documentation wording follows the reference tool's help text
# (PNGLOSS_USAGE, pngloss.c:28-51) so reference users see the interface
# they know; only the header line and the device note differ
USAGE = """\
usage:  pngloss [options] -- pngfile [pngfile ...]
        pngloss [options] - >stdout <stdin

options:
  -s, --strength 19 how much quality to sacrifice, from 0 to 100 (default 19)
  -b, --bleed 2     bleed divider, from 1 (full dithering) to 32767 (none)
  -f, --force       overwrite existing output files
  -o, --output file destination file path to use instead of --ext
  -v, --verbose     print status messages
  -q, --quiet       don't print status messages (default, overrides -v)
  -V, --version     print version number
  --skip-if-larger  only save converted files if they're smaller than original
  --ext new.png     set custom suffix/extension for output filenames
  --strip           remove optional metadata (default on Mac)

Lossily compresses a PNG by using more compressible colors that are
close enough to the original color values. The threshold determining
what is close enough is controlled by the strength parameter. The output
filename is the same as the input name except that it ends in "-loss.png"
or your custom extension (unless the input is stdin, in which case the
compressed image will go to stdout).  If you pass the special output path
"-" and a single input file, that file will be processed and the
compressed image will go to stdout. The default behavior if the output
file exists is to skip the conversion; use --force to overwrite.
"""

_LONG_OPTS = [
    "verbose", "quiet", "force", "no-force", "ext=", "skip-if-larger",
    "output=", "strip", "version", "help", "strength=", "bleed=",
]


class Options:
    def __init__(self):
        self.strength = 19
        self.bleed_divider = 2
        self.extension: str | None = None
        self.output_file_path: str | None = None
        self.files: list[str] = []
        self.using_stdin = False
        self.using_stdout = False
        self.force = False
        self.skip_if_larger = False
        self.strip = False
        self.print_help = False
        self.print_version = False
        self.missing_arguments = False
        self.verbose = False


def parse_options(argv: list[str]) -> tuple[Options, int]:
    """pngloss_parse_options (pngloss_opts.c:38-138)."""
    o = Options()
    try:
        opts, args = getopt.gnu_getopt(
            argv, "vqfo:Vhs:b:", _LONG_OPTS)
    except getopt.GetoptError as e:
        print(e, file=sys.stderr)
        return o, INVALID_ARGUMENT

    for flag, val in opts:
        if flag in ("-v", "--verbose"):
            o.verbose = True
        elif flag in ("-q", "--quiet"):
            o.verbose = False
        elif flag in ("-f", "--force"):
            o.force = True
        elif flag == "--no-force":
            o.force = False
        elif flag == "--ext":
            o.extension = val
        elif flag in ("-o", "--output"):
            if o.output_file_path:
                print("--output option can be used only once", file=sys.stderr)
                return o, INVALID_ARGUMENT
            if val == "-":
                o.using_stdout = True
            else:
                o.output_file_path = val
        elif flag == "--skip-if-larger":
            o.skip_if_larger = True
        elif flag == "--strip":
            o.strip = True
        elif flag in ("-h", "--help"):
            o.print_help = True
        elif flag in ("-V", "--version"):
            o.print_version = True
        elif flag in ("-s", "--strength"):
            if not val.isdigit():
                print("-s, --strength requires a numeric argument", file=sys.stderr)
                return o, INVALID_ARGUMENT
            o.strength = int(val)
        elif flag in ("-b", "--bleed"):
            if not val.isdigit():
                print("-b, --bleed requires a numeric argument", file=sys.stderr)
                return o, INVALID_ARGUMENT
            o.bleed_divider = int(val)

    if args:
        if len(args) == 1 and args[0] == "-":
            o.using_stdin = True
            o.using_stdout = o.output_file_path is None or o.using_stdout
        o.files = args
    elif len(argv) == 0:
        o.missing_arguments = True
    return o, SUCCESS


def add_filename_extension(filename: str, newext: str) -> str:
    """Insert the suffix before a trailing .png, else append (pngloss.c:319)."""
    if filename.lower().endswith(".png"):
        return filename[:-4] + newext
    return filename + newext


def _write_atomic(outname: str, data: bytes) -> int:
    """Atomic write via temp file + rename (pngloss.c:392-423)."""
    d = os.path.dirname(outname) or "."
    try:
        fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
        with os.fdopen(fd, "wb") as f:
            f.write(data)
        os.replace(tmp, outname)
    except OSError:
        try:
            os.unlink(tmp)
        except Exception:
            pass
        return CANT_WRITE_ERROR
    return SUCCESS


def _compress_one(
    data: bytes, opts: Options, verbose_name: str, mesh=None,
) -> tuple[bytes | None, bytes | None, int, "codec.DecodedImage | None"]:
    """Read/optimize/encode one file's bytes. Returns
    (output_bytes, fallback_original_bytes, retval, decoded_image)."""
    from pngloss_jax import pipeline  # deferred: keep -h/-V JAX-free

    try:
        img = codec.decode(data, strip=opts.strip)
    except codec.PngDecodeError as e:
        _report_decode_error(e, verbose_name, opts.using_stdin)
        # PngDecodeError carries the precise rwpng.h code (25 libpng-fatal,
        # 24 for the rwpng.c:287-290 overflow guard / allocation failure)
        return None, None, getattr(e, "exit_code", LIBPNG_FATAL_ERROR), None

    if opts.verbose:
        _report_input_color(img, len(data))

    q, filters = pipeline.optimize_rgba(
        img.rgba, opts.strength, opts.bleed_divider, mesh=mesh)

    if opts.verbose:
        # pngloss_image.c:310-325 (the per-row spinner is meaningless for a
        # batched device dispatch; the summary lines match)
        print("  compression complete", file=sys.stderr)
        n = pipeline.unique_symbol_count(
            q, filters, bpp=pipeline.working_bpp(img.rgba))
        print(f"  used {n} unique symbols", file=sys.stderr)

    max_size = len(data) - 1 if opts.skip_if_larger else 0
    try:
        out = codec.encode(
            q, row_filters=filters, gamma=img.gamma,
            color_transform=img.color_transform, chunks=img.chunks,
            maximum_file_size=max_size)
    except codec.TooLargeFile as e:
        if opts.verbose:
            kb = (max_size + 500) // 1000
            print(f"  file exceeded maximum size of {kb}KB", file=sys.stderr)
        # In stdout mode the reference has already streamed the oversized
        # attempt (the size check runs after writing, rwpng.c:631-633) and
        # then appends the original 24-bit image (pngloss.c:290-297).
        fallback = None
        if opts.using_stdout:
            fallback = e.data + codec.encode(
                img.rgba, row_filters=None, gamma=img.gamma,
                color_transform=img.color_transform, chunks=img.chunks)
        return None, fallback, TOO_LARGE_FILE, img

    return out, None, SUCCESS, img


def _print_wrote(opts, out: bytes, data: bytes, img) -> None:
    if not opts.verbose:
        return
    kb = (len(out) + 500) // 1000
    percent = 100.0 * len(out) / len(data)
    print(f"  wrote {kb}KB file ({percent:.1f}% of original)", file=sys.stderr)
    meta = sum(len(c.data) + 12 for c in img.chunks)
    if meta > 0:
        print(f"  copied {(meta + 500) // 1000}KB of additional PNG metadata",
              file=sys.stderr)


def _print_full_version(file) -> None:
    """Header shaped like the reference's print_full_version
    (pngloss.c:55-70), with its platform notes (SSE / color profiles)
    adapted honestly. Printed before usage on -h, on missing arguments,
    and (verbose-gated) on 'No input files specified.'"""
    print(f"pngloss-jax {__version__}, a batched JAX rebuild of pngloss "
          "by William MacKay, Kornel Lesinski.", file=file)
    # the device path actually in use, then dependency versions, the way
    # rwpng_version_info chains libpng/zlib versions into the header
    # (pngloss.c:77-83, rwpng.c:41)
    import zlib

    parts = [f"zlib {zlib.ZLIB_VERSION}"]
    try:
        import jax
        import jaxlib

        from pngloss_jax.ops import resolve_impl

        dev = jax.devices()[0]
        path = {"cuda": "row kernel", "xla": "XLA"}[resolve_impl()]
        print(f"   Running on {dev.platform} ({dev.device_kind}), "
              f"{path} path.", file=file)
        parts += [f"jax {jax.__version__}", f"jaxlib {jaxlib.__version__}"]
    except Exception:
        pass
    print("   Using " + ", ".join(parts) + ".", file=file)


def _report_cannot_open(filename: str) -> None:
    """read_image's fopen failure line (pngloss.c:441)."""
    print(f"  error: cannot open {filename} for reading", file=sys.stderr)


def _report_decode_error(e: Exception, filename: str,
                         using_stdin: bool = False) -> None:
    """The libpng error-handler line (rwpng.c:652) followed by
    read_image's cannot-decode line (pngloss.c:453)."""
    print(f"  error: {e} (libpng failed)", file=sys.stderr)
    print("  error: cannot decode image "
          + ("from stdin" if using_stdin else os.path.basename(filename)),
          file=sys.stderr)


def _report_input_color(img, data_len: int) -> None:
    """Verbose read-size line plus the input-color report chain
    (pngloss.c:238-254); shared by the sequential and batched modes."""
    from pngloss_jax import codec

    print(f"  read {(data_len + 500) // 1000}KB file", file=sys.stderr)
    if img.icc_note == "iccp":
        print("  used embedded ICC profile to transform image to sRGB"
              " colorspace", file=sys.stderr)
    elif img.icc_note == "gama_chrm":
        print("  used gAMA and cHRM chunks to transform image to sRGB"
              " colorspace", file=sys.stderr)
    elif img.icc_note == "iccp_warn_gray":
        print("  warning: ignored ICC profile in GRAY colorspace",
              file=sys.stderr)
    elif img.color_transform == codec.pypng.COLOR_SRGB:
        print("  passing sRGB tag from the input", file=sys.stderr)
    elif img.gamma != 0.45455:
        print(f"  converted image from gamma {1.0 / img.gamma:2.1f}"
              " to gamma 2.2", file=sys.stderr)


def run(argv: list[str], stdin: io.RawIOBase | None = None,
        stdout: io.RawIOBase | None = None, mesh=None) -> int:
    """main() (pngloss.c:94-163). Returns the process exit code."""
    opts, retval = parse_options(argv)
    if retval != SUCCESS:
        return retval

    if opts.print_version:
        print(__version__)
        return SUCCESS

    if opts.missing_arguments:
        _print_full_version(sys.stderr)
        print(USAGE, file=sys.stderr, end="")
        return MISSING_ARGUMENT

    if opts.print_help:
        _print_full_version(sys.stdout)
        print(USAGE, end="")
        return SUCCESS

    if opts.strength > 255:
        print("Must specify a strength in the range 0-255.", file=sys.stderr)
        return INVALID_ARGUMENT
    if not 1 <= opts.bleed_divider <= 32767:
        print("Must specify a bleed divider in the range 1-32767.", file=sys.stderr)
        return INVALID_ARGUMENT
    if opts.extension and opts.output_file_path:
        print("--ext and --output options can't be used at the same time",
              file=sys.stderr)
        return INVALID_ARGUMENT
    if opts.extension is None:
        opts.extension = "-loss.png"
    if opts.output_file_path and len(opts.files) != 1:
        print("  error: Only one input file is allowed when --output is used."
              " This error also happens when filenames with spaces are not in quotes.",
              file=sys.stderr)
        return INVALID_ARGUMENT
    if opts.using_stdout and not opts.using_stdin and len(opts.files) != 1:
        print("  error: Only one input file is allowed when using the special"
              " output path \"-\" to write to stdout. This error also happens"
              " when filenames with spaces are not in quotes.", file=sys.stderr)
        return INVALID_ARGUMENT
    if not opts.files and not opts.using_stdin:
        print("No input files specified.", file=sys.stderr)
        if opts.verbose:
            _print_full_version(sys.stderr)
        print(USAGE, file=sys.stderr, end="")
        return MISSING_ARGUMENT

    stdin = stdin if stdin is not None else sys.stdin.buffer
    stdout = stdout if stdout is not None else sys.stdout.buffer

    # pngloss_main_internal (pngloss.c:168-224). Multiple file inputs take
    # the batched path: same per-file behavior and output, but all images
    # go to the device as one dispatch per shape bucket.
    if len(opts.files) > 1 and not opts.using_stdin and not opts.using_stdout:
        return _run_batched(opts, mesh=mesh)

    error_count = skipped_count = file_count = 0
    latest_error = SUCCESS
    for filename in opts.files:
        display = "stdin" if opts.using_stdin else filename
        retval = SUCCESS
        outname = opts.output_file_path
        if not opts.using_stdout:
            if not outname:
                outname = add_filename_extension(filename, opts.extension)
            if not opts.force and os.path.exists(outname):
                print(f"  error: '{outname}' exists; not overwriting", file=sys.stderr)
                retval = NOT_OVERWRITING_ERROR

        if retval == SUCCESS:
            if opts.verbose:
                print(f"{display}:", file=sys.stderr)
            try:
                data = stdin.read() if opts.using_stdin else open(filename, "rb").read()
            except OSError:
                if not opts.using_stdin:
                    _report_cannot_open(filename)
                retval = READ_ERROR
                data = None
            if retval == SUCCESS:
                out, fallback, retval, img = _compress_one(
                    data, opts, display, mesh=mesh)
                if retval == SUCCESS:
                    if opts.using_stdout:
                        if opts.verbose:
                            # pngloss.c:389
                            print("  writing compressed image to stdout",
                                  file=sys.stderr)
                        stdout.write(out)
                    else:
                        if opts.verbose:
                            print(f"  writing compressed image as {outname}",
                                  file=sys.stderr)
                        retval = _write_atomic(outname, out)
                    if retval == SUCCESS:
                        _print_wrote(opts, out, data, img)
                elif fallback is not None:
                    stdout.write(fallback)

        if retval != SUCCESS:
            latest_error = retval
            if retval in (TOO_LOW_QUALITY, TOO_LARGE_FILE):
                skipped_count += 1
            else:
                error_count += 1
        file_count += 1

    _verbose_summary(opts, error_count, skipped_count, file_count)
    return latest_error


def _verbose_summary(opts, error_count, skipped_count, file_count):
    if not opts.verbose:
        return
    s = lambda n: "" if n == 1 else "s"
    if error_count:
        print(f"There were errors compressing {error_count} file{s(error_count)}"
              f" out of a total of {file_count} file{s(file_count)}.",
              file=sys.stderr)
    if skipped_count:
        print(f"Skipped {skipped_count} file{s(skipped_count)} out of a total"
              f" of {file_count} file{s(file_count)}.", file=sys.stderr)
    if not skipped_count and not error_count:
        print(f"Compressed {file_count} image{s(file_count)}.", file=sys.stderr)


def _run_batched(opts, mesh=None) -> int:
    """Multi-file batched mode: overwrite guards and reads up front, one
    batched device dispatch per shape bucket, then per-file encode+write
    with the same verbose output and exit codes as the sequential path."""
    from pngloss_jax import pipeline

    entries = []  # [filename, outname, retval, bytes|None, DecodedImage|None]
    for filename in opts.files:
        outname = opts.output_file_path or add_filename_extension(
            filename, opts.extension)
        retval = SUCCESS
        data = img = None
        if not opts.force and os.path.exists(outname):
            print(f"  error: '{outname}' exists; not overwriting", file=sys.stderr)
            retval = NOT_OVERWRITING_ERROR
        if retval == SUCCESS:
            try:
                data = open(filename, "rb").read()
            except OSError:
                _report_cannot_open(filename)
                retval = READ_ERROR
        if retval == SUCCESS:
            try:
                img = codec.decode(data, strip=opts.strip)
            except codec.PngDecodeError as e:
                _report_decode_error(e, filename)
                retval = getattr(e, "exit_code", LIBPNG_FATAL_ERROR)
        entries.append([filename, outname, retval, data, img])

    ok = [e for e in entries if e[2] == SUCCESS]
    # batched analog of the reference's per-row spinner
    # (pngloss_image.c:214-237): one progress line per dispatched bucket
    works, bpps = [], []
    for e in ok:
        work, bpp = pipeline.reduce_colorspace(e[4].rgba)
        works.append(work)
        bpps.append(bpp)
    pending = pipeline.dispatch_buckets(
        works, bpps, opts.strength, opts.bleed_divider, mesh=mesh)
    qs, fs = [None] * len(ok), [None] * len(ok)
    for pi, p in enumerate(pending):
        if opts.verbose:
            h, wb = p.q_dev.shape[1], p.q_dev.shape[2]
            print(f"  optimizing bucket {pi + 1}/{len(pending)}: "
                  f"{len(p.idxs)} image(s) at {wb // p.bpp}x{h}x{p.bpp}bpp",
                  file=sys.stderr)
        qb, fb = pipeline.collect_bucket(p)
        for k, i in enumerate(p.idxs):
            qs[i] = pipeline.restore_colorspace(
                qb[k], p.bpp, ok[i][4].rgba.shape[1])
            fs[i] = fb[k]

    error_count = skipped_count = 0
    latest_error = SUCCESS
    for j, e in enumerate(ok):
        filename, outname, _, data, img = e
        if opts.verbose:
            print(f"{filename}:", file=sys.stderr)
            _report_input_color(img, len(data))
            print("  compression complete", file=sys.stderr)
            n = pipeline.unique_symbol_count(
                qs[j], fs[j], bpp=pipeline.working_bpp(img.rgba))
            print(f"  used {n} unique symbols", file=sys.stderr)
        max_size = len(data) - 1 if opts.skip_if_larger else 0
        try:
            out = codec.encode(
                qs[j], row_filters=fs[j], gamma=img.gamma,
                color_transform=img.color_transform, chunks=img.chunks,
                maximum_file_size=max_size)
        except codec.TooLargeFile:
            if opts.verbose:
                kb = (max_size + 500) // 1000
                print(f"  file exceeded maximum size of {kb}KB", file=sys.stderr)
            e[2] = TOO_LARGE_FILE
            continue
        if opts.verbose:
            print(f"  writing compressed image as {outname}", file=sys.stderr)
        e[2] = _write_atomic(outname, out)
        if e[2] == SUCCESS:
            _print_wrote(opts, out, data, img)

    for e in entries:
        if e[2] != SUCCESS:
            latest_error = e[2]
            if e[2] in (TOO_LOW_QUALITY, TOO_LARGE_FILE):
                skipped_count += 1
            else:
                error_count += 1
    _verbose_summary(opts, error_count, skipped_count, len(entries))
    return latest_error


def main() -> None:
    sys.exit(run(sys.argv[1:]))


if __name__ == "__main__":
    main()

"""Website sidecar: endpoint behavior parity with pnglossapi.go."""

import base64
import hashlib
import subprocess
import threading
import urllib.error
import urllib.request

import pytest

from pngloss_jax.website import make_server

@pytest.fixture(scope="module")
def rose(suite_dir):
    with open(f"{suite_dir}/rose.png", "rb") as f:
        return f.read()


@pytest.fixture(scope="module")
def server(tmp_path_factory):
    store = tmp_path_factory.mktemp("store")
    srv = make_server(port=0, store=str(store))
    port = srv.server_address[1]
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    yield f"http://127.0.0.1:{port}"
    srv.shutdown()


def _post_multipart(url, fields):
    boundary = "XtestboundaryX"
    body = b""
    for name, value in fields.items():
        body += (f"--{boundary}\r\n"
                 f'Content-Disposition: form-data; name="{name}"\r\n\r\n').encode()
        body += value + b"\r\n"
    body += f"--{boundary}--\r\n".encode()
    req = urllib.request.Request(url, data=body, headers={
        "Content-Type": f"multipart/form-data; boundary={boundary}"})
    return urllib.request.urlopen(req, timeout=300)


def test_compress_and_fetch_roundtrip(server, oracle, rose):
    resp = _post_multipart(f"{server}/compress.cgi", {
        "file": rose, "strength": b"19", "bleed": b"2", "strip": b"0"})
    page = resp.read().decode()
    assert resp.status == 200 and "compressed" in page

    sum224 = base64.urlsafe_b64encode(hashlib.sha224(rose).digest()).decode()
    url = (f"{server}/compressed.cgi?sum224={sum224}"
           f"&strength=19&bleed=2&strip=0")
    data = urllib.request.urlopen(url, timeout=300).read()
    ref = subprocess.run([oracle, "-f", "-s", "19", "-b", "2", "-"],
                         input=rose, capture_output=True).stdout
    assert data == ref  # served image byte-identical to the C tool

    # re-compress by sum224 only (dedup path, no re-upload)
    resp = _post_multipart(f"{server}/compress.cgi", {
        "sum224": sum224.encode(), "strength": b"19", "bleed": b"2",
        "strip": b"0"})
    assert resp.status == 200


def test_static_pages_and_full_result_page(server, oracle, rose):
    # front page: the full form (file/url inputs + the three option groups)
    page = urllib.request.urlopen(f"{server}/", timeout=30).read().decode()
    for needle in ("compress.cgi", 'name="file"', 'name="url"',
                   'name="strength"', 'name="bleed"', 'name="strip"',
                   "example.html"):
        assert needle in page, needle
    assert urllib.request.urlopen(
        f"{server}/index.html", timeout=30).status == 200
    css = urllib.request.urlopen(
        f"{server}/style.css", timeout=30)
    assert css.headers["Content-Type"] == "text/css" and css.read()
    ex = urllib.request.urlopen(
        f"{server}/example.html", timeout=30).read().decode()
    assert "david.png" in ex and "david-s40.png" in ex

    # POST returns the FULL page: compress-again form with hidden sum224,
    # pre-filled options, size/percent line and the <img>
    resp = _post_multipart(f"{server}/compress.cgi", {
        "file": rose, "strength": b"19", "bleed": b"2", "strip": b"0"})
    page = resp.read().decode()
    for needle in ('name="sum224"', "Compress Again", "Start Over",
                   "compressed.cgi?sum224=", "% of original",
                   'width="70" height="46"'):
        assert needle in page, needle


def test_example_images_served(server, suite_dir):
    from pngloss_jax.webassets import format_size

    img = urllib.request.urlopen(f"{server}/david.png", timeout=30)
    assert img.read()[:8] == b"\x89PNG\r\n\x1a\n"
    img = urllib.request.urlopen(f"{server}/david-s20.png", timeout=300)
    data = img.read()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    assert len(data) < 18000   # README.md:97-100 — ~7kB at -s 20
    # Go size formatting (pnglossapi.go:273-301)
    assert format_size(9999) == "9999B"
    assert format_size(10000) == "10kB"
    assert format_size(12_345_678) == "12MB"


def test_post_rejects_out_of_range_params(server, rose):
    # bleed=0 would divide by zero in Sierra diffusion; strength>127 is
    # beyond what the reference site offers — both must 400 before
    # compression
    for fields in ({"strength": b"19", "bleed": b"0"},
                   {"strength": b"255", "bleed": b"2"},
                   {"strength": b"19", "bleed": b"2", "strip": b"7"}):
        with pytest.raises(urllib.error.HTTPError) as e:
            _post_multipart(f"{server}/compress.cgi",
                            {"file": rose, "strip": b"0", **fields})
        assert e.value.code == 400


def test_url_field_rejects_non_http_schemes(server):
    # file:// (or ftp/data) through the url field would read local files
    # and re-serve them; the reference's Go client.Get is http/https-only
    # (pnglossapi.go:189) and so are we
    for url in (b"file:///etc/passwd",
                b"ftp://127.0.0.1/rose.png",
                b"data:image/png;base64,AAAA"):
        with pytest.raises(urllib.error.HTTPError) as e:
            _post_multipart(f"{server}/compress.cgi", {
                "url": url, "strength": b"19", "bleed": b"2", "strip": b"0"})
        assert e.value.code == 400, url


def test_rejects_bad_inputs(server):
    with pytest.raises(urllib.error.HTTPError) as e:
        _post_multipart(f"{server}/compress.cgi", {
            "file": b"not a png", "strength": b"19", "bleed": b"2",
            "strip": b"0"})
    assert e.value.code == 400
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(f"{server}/compressed.cgi?sum224=xx", timeout=30)
    assert e.value.code == 400
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(f"{server}/nope", timeout=30)
    assert e.value.code == 404


def test_hostile_uploads_cannot_take_down_the_service(server, oracle, rose):
    """Round-3 verdict item 6: with the decoder hardening landed, a
    crafted upload that passes the 3000x3000 IHDR pre-check must produce
    a clean HTTP error (the reference isolates via exec.Command,
    pnglossapi.go:552-556; in-process is fine iff the codec provably
    cannot abort) — and the service must keep serving afterwards."""
    import os
    import struct
    import sys
    import zlib

    sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "tools"))
    from malformed import (base_palette, build, catalog, corrupt_crc,
                           make_ihdr, with_chunk_at)

    hostile = dict(catalog())
    # a sub-pre-check dimension lie: 2900x2900 declared, 64 bytes of data
    # (the same class that used to SIGABRT the whole process at 100000^2)
    cases = [
        build([(b"IHDR", make_ihdr(2900, 2900, 8, 6)),
               (b"IDAT", zlib.compress(b"\x00" * 64, 9)),
               (b"IEND", b"")]),
        hostile["trns_longer_than_palette"],
        hostile["idat_truncated_stream"],
        hostile["ihdr_duplicate"],
        hostile["scanline_filter_255"],
        corrupt_crc(base_palette(), b"PLTE"),
        with_chunk_at(base_palette(), 1, b"gAMA", struct.pack(">I", 10**9)),
    ]
    for i, png in enumerate(cases):
        try:
            resp = _post_multipart(f"{server}/compress.cgi", {
                "file": png, "strength": b"19", "bleed": b"2",
                "strip": b"0"})
            # some hostile cases are VALID per libpng (e.g. oversized tRNS
            # is discarded) — those must succeed, not 500
            assert resp.status == 200, f"case {i}"
        except urllib.error.HTTPError as e:
            # decode failures surface as the reference's 500 "compression
            # failed" (pnglossapi.go:396); pre-check failures as 4xx —
            # either way a clean HTTP error, never a dead worker
            assert 400 <= e.code <= 500, f"case {i}: {e.code}"

    # the service survived: a good upload still round-trips byte-identically
    resp = _post_multipart(f"{server}/compress.cgi", {
        "file": rose, "strength": b"40", "bleed": b"2", "strip": b"0"})
    assert resp.status == 200
    sum224 = base64.urlsafe_b64encode(hashlib.sha224(rose).digest()).decode()
    data = urllib.request.urlopen(
        f"{server}/compressed.cgi?sum224={sum224}&strength=40&bleed=2&strip=0",
        timeout=300).read()
    ref = subprocess.run([oracle, "-f", "-s", "40", "-b", "2", "-"],
                         input=rose, capture_output=True).stdout
    assert data == ref


def test_unix_socket_serving(tmp_path):
    """The reference sidecar serves on a unix socket behind a front server
    (pnglossapi.go:91-124); --socket provides the same deployment contract
    as HTTP-over-UDS (nginx proxy_pass http://unix:PATH;)."""
    import http.client
    import socket as socketlib

    from pngloss_jax.website import make_server

    path = str(tmp_path / "pngloss.sock")
    srv = make_server(store=str(tmp_path / "store"), unix_socket=path)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    try:
        class UDSConnection(http.client.HTTPConnection):
            def connect(self):
                self.sock = socketlib.socket(socketlib.AF_UNIX)
                self.sock.connect(path)

        conn = UDSConnection("unix")
        conn.request("GET", "/")
        resp = conn.getresponse()
        body = resp.read()
        assert resp.status == 200 and b"pngloss" in body
    finally:
        srv.shutdown()

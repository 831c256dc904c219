"""FastCGI transport: raw-record protocol tests against the responder
(pngloss_jax/fcgi.py), mirroring how a front server drives the reference
sidecar (website/pnglossapi.go:91-124, fcgi.Serve on a unix socket).
The client below speaks FCGI records from scratch — BEGIN_REQUEST,
PARAMS, STDIN — exactly as nginx's fastcgi_pass does (keep-alive off,
one request per connection)."""

import base64
import hashlib
import socket
import struct
import subprocess
import threading

import pytest

from pngloss_jax.fcgi import (
    FCGI_BEGIN_REQUEST,
    FCGI_END_REQUEST,
    FCGI_GET_VALUES,
    FCGI_GET_VALUES_RESULT,
    FCGI_PARAMS,
    FCGI_STDIN,
    FCGI_STDOUT,
    _pack_pairs,
    _pack_record,
)
from pngloss_jax.website import make_server


@pytest.fixture(scope="module")
def fcgi_sock(tmp_path_factory):
    store = tmp_path_factory.mktemp("store")
    path = str(tmp_path_factory.mktemp("sock") / "pngloss.sock")
    srv = make_server(store=str(store), unix_socket=path, fcgi=True)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    yield path
    srv.shutdown()


def _read_records(sock):
    """Collect (type, content) records until the peer closes."""
    buf = b""
    records = []
    while True:
        data = sock.recv(65536)
        if not data:
            break
        buf += data
        while len(buf) >= 8:
            _v, rtype, _rid, clen, plen = struct.unpack(">BBHHBx", buf[:8])
            if len(buf) < 8 + clen + plen:
                break
            records.append((rtype, buf[8:8 + clen]))
            buf = buf[8 + clen + plen:]
    return records


def fcgi_request(path, params, body=b""):
    """One full FCGI responder request over a fresh connection; returns
    (cgi_headers: dict, body: bytes, protocol_status: int)."""
    s = socket.socket(socket.AF_UNIX)
    s.settimeout(600)
    s.connect(path)
    s.sendall(_pack_record(FCGI_BEGIN_REQUEST, 1,
                           struct.pack(">HB5x", 1, 0)))   # RESPONDER, no KEEP
    s.sendall(_pack_record(FCGI_PARAMS, 1, _pack_pairs(params)))
    s.sendall(_pack_record(FCGI_PARAMS, 1, b""))
    for i in range(0, len(body), 32768):
        s.sendall(_pack_record(FCGI_STDIN, 1, body[i:i + 32768]))
    s.sendall(_pack_record(FCGI_STDIN, 1, b""))
    records = _read_records(s)
    s.close()
    stdout = b"".join(c for t, c in records if t == FCGI_STDOUT)
    ends = [c for t, c in records if t == FCGI_END_REQUEST]
    assert ends, "no END_REQUEST record"
    proto_status = ends[0][4]
    head, _, payload = stdout.partition(b"\r\n\r\n")
    headers = {}
    for line in head.split(b"\r\n"):
        k, _, v = line.partition(b": ")
        headers[k.decode().lower()] = v.decode()
    return headers, payload, proto_status


def _multipart(fields):
    boundary = "XfcgiboundaryX"
    body = b""
    for name, value in fields.items():
        body += (f"--{boundary}\r\n"
                 f'Content-Disposition: form-data; name="{name}"'
                 "\r\n\r\n").encode()
        body += value + b"\r\n"
    body += f"--{boundary}--\r\n".encode()
    return body, f"multipart/form-data; boundary={boundary}"


def test_front_page_over_fcgi(fcgi_sock):
    headers, body, status = fcgi_request(fcgi_sock, {
        "REQUEST_METHOD": "GET", "REQUEST_URI": "/index.html"})
    assert status == 0
    assert headers["status"].startswith("200")
    assert b"pngloss" in body


def test_compress_and_fetch_over_fcgi(fcgi_sock, oracle, suite_dir):
    rose = open(f"{suite_dir}/rose.png", "rb").read()
    body, ctype = _multipart({"file": rose, "strength": b"19",
                              "bleed": b"2", "strip": b"0"})
    headers, page, status = fcgi_request(fcgi_sock, {
        "REQUEST_METHOD": "POST", "REQUEST_URI": "/compress.cgi",
        "CONTENT_TYPE": ctype, "CONTENT_LENGTH": str(len(body)),
    }, body)
    assert status == 0 and headers["status"].startswith("200")
    assert b"compressed" in page

    sum224 = base64.urlsafe_b64encode(hashlib.sha224(rose).digest()).decode()
    headers, data, status = fcgi_request(fcgi_sock, {
        "REQUEST_METHOD": "GET",
        "REQUEST_URI": (f"/compressed.cgi?sum224={sum224}"
                        "&strength=19&bleed=2&strip=0")})
    assert status == 0 and headers["status"].startswith("200")
    assert headers["content-type"] == "image/png"
    ref = subprocess.run([oracle, "-f", "-s", "19", "-b", "2", "-"],
                         input=rose, capture_output=True).stdout
    assert data == ref     # bytes over FCGI identical to the C tool


def test_script_name_fallback_and_bad_query(fcgi_sock):
    # SCRIPT_NAME + QUERY_STRING route (no REQUEST_URI, spec-level CGI)
    headers, _body, status = fcgi_request(fcgi_sock, {
        "REQUEST_METHOD": "GET", "SCRIPT_NAME": "/compressed.cgi",
        "QUERY_STRING": "sum224=xx&strength=19&bleed=2&strip=0"})
    assert status == 0
    assert headers["status"].startswith("400")


def test_management_get_values(fcgi_sock):
    s = socket.socket(socket.AF_UNIX)
    s.settimeout(60)
    s.connect(fcgi_sock)
    asked = _pack_pairs({"FCGI_MPXS_CONNS": "", "FCGI_MAX_CONNS": ""})
    s.sendall(_pack_record(FCGI_GET_VALUES, 0, asked))
    buf = s.recv(65536)
    s.close()
    _v, rtype, rid, clen, _p = struct.unpack(">BBHHBx", buf[:8])
    assert rtype == FCGI_GET_VALUES_RESULT and rid == 0
    assert b"FCGI_MPXS_CONNS" in buf[8:8 + clen]
    assert b"0" in buf[8:8 + clen]


def test_non_responder_role_rejected(fcgi_sock):
    s = socket.socket(socket.AF_UNIX)
    s.settimeout(60)
    s.connect(fcgi_sock)
    # one burst: the server closes right after rejecting the role, so
    # separate sends could hit EPIPE before the remaining records land
    s.sendall(_pack_record(FCGI_BEGIN_REQUEST, 7,
                           struct.pack(">HB5x", 2, 0))     # AUTHORIZER
              + _pack_record(FCGI_PARAMS, 7, b"")
              + _pack_record(FCGI_STDIN, 7, b""))
    records = _read_records(s)
    s.close()
    ends = [c for t, c in records if t == FCGI_END_REQUEST]
    assert ends and ends[0][4] == 3    # FCGI_UNKNOWN_ROLE

"""volym_tpu_torch.devtools against the JAX package's Python path on the
synthetic NRRD of tests/test_devtools.py and variants of it: the same
segments, the same JSON text and the same payload bytes, through the
module and through the CLI's ``devtools`` subcommand."""

import json

import pytest

import volym_tpu.native as native
from test_devtools import HEADER
from volym_tpu import devtools as jdevtools
from volym_tpu_torch import cli, devtools

PAYLOAD = bytes(range(64))
NRRDS = {
    "lf": HEADER + PAYLOAD,
    # CRLF line ends: the payload starts after the first \r\n\r\n
    "crlf": HEADER.replace(b"\n", b"\r\n") + PAYLOAD,
    # no blank line: no payload
    "no_blank_line": HEADER.rstrip(b"\n") + b"\n",
    # a header line that is not UTF-8, and a segment without ID or label
    "odd_header": HEADER.replace(b"encoding: raw\n", b"encoding: raw\n\xff\xfe bytes\nSegment2_Name:=Bare\n")
    + PAYLOAD + b"\n\ntail",
}


@pytest.fixture(params=sorted(NRRDS))
def nrrd(request, tmp_path, monkeypatch):
    # the JAX package's Python path (its C++ splitter is not ported)
    monkeypatch.setattr(native, "available", lambda: False)
    path = tmp_path / f"{request.param}.seg.nrrd"
    path.write_bytes(NRRDS[request.param])
    return path


def test_parse_segments_equals_jax(nrrd):
    got = devtools.parse_segments(nrrd)
    assert got == jdevtools.parse_segments(nrrd)
    assert {s["name"] for s in got} >= {"Lobster", "Cup"}
    assert all(s["importance"] == 0 for s in got)


def test_split_payload_equals_jax(nrrd, tmp_path):
    n = devtools.split_payload(nrrd, tmp_path / "port.raw")
    assert n == jdevtools.split_payload(nrrd, tmp_path / "jax.raw")
    assert (tmp_path / "port.raw").read_bytes() == (tmp_path / "jax.raw").read_bytes()
    assert n == len((tmp_path / "port.raw").read_bytes())


def test_convert_equals_jax(nrrd, tmp_path):
    devtools.convert(nrrd, tmp_path / "port.json", tmp_path / "port.raw")
    jdevtools.convert(nrrd, tmp_path / "jax.json", tmp_path / "jax.raw")
    assert (tmp_path / "port.json").read_text() == (tmp_path / "jax.json").read_text()
    assert (tmp_path / "port.raw").read_bytes() == (tmp_path / "jax.raw").read_bytes()
    assert json.loads((tmp_path / "port.json").read_text()) == devtools.parse_segments(nrrd)


def test_cli_devtools_equals_jax(nrrd, tmp_path):
    assert cli.main(["devtools", str(nrrd), str(tmp_path / "port.json"), str(tmp_path / "port.raw")]) == 0
    assert devtools.main([str(nrrd), str(tmp_path / "main.json"), str(tmp_path / "main.raw")]) == 0
    jdevtools.convert(nrrd, tmp_path / "jax.json", tmp_path / "jax.raw")
    for out in ("port", "main"):
        assert (tmp_path / f"{out}.json").read_text() == (tmp_path / "jax.json").read_text()
        assert (tmp_path / f"{out}.raw").read_bytes() == (tmp_path / "jax.raw").read_bytes()

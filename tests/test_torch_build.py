"""The kernel library's build, without nvcc: the library's name follows the
bytes of every source and header in csrc/, and the build compiles each
source in its own nvcc process and links the objects once (checked with a
stand-in nvcc that records its arguments and writes its outputs)."""
import json
import os
import shutil
import stat
import sys

import pytest

from graphgp_tpu_torch.cuda_kernels import _build


@pytest.fixture
def csrc_copy(tmp_path, monkeypatch):
    copy = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, copy)
    monkeypatch.setattr(_build, "CSRC", str(copy))
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "_build"))
    return copy


def test_library_path_follows_headers_and_sources(csrc_copy):
    headers = sorted(p.name for p in csrc_copy.glob("*.cuh"))
    assert "bands.cuh" in headers
    assert [os.path.basename(p) for p in _build._sources()] == sorted(
        p.name for p in csrc_copy.glob("*.cu"))  # headers are hashed, not compiled
    before = _build.library_path()
    header = csrc_copy / "bands.cuh"
    text = header.read_bytes()
    header.write_bytes(text + b"\n")
    edited = _build.library_path()
    assert edited != before
    header.write_bytes(text)
    assert _build.library_path() == before
    source = csrc_copy / "gram.cu"
    source.write_bytes(source.read_bytes() + b"\n")
    assert _build.library_path() not in (before, edited)


def _fake_nvcc(tmp_path, fail_on=None):
    """An nvcc stand-in: appends its argv to calls.jsonl, prints a ptxas-like
    line, writes its -o file, and fails for a source named ``fail_on``."""
    log = tmp_path / "calls.jsonl"
    script = tmp_path / "nvcc"
    script.write_text(
        f"#!{sys.executable}\n"
        "import json, sys\n"
        f"open({str(log)!r}, 'a').write(json.dumps(sys.argv[1:]) + '\\n')\n"
        f"if any(a.endswith({fail_on!r}) for a in sys.argv if {fail_on!r}):\n"
        "    print('error: stand-in failure'); sys.exit(1)\n"
        "print('ptxas info    : Used 32 registers')\n"
        "open(sys.argv[sys.argv.index('-o') + 1], 'w').write('built')\n"
    )
    script.chmod(script.stat().st_mode | stat.S_IEXEC)
    return str(script), log


def test_build_compiles_each_source_apart_then_links_once(csrc_copy, tmp_path, monkeypatch):
    nvcc, log = _fake_nvcc(tmp_path)
    monkeypatch.setattr(_build, "_nvcc", lambda: nvcc)
    path = _build.library_path()
    out = _build._compile(path)
    calls = [json.loads(line) for line in log.read_text().splitlines()]
    sources = _build._sources()
    compiles, link = calls[:-1], calls[-1]  # the compiles log in the order they ran
    assert len(sources) == 4
    assert sorted(cmd[-1] for cmd in compiles) == sources
    for cmd in compiles:
        assert "-c" in cmd and "-shared" not in cmd
        assert "arch=compute_90a,code=sm_90a" in cmd and "-fPIC" in cmd
    objects = [cmd[cmd.index("-o") + 1] for cmd in compiles]
    assert "-shared" in link and sorted(link[-len(objects):]) == sorted(objects)
    assert open(path).read() == "built"
    assert out.count("Used 32 registers") == 5
    assert sorted(os.listdir(os.path.dirname(path))) == [os.path.basename(path)]  # no objects left


def test_build_failure_names_the_source_and_leaves_nothing(csrc_copy, tmp_path, monkeypatch):
    nvcc, log = _fake_nvcc(tmp_path, fail_on="gram.cu")
    monkeypatch.setattr(_build, "_nvcc", lambda: nvcc)
    path = _build.library_path()
    with pytest.raises(RuntimeError, match="gram.cu"):
        _build._compile(path)
    assert len(log.read_text().splitlines()) == 4  # every source compiled, no link
    assert os.listdir(os.path.dirname(path)) == []

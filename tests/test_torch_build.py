"""The port's native build (``kernels/build.py``), with g++ on a probe
source: a failed compile raises and leaves no library behind (there is
no fallback), and a library older than one of its sources is rebuilt."""

import os

import pytest

from datok_tpu_torch.kernels import build


def _spec(tmp_path, monkeypatch, body):
    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path / "_build"))
    monkeypatch.setattr(build, "_loaded", {})
    src = tmp_path / "probe.cpp"
    src.write_text(body)
    return build.Lib("probe", (str(src),), (("dt_probe", ()),), False)


def test_failed_build_raises(tmp_path, monkeypatch):
    spec = _spec(tmp_path, monkeypatch, 'extern "C" int dt_probe( {')
    with pytest.raises(RuntimeError, match="build of libdt_probe.so failed"):
        build.load(spec)
    assert not os.path.exists(spec.path)
    assert "probe" not in build._loaded


def test_stale_library_is_rebuilt(tmp_path, monkeypatch):
    spec = _spec(tmp_path, monkeypatch,
                 'extern "C" int dt_probe() { return 7; }')
    assert build._stale(spec.path, spec.sources)
    assert build.load(spec).dt_probe() == 7
    assert not build._stale(spec.path, spec.sources)
    # a library older than its source is stale, and build() renews it
    t = os.path.getmtime(spec.sources[0]) - 10
    os.utime(spec.path, (t, t))
    assert build._stale(spec.path, spec.sources)
    build.build(spec)
    assert not build._stale(spec.path, spec.sources)

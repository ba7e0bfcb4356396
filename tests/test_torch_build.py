"""Control flow of the port's kernel build (ops/cuda/build.py), on the CPU
with a stand-in compiler: a library is built once per source content, a
changed source is rebuilt, and a failing compile raises with its log."""

import os
import stat

import pytest

from pytorch_ddp_resnet_tpu_torch.ops.cuda import build

FAKE_NVCC = """#!/bin/sh
echo "$@" >> "{calls}"
out=""
for arg in "$@"; do src="$arg"; done
while [ $# -gt 0 ]; do
  if [ "$1" = "-o" ]; then out="$2"; fi
  shift
done
if grep -q BROKEN "$src"; then
  echo "error: broken source"; exit 1
fi
echo "ptxas info    : Used 42 registers"
touch "$out"
"""


@pytest.fixture
def fake_build(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "k.cu").write_text("// kernel v1\n")
    calls = tmp_path / "calls.txt"
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(FAKE_NVCC.format(calls=calls))
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setattr(build, "CSRC_DIR", str(csrc))
    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path / "_build"))
    monkeypatch.setattr(build, "nvcc_path", lambda: str(nvcc))
    return csrc, calls


def _n_calls(calls):
    return len(calls.read_text().splitlines()) if calls.exists() else 0


def test_builds_once_per_source_content(fake_build):
    csrc, calls = fake_build
    path = build.build_all()["k"]
    assert os.path.exists(path) and _n_calls(calls) == 1
    assert "sm_90a" in calls.read_text()
    assert "Used 42 registers" in build.build_log("k")
    assert build.build_all()["k"] == path and _n_calls(calls) == 1
    (csrc / "k.cu").write_text("// kernel v2\n")
    new = build.build_all()["k"]
    assert new != path and os.path.exists(new) and _n_calls(calls) == 2


def test_failed_compile_raises_with_its_log(fake_build):
    csrc, _ = fake_build
    (csrc / "k.cu").write_text("BROKEN\n")
    with pytest.raises(RuntimeError, match="broken source"):
        build.build_all(["k"])
    assert not os.path.exists(build.library_path("k"))


def test_a_changed_header_rebuilds(fake_build):
    csrc, calls = fake_build
    (csrc / "shared.cuh").write_text("// header v1\n")
    path = build.build_all()["k"]
    (csrc / "shared.cuh").write_text("// header v2\n")
    new = build.build_all()["k"]
    assert new != path and os.path.exists(new) and _n_calls(calls) == 2

"""The kernel library's build (pg_embedding_tpu_torch/_kernels._build) on
the CPU, with a stand-in for nvcc that records how it was called: it
takes the package's flags alone, whatever nvcc's flag variables in the
caller's environment say."""

import os
import stat

import pytest

from pg_embedding_tpu_torch import _kernels

FAKE_NVCC = """#!/bin/sh
# records its arguments and its environment, then writes the file after -o
log="$(dirname "$0")/calls"
echo "ARGS $*" >> "$log"
env | grep '^NVCC_' | sed 's/^/ENV /' >> "$log"
out=""
prev=""
for a in "$@"; do
  [ "$prev" = "-o" ] && out="$a"
  prev="$a"
done
: > "$out"
"""


@pytest.mark.parametrize("var", _kernels.NVCC_ENV_FLAGS)
def test_build_leaves_out_nvcc_flag_variables(tmp_path, monkeypatch, var):
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(FAKE_NVCC)
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IXUSR)
    monkeypatch.setattr(_kernels, "_nvcc", lambda: str(nvcc))
    monkeypatch.setenv(var, "-lineinfo")
    monkeypatch.setenv("NVCC_KEPT", "1")
    srcs = [str(tmp_path / "a.cu"), str(tmp_path / "b.cu")]
    work = tmp_path / "work"
    work.mkdir()
    lib = str(tmp_path / "lib.so")
    _kernels._build(srcs, str(work), lib)
    calls = (tmp_path / "calls").read_text().splitlines()
    args = [c[len("ARGS "):].split() for c in calls if c.startswith("ARGS ")]
    env = [c for c in calls if c.startswith("ENV ")]
    # two compiles (side by side: in either order) and a link, with the
    # package's flags and no other
    assert len(args) == 3
    assert sorted(args[:2]) == [
        [*_kernels._NVCC_FLAGS, "-c", "-o",
         os.path.join(str(work), os.path.basename(s) + ".o"), s]
        for s in srcs]
    assert args[2][:3] == [*_kernels._NVCC_FLAGS[:2], "-shared"]
    # the flag variable is gone from every call, other variables stay
    assert env == ["ENV NVCC_KEPT=1"] * 3
    assert os.path.exists(lib) and os.path.exists(lib + ".log")
    assert var in os.environ and var not in _kernels.nvcc_env()

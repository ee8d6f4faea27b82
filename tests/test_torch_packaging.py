"""What an installed copy of the port needs to build its kernels: every
kernel source of ``arkflow_tpu_torch/csrc`` and every file one of them
includes is matched by a package-data glob of ``pyproject.toml``, so a wheel
or a non-editable install ships it beside the package."""

import re
import tomllib
from fnmatch import fnmatch
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
PACKAGE = ROOT / "arkflow_tpu_torch"
CSRC = PACKAGE / "csrc"
SOURCES = sorted([*CSRC.glob("*.cu"), *CSRC.glob("*.cuh")])


def _package_data() -> list[str]:
    with open(ROOT / "pyproject.toml", "rb") as f:
        return tomllib.load(f)["tool"]["setuptools"]["package-data"]["arkflow_tpu_torch"]


def _shipped(path: Path) -> bool:
    rel = path.relative_to(PACKAGE).as_posix()
    return any(fnmatch(rel, glob) for glob in _package_data())


def test_the_kernel_sources_exist():
    assert {p.suffix for p in SOURCES} == {".cu", ".cuh"}


@pytest.mark.parametrize("source", SOURCES, ids=lambda p: p.name)
def test_every_source_and_its_includes_are_package_data(source):
    assert _shipped(source), f"{source.name} is not package data"
    for name in re.findall(r'^\s*#include\s+"([^"]+)"', source.read_text(), re.MULTILINE):
        included = (source.parent / name).resolve()
        assert included.is_file(), f"{source.name} includes {name}, which does not exist"
        assert _shipped(included), f"{source.name} includes {name}, which is not package data"

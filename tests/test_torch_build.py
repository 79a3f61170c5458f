"""The kernel library's registry (``claxon_tpu_torch/ops/_build.py``)
against the CUDA sources it builds: every ``csrc/*.cu`` file is compiled,
every C entry point a source defines is bound, no entry point is defined
twice, and every bound name is defined. Reads the sources; needs no
``nvcc``."""

import pathlib
import re

import pytest

from claxon_tpu_torch.ops import _build

CSRC = pathlib.Path(_build.__file__).resolve().parent.parent / "csrc"
SOURCES = sorted(p.name for p in CSRC.glob("*.cu"))
#: a C entry point's definition: extern "C" <return type> cxk_<name>(
ENTRY = re.compile(r'extern\s+"C"\s+[\w\s*]+?\b(cxk_\w+)\s*\(')


def _entries(name):
    return ENTRY.findall((CSRC / name).read_text())


@pytest.mark.parametrize("name", SOURCES)
def test_source_is_built_and_bound(name):
    assert name in _build._SOURCES
    entries = _entries(name)
    assert entries, f"{name} defines no entry point"
    elsewhere = {e for other in SOURCES if other != name
                 for e in _entries(other)}
    assert len(entries) == len(set(entries)), f"{name} repeats an entry"
    assert not set(entries) & elsewhere, "an entry point defined twice"
    unbound = set(entries) - set(_build._SIGNATURES)
    assert not unbound, f"{name}: not in _SIGNATURES: {sorted(unbound)}"


def test_every_signature_and_source_exists():
    defined = {e for name in SOURCES for e in _entries(name)}
    missing = set(_build._SIGNATURES) - defined
    assert not missing, f"bound but defined nowhere: {sorted(missing)}"
    assert sorted(_build._SOURCES) == SOURCES
    assert set(_build._VALUED) <= set(_build._SIGNATURES)
    for header in _build._HEADERS:
        assert (CSRC / header).is_file()

"""The kernel build cache (dynamicpdb_tpu_torch/ops/_build.py): a library's
path is a digest of its source and of every csrc/ header the source
includes, so an edit to a shared header rebuilds every library that uses
it. Runs on a temporary copy of csrc/; nothing is compiled and nothing is
written into the repository."""
import os
import shutil

import pytest

from dynamicpdb_tpu_torch.ops import _build

SOURCES = ("geom_attention", "ipa_attention_fwd", "ipa_attention_bwd")


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    copy = tmp_path / "csrc"
    shutil.copytree(_build.CSRC_DIR, copy)
    monkeypatch.setattr(_build, "CSRC_DIR", str(copy))
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "build"))
    return copy


def _append(path, text="\n// edited\n"):
    with open(path, "a") as f:
        f.write(text)


@pytest.mark.parametrize("name", SOURCES)
def test_shared_header_edit_changes_library_path(csrc, name):
    """tf32_mma.cuh reaches every source, the IPA ones through
    ipa_tile.cuh: an edit to it moves all three libraries."""
    assert "tf32_mma.cuh" in _build.sources(name)
    before = _build.library_path(name)
    _append(csrc / "tf32_mma.cuh")
    assert _build.library_path(name) != before


@pytest.mark.parametrize("name", SOURCES)
def test_ipa_header_edit_moves_only_its_users(csrc, name):
    before = _build.library_path(name)
    _append(csrc / "ipa_tile.cuh")
    moved = _build.library_path(name) != before
    assert moved == name.startswith("ipa_"), (name, _build.sources(name))


def test_unincluded_header_and_source_edits(csrc):
    paths = {n: _build.library_path(n) for n in SOURCES}
    (csrc / "unused.cuh").write_text("// not included anywhere\n")
    assert {n: _build.library_path(n) for n in SOURCES} == paths
    _append(csrc / "ipa_attention_fwd.cu")
    now = {n: _build.library_path(n) for n in SOURCES}
    assert now["ipa_attention_fwd"] != paths["ipa_attention_fwd"]
    assert {n: now[n] for n in SOURCES if n != "ipa_attention_fwd"} == {
        n: paths[n] for n in SOURCES if n != "ipa_attention_fwd"}
    assert not os.path.exists(_build.BUILD_DIR)

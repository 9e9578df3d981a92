"""Torch port: the kernels' build cache (kernels.py) on the CPU.

A library is named by the hash of its source and of every header under
csrc/, so editing a shared header rebuilds every kernel; nothing here
runs nvcc."""

import os
import shutil

import pytest

from explicit_hybrid_mpc_tpu_torch import kernels


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    d = tmp_path / "csrc"
    shutil.copytree(kernels.CSRC, d)
    monkeypatch.setattr(kernels, "CSRC", str(d))
    return d


def test_every_source_is_there_and_the_shared_header_too():
    for src in kernels.SOURCES.values():
        assert os.path.isfile(os.path.join(kernels.CSRC, src))
    assert os.path.isfile(os.path.join(kernels.CSRC, "leaf_score.cuh"))


@pytest.mark.parametrize("name", sorted(kernels.SOURCES))
def test_library_path_follows_the_source_and_every_header(csrc, name,
                                                          monkeypatch):
    def no_nvcc(*a, **k):
        raise AssertionError("nvcc ran")
    monkeypatch.setattr(kernels.subprocess, "Popen", no_nvcc)
    before = kernels._lib_path(name)
    assert before == kernels._lib_path(name)
    assert os.path.dirname(before) == kernels.BUILD_DIR
    header = csrc / "leaf_score.cuh"
    header.write_text(header.read_text() + "\n// touched\n")
    touched = kernels._lib_path(name)
    assert touched != before
    (csrc / "new_helper.cuh").write_text("#pragma once\n")
    assert kernels._lib_path(name) != touched
    src = csrc / kernels.SOURCES[name]
    src.write_text(src.read_text() + "\n")
    assert kernels._lib_path(name) not in (before, touched)


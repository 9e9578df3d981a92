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


def test_concurrent_builds_compile_each_library_once(tmp_path, monkeypatch):
    """Two builds started together (two processes on one checkout, here
    two threads: the lock is per open file) compile a missing library
    once; the second waits on BUILD_DIR/.lock and loads the first's."""
    import threading

    calls = tmp_path / "calls"
    fake = tmp_path / "nvcc"
    fake.write_text("#!/bin/sh\necho x >> " + str(calls) + "\nsleep 0.3\n"
                    "while [ \"$1\" != -o ]; do shift; done\ntouch \"$2\"\n")
    fake.chmod(0o755)
    monkeypatch.setattr(kernels, "BUILD_DIR", str(tmp_path / "kernels"))
    monkeypatch.setattr(kernels, "_nvcc", lambda: str(fake))
    out = []
    threads = [threading.Thread(target=lambda: out.append(
        kernels.build(["locate"]))) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(30)
    assert len(calls.read_text().split()) == 1
    assert sorted(len(o) for o in out) == [0, 1]
    assert os.path.exists(kernels._lib_path("locate"))
    # Present libraries need no compiler at all.
    monkeypatch.setattr(kernels, "_nvcc", lambda: 1 / 0)
    assert kernels.build(["locate"]) == {}



def test_ipm_leg_paths_take_every_shape_up_to_the_ceiling():
    """Past the warp paths (nz 32, nc 128) the large path takes every
    shape up to its ceiling, 8 rows of 32 a lane of its factor's warp
    (nz <= 256) and 227 KB of shared memory a block (two chunks of 32
    rows of A beside the factor: nz <= 151 at nc 366 in float64); the
    source declares the constants the wrapper holds, and the wrapper
    refuses past the ceiling before it looks at the device."""
    import torch

    from explicit_hybrid_mpc_tpu_torch.oracle import ipm_leg

    for nz, nc in ((5, 35), (32, 128), (33, 129), (8, 200), (60, 360),
                   (65, 365), (65, 366)):
        for itemsize in (4, 8):
            assert ipm_leg.kernel_takes(nz, nc, itemsize), (nz, nc)
    assert ipm_leg.large_smem_bytes(65, 366, 8) == 98_618
    # Two QPs an SM at the quadrotor's largest shape (228 KB an SM, 1 KB
    # of it reserved a block).
    assert 2 * (ipm_leg.large_smem_bytes(65, 366, 8) + 1024) <= 233_472
    assert max(n for n in range(1, 300)
               if ipm_leg.kernel_takes(n, 366, 8)) == 151
    assert not ipm_leg.kernel_takes(152, 366, 8)
    assert ipm_leg.kernel_takes(256, 10, 4)
    assert not ipm_leg.kernel_takes(257, 10, 4)
    with open(os.path.join(kernels.CSRC, "ipm_leg.cu")) as f:
        src = f.read()
    for decl in (f"kMaxNz = {ipm_leg.GENERAL_MAX_NZ};",
                 f"kMaxNc = {ipm_leg.GENERAL_MAX_NC};",
                 f"kLargeThreads = {ipm_leg.LARGE_THREADS};",
                 f"kLargeRows = {ipm_leg.LARGE_ROWS};",
                 f"kTile = {ipm_leg.LARGE_TILE};",
                 f"kMaxSmem = {ipm_leg.MAX_SMEM_BYTES};"):
        assert decl in src, decl

    def qps(nz, nc):
        return (torch.zeros(1, nz, nz), torch.zeros(1, nz),
                torch.zeros(1, nc, nz), torch.zeros(1, nc),
                torch.zeros(1, nz), torch.ones(1, nc), torch.ones(1, nc))
    with pytest.raises(ValueError, match="ceiling"):
        ipm_leg.ipm_leg_cuda(*qps(257, 10), n_iter=2)
    with pytest.raises(ValueError, match="CUDA device"):
        ipm_leg.ipm_leg_cuda(*qps(65, 366), n_iter=2)


def test_ipm_leg_general_path_limits_agree_with_the_source():
    """The general path (8 < nz <= 32, nc <= 128): the source declares
    the buckets and tile edges the wrapper holds (GENERAL_BUCKETS), each
    bucket's tiles fit one warp, its shared memory a QP is the wrapper's
    general_smem_bytes (A staged in rows of a stride 4 mod 16, Q and C,
    four nz- and three nc-vectors) and stays far inside a block's, and
    kernel_takes accepts every shape of the path."""
    import re

    from explicit_hybrid_mpc_tpu_torch.oracle import ipm_leg

    with open(os.path.join(kernels.CSRC, "ipm_leg.cu")) as f:
        src = f.read()
    decl = {int(b): (int(t), int(lo)) for b, t, lo in re.findall(
        r"struct MidShape<(\d+)> \{\s*static constexpr int T = (\d+), "
        r"LO = (\d+);", src)}
    assert {b: t for b, (t, _lo) in decl.items()} == ipm_leg.GENERAL_BUCKETS
    buckets = sorted(decl)
    assert buckets[-1] == ipm_leg.GENERAL_MAX_NZ
    # Each bucket's smallest nz is one past the bucket below (the
    # register path's 8 below the first): the columns below it are live.
    assert [decl[b][1] for b in buckets] == [
        9] + [b + 1 for b in buckets[:-1]]
    for b, (t, _lo) in decl.items():
        nb = -(-b // t)
        assert nb * (nb + 1) // 2 <= 32
    for nz in range(9, ipm_leg.GENERAL_MAX_NZ + 1):
        for nc in (1, 14, 96, ipm_leg.GENERAL_MAX_NC):
            assert ipm_leg.kernel_takes(nz, nc, 8)
            assert ipm_leg.general_smem_bytes(nz, nc, 8) < 64 * 1024
    assert ipm_leg.general_smem_bytes(24, 96, 8) == 40_320
    assert ipm_leg.general_smem_bytes(32, 128, 8) == 57_856
    assert ipm_leg.general_smem_bytes(17, 14, 4) == 2 * ipm_leg \
        .general_smem_bytes(17, 14, 2)
    assert "ipm_leg_general(" not in src and "kkt_step" not in src

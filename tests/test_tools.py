"""Smoke coverage for the tools/ harnesses (CPU, tiny scales)."""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
ENV = {"PYTHONPATH": str(REPO), "PATH": "/usr/bin:/bin",
       "JAX_PLATFORMS": "cpu", "HOME": "/root"}


@pytest.mark.slow
def test_scale_test_runs_without_reference(tmp_path):
    r = subprocess.run(
        [sys.executable, str(REPO / "tools/scale_test.py"),
         "--genome", "30000", "--reads", "6", "--read-len", "2000",
         "--error", "0.05", "--workdir", str(tmp_path),
         "--batch-size", "32"],
        capture_output=True, text=True, env=ENV, cwd=tmp_path)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "skipping differential" in r.stdout
    assert (tmp_path / "ours.darwin").exists()


@pytest.mark.slow
def test_profile_pipeline_runs(data_dir, tmp_path):
    d = data_dir / "tiny"
    r = subprocess.run(
        [sys.executable, str(REPO / "tools/profile.py"), "pipeline",
         str(d / "reads.fasta"), str(d / "reads.fasta"),
         "--params", str(d / "params.cfg"), "--batch-size", "32"],
        capture_output=True, text=True, env=ENV, cwd=tmp_path)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "reads/s" in r.stdout


def test_mem_usage_device_mode(tmp_path):
    r = subprocess.run(
        [sys.executable, str(REPO / "tools/mem_usage.py"), "device"],
        capture_output=True, text=True, env=ENV, cwd=tmp_path)
    assert r.returncode == 0, r.stderr[-2000:]


@pytest.mark.slow
def test_bigcoord_dryrun_smoke_both_engines(tmp_path):
    """Tiny-scale run of the >2^31 coordinate dry-run tool on both the
    host batch engine and the whole-loop device engine (lax backend on
    the CPU; the same script with the CUDA kernel is the manual >2^31
    run on a GPU)."""
    for engine in ("host", "device"):
        r = subprocess.run(
            [sys.executable, str(REPO / "tools/bigcoord_dryrun.py"),
             "--gb", "0.002", "--pieces", "2", "--reads", "2",
             "--read-len", "3000", "--engine", engine,
             "--backend", "lax", "--cpu"],
            capture_output=True, text=True, env=ENV, cwd=tmp_path)
        assert r.returncode == 0, (engine, r.stderr[-2000:])
        assert "BIGCOORD DRYRUN OK" in r.stdout, (engine, r.stdout)


@pytest.mark.slow
def test_fuzz_soak_smoke(tmp_path):
    """One fresh de-novo instance through the soak driver (the real
    soaks run hundreds per round; their tallies live in
    docs/DESIGN.md)."""
    r = subprocess.run(
        [sys.executable, str(REPO / "tools/fuzz_soak.py"),
         "12345", "1"],
        capture_output=True, text=True, env=ENV, cwd=tmp_path)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "SOAK OK: 1 instances exact" in r.stdout, r.stdout

"""Backend choice by platform, the no-fallback rule, the compile cache,
and the chip check's refusal to run without a GPU."""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import pytest

from darwin_tpu.engine import aligner
from darwin_tpu.ops import cuda_dp

REPO = Path(__file__).resolve().parent.parent


@pytest.mark.parametrize("platform,backend", [("gpu", "cuda"),
                                              ("cpu", "lax")])
def test_backend_for_platform(platform, backend):
    assert aligner.backend_for(platform) == backend


@pytest.mark.parametrize("platform", ["rocm", "METAL", "neuron"])
def test_backend_for_other_platforms_raises(platform):
    with pytest.raises(RuntimeError, match="no tile-DP backend"):
        aligner.backend_for(platform)


def test_resolve_backend_auto_on_cpu_is_lax():
    assert aligner.resolve_backend("auto") == "lax"
    with pytest.raises(ValueError, match="unknown"):
        aligner.resolve_backend("pallas")


def _broken_build(monkeypatch, tmp_path):
    monkeypatch.setattr(cuda_dp, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(cuda_dp, "_lib", None)
    monkeypatch.setenv("NVCC", str(tmp_path / "no-such-nvcc"))
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")


def test_gpu_kernel_build_failure_raises(monkeypatch, tmp_path):
    """On a GPU, "auto" means the CUDA kernel; if it cannot be built
    the run stops instead of dropping to lax."""
    _broken_build(monkeypatch, tmp_path)
    with pytest.raises(RuntimeError, match="build failed"):
        aligner.resolve_backend("auto")


def test_engines_raise_without_kernel_on_gpu(monkeypatch, tmp_path):
    from darwin_tpu.engine.device_batch import DeviceGactEngine
    from darwin_tpu.engine.seqbank import SeqBank
    from darwin_tpu.index.genome import Genome
    from darwin_tpu.io.fasta import FastaRecord

    _broken_build(monkeypatch, tmp_path)
    genome = Genome([FastaRecord(["g"], "ACGT" * 64)], 64)
    bank = SeqBank([genome.concat[:100].copy()])
    kw = dict(tile_size=64, early_terminate=40, match=1, mismatch=-1,
              gap_open=-1, gap_extend=-1)
    with pytest.raises(RuntimeError, match="build failed"):
        DeviceGactEngine(genome, bank, first_tile_score_threshold=10,
                         same_file=False, **kw)
    with pytest.raises(RuntimeError, match="build failed"):
        aligner.JaxTileAligner(**kw)


def test_cuda_backend_needs_packed6(monkeypatch):
    from darwin_tpu.engine.device_batch import DeviceGactEngine
    from darwin_tpu.engine.seqbank import SeqBank
    from darwin_tpu.index.genome import Genome
    from darwin_tpu.io.fasta import FastaRecord

    monkeypatch.setattr(cuda_dp, "load", lambda: None)
    genome = Genome([FastaRecord(["g"], "ACGT" * 64)], 64)
    with pytest.raises(ValueError, match="packed6"):
        DeviceGactEngine(genome, SeqBank([genome.concat[:64].copy()]),
                         tile_size=64, early_terminate=40,
                         first_tile_score_threshold=10, match=1,
                         mismatch=-1, gap_open=-1, gap_extend=-1,
                         same_file=False, backend="cuda",
                         tb_format="packed")


@pytest.fixture
def restore_cache_dir():
    before = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", before)


def test_compile_cache_env_set(monkeypatch, tmp_path, restore_cache_dir):
    from darwin_tpu.utils import configure_compile_cache

    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert configure_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before  # untouched


def test_compile_cache_env_unset(monkeypatch, restore_cache_dir):
    from darwin_tpu.utils import configure_compile_cache

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    want = str(REPO / ".jax_cache")
    assert configure_compile_cache() == want
    assert jax.config.jax_compilation_cache_dir == want


def _run_smoke(script: Path, cwd: Path):
    env = {"PATH": os.environ.get("PATH", "/usr/bin:/bin"),
           "JAX_PLATFORMS": "cpu", "HOME": str(cwd)}
    r = subprocess.run([sys.executable, str(script)], capture_output=True,
                       text=True, env=env, cwd=cwd, timeout=300)
    return r.returncode, r.stdout.strip().splitlines()


def test_chip_smoke_refuses_cpu(tmp_path):
    rc, lines = _run_smoke(REPO / "chip_smoke.py", tmp_path)
    assert rc != 0
    last = json.loads(lines[-1])
    assert last["ok"] is False and "no GPU" in last["error"]
    assert len(lines) == 1  # no result printed


def test_chip_smoke_alone_fails(tmp_path):
    """Copied into a directory without the repository, the script
    fails too (here at the GPU check, first)."""
    script = tmp_path / "chip_smoke.py"
    script.write_text((REPO / "chip_smoke.py").read_text())
    rc, lines = _run_smoke(script, tmp_path)
    assert rc != 0 and json.loads(lines[-1])["ok"] is False

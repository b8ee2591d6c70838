"""CLI differential test: reference-style invocation, merged output
equals the reference binary's sorted-unique records."""

import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent


@pytest.mark.slow
def test_cli_matches_reference(data_dir, tmp_path):
    d = data_dir / "tiny"
    cmd = [sys.executable, "-m", "darwin_tpu.cli",
           str(d / "reads.fasta"), str(d / "reads.fasta"), "2",
           "--params", str(d / "params.cfg"),
           "--batch-size", "64",
           "--out-dir", str(tmp_path),
           "--merged-out", str(tmp_path / "out.darwin")]
    env = {"PYTHONPATH": str(REPO), "PATH": "/usr/bin:/bin",
           "JAX_PLATFORMS": "cpu", "HOME": "/root"}
    r = subprocess.run(cmd, capture_output=True, text=True, env=env,
                       cwd=tmp_path)
    assert r.returncode == 0, r.stderr[-2000:]
    assert (tmp_path / "darwin.0.out").exists()
    assert (tmp_path / "darwin.1.out").exists()
    got = (tmp_path / "out.darwin").read_text().splitlines()
    want = sorted(set((d / "out.darwin").read_text().splitlines()))
    assert got == want


@pytest.mark.slow
def test_cli_resume_and_metrics(data_dir, tmp_path):
    d = data_dir / "tiny"
    env = {"PYTHONPATH": str(REPO), "PATH": "/usr/bin:/bin",
           "JAX_PLATFORMS": "cpu", "HOME": "/root"}
    base = [sys.executable, "-m", "darwin_tpu.cli",
            str(d / "reads.fasta"), str(d / "reads.fasta"), "2",
            "--params", str(d / "params.cfg"), "--batch-size", "64",
            "--out-dir", str(tmp_path),
            "--merged-out", str(tmp_path / "out.darwin"),
            "--metrics-json", str(tmp_path / "metrics.json")]
    r = subprocess.run(base, capture_output=True, text=True, env=env,
                       cwd=tmp_path)
    assert r.returncode == 0, r.stderr[-2000:]
    import json
    m = json.loads((tmp_path / "metrics.json").read_text())
    assert m["num_reads"] > 0 and m["num_records"] > 0
    assert m["gact_ms"] > 0 and m["reads_per_s"] > 0

    # Resume: poison range 0's output; --resume must keep it verbatim
    # and only the merged file reflects the poisoned content.
    (tmp_path / "darwin.0.out").write_text("POISON\n")
    r = subprocess.run(base + ["--resume"], capture_output=True,
                       text=True, env=env, cwd=tmp_path)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "resumed" in r.stdout
    assert (tmp_path / "darwin.0.out").read_text() == "POISON\n"
    merged = (tmp_path / "out.darwin").read_text().splitlines()
    assert "POISON" in merged


@pytest.mark.slow
def test_cli_chunked_streaming_matches_unchunked(data_dir, tmp_path):
    """--chunk-reads must produce the same merged record set as the
    in-memory run (guided fixture: reads vs separate reference)."""
    d = data_dir / "guided"
    env = {"PYTHONPATH": str(REPO), "PATH": "/usr/bin:/bin",
           "JAX_PLATFORMS": "cpu", "HOME": "/root"}

    def run(extra, out):
        cmd = [sys.executable, "-m", "darwin_tpu.cli",
               str(d / "ref.fasta"), str(d / "reads.fasta"),
               "--params", str(d / "params.cfg"), "--batch-size", "64",
               "--out-dir", str(tmp_path / out),
               "--merged-out", str(tmp_path / f"{out}.darwin")] + extra
        r = subprocess.run(cmd, capture_output=True, text=True,
                           env=env, cwd=tmp_path)
        assert r.returncode == 0, r.stderr[-2000:]
        return (tmp_path / f"{out}.darwin").read_text().splitlines()

    whole = run([], "whole")
    chunked = run(["--chunk-reads", "5"], "chunk")
    assert chunked == whole
    assert (tmp_path / "chunk" / "darwin.3.out").exists()  # 18 reads/5
    want = sorted(set((d / "out.darwin").read_text().splitlines()))
    assert chunked == want


@pytest.mark.slow
def test_cli_paf_resume_sidecar(data_dir, tmp_path):
    """--paf-out + --resume: resumed ranges reload their per-range PAF
    sidecar, so the merged PAF stays complete across restarts."""
    d = data_dir / "tiny"
    env = {"PYTHONPATH": str(REPO), "PATH": "/usr/bin:/bin",
           "JAX_PLATFORMS": "cpu", "HOME": "/root"}
    base = [sys.executable, "-m", "darwin_tpu.cli",
            str(d / "reads.fasta"), str(d / "reads.fasta"), "2",
            "--params", str(d / "params.cfg"), "--batch-size", "64",
            "--out-dir", str(tmp_path),
            "--paf-out", str(tmp_path / "out.paf")]
    r = subprocess.run(base, capture_output=True, text=True, env=env,
                       cwd=tmp_path)
    assert r.returncode == 0, r.stderr[-2000:]
    assert (tmp_path / "darwin.0.paf").exists()
    first = (tmp_path / "out.paf").read_text()
    assert first

    r = subprocess.run(base + ["--resume"], capture_output=True,
                       text=True, env=env, cwd=tmp_path)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "resumed" in r.stdout
    assert (tmp_path / "out.paf").read_text() == first

    # A missing sidecar must warn, not silently drop records.
    (tmp_path / "darwin.0.paf").unlink()
    r = subprocess.run(base + ["--resume"], capture_output=True,
                       text=True, env=env, cwd=tmp_path)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "WARNING" in r.stderr and "darwin.0.paf" in r.stderr


@pytest.mark.slow
def test_cli_chunked_paf(data_dir, tmp_path):
    """--chunk-reads + --paf-out writes the same PAF as the in-memory
    run (this combination used to be silently ignored)."""
    d = data_dir / "guided"
    env = {"PYTHONPATH": str(REPO), "PATH": "/usr/bin:/bin",
           "JAX_PLATFORMS": "cpu", "HOME": "/root"}

    def run(extra, out):
        cmd = [sys.executable, "-m", "darwin_tpu.cli",
               str(d / "ref.fasta"), str(d / "reads.fasta"),
               "--params", str(d / "params.cfg"), "--batch-size", "64",
               "--out-dir", str(tmp_path / out),
               "--paf-out", str(tmp_path / f"{out}.paf")] + extra
        r = subprocess.run(cmd, capture_output=True, text=True,
                           env=env, cwd=tmp_path)
        assert r.returncode == 0, r.stderr[-2000:]
        return (tmp_path / f"{out}.paf").read_text().splitlines()

    whole = run([], "whole")
    chunked = run(["--chunk-reads", "5"], "chunk")
    assert whole and chunked == whole


@pytest.mark.slow
def test_cli_mesh_sharded_engine(data_dir, tmp_path):
    d = data_dir / "tiny"
    env = {"PYTHONPATH": str(REPO), "PATH": "/usr/bin:/bin",
           "JAX_PLATFORMS": "cpu", "HOME": "/root",
           "XLA_FLAGS": "--xla_force_host_platform_device_count=8"}
    cmd = [sys.executable, "-m", "darwin_tpu.cli",
           str(d / "reads.fasta"), str(d / "reads.fasta"),
           "--params", str(d / "params.cfg"), "--batch-size", "64",
           "--engine", "device", "--mesh", "8",
           "--out-dir", str(tmp_path),
           "--merged-out", str(tmp_path / "out.darwin")]
    r = subprocess.run(cmd, capture_output=True, text=True, env=env,
                       cwd=tmp_path)
    assert r.returncode == 0, r.stderr[-2000:]
    got = (tmp_path / "out.darwin").read_text().splitlines()
    want = sorted(set((d / "out.darwin").read_text().splitlines()))
    assert got == want


@pytest.mark.slow
def test_cli_empty_reads(data_dir, tmp_path):
    """Zero-read inputs must exit cleanly with empty outputs."""
    ref = data_dir / "tiny" / "reads.fasta"
    empty = tmp_path / "empty.fasta"
    empty.write_text("")
    env = {"PYTHONPATH": str(REPO), "PATH": "/usr/bin:/bin",
           "JAX_PLATFORMS": "cpu", "HOME": "/root"}
    cmd = [sys.executable, "-m", "darwin_tpu.cli", str(ref), str(empty),
           "2", "--params", str(data_dir / "tiny" / "params.cfg"),
           "--out-dir", str(tmp_path),
           "--merged-out", str(tmp_path / "out.darwin")]
    r = subprocess.run(cmd, capture_output=True, text=True, env=env,
                       cwd=tmp_path)
    assert r.returncode == 0, r.stderr[-2000:]
    assert (tmp_path / "out.darwin").read_text() == ""


@pytest.mark.slow
def test_cli_compile_cache_env(data_dir, tmp_path):
    """With JAX_COMPILATION_CACHE_DIR set, the CLI's compiled programs
    land in that directory (the CLI sets no other cache)."""
    d = data_dir / "tiny"
    cache = tmp_path / "jaxcache"
    env = {"PYTHONPATH": str(REPO), "PATH": "/usr/bin:/bin",
           "JAX_PLATFORMS": "cpu", "HOME": "/root",
           "JAX_COMPILATION_CACHE_DIR": str(cache),
           "JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS": "0"}
    r = subprocess.run(
        [sys.executable, "-m", "darwin_tpu.cli", str(d / "reads.fasta"),
         str(d / "reads.fasta"), "--params", str(d / "params.cfg"),
         "--batch-size", "64", "--out-dir", str(tmp_path),
         "--merged-out", str(tmp_path / "m.out")],
        capture_output=True, text=True, env=env, cwd=tmp_path,
        timeout=500)
    assert r.returncode == 0, r.stderr[-2000:]
    want = sorted(set((d / "out.darwin").read_text().splitlines()))
    assert (tmp_path / "m.out").read_text().splitlines() == want
    assert cache.exists() and any(cache.iterdir())

"""Multi-host layer: read-range split, record merge, distributed CLI.

True multi-process runs need a coordinator and several hosts; here we
verify the single-process degenerate paths end-to-end plus the split /
merge logic for arbitrary process counts (the multi-process branch of
allgather_records is exercised on simulated inputs).
"""

import subprocess
import sys
from pathlib import Path

import pytest

from darwin_tpu.parallel import distributed as dist

REPO = Path(__file__).resolve().parent.parent


def test_read_range_split_matches_reference_rule():
    # ceil-split with truncated tail, like darwin.cpp:619-632.
    for num_reads, count in [(40, 1), (40, 4), (41, 4), (3, 8), (0, 4)]:
        ranges = [dist.read_range(num_reads, i, count)
                  for i in range(count)]
        flat = [k for r in ranges for k in r]
        assert flat == list(range(num_reads)), (num_reads, count)
        per = -(-num_reads // count) if num_reads else 0
        assert all(len(r) <= per for r in ranges)


def test_read_range_defaults_single_process():
    assert list(dist.read_range(7)) == list(range(7))
    assert dist.process_count() == 1
    assert dist.process_index() == 0


def test_allgather_records_single_process_is_sort_uniq():
    recs = ["b x", "a y", "b x", "c"]
    assert dist.allgather_records(recs) == ["a y", "b x", "c"]
    assert dist.allgather_records([]) == []


def test_maybe_initialize_noop_without_coordinator(monkeypatch):
    monkeypatch.delenv("JAX_COORDINATOR_ADDRESS", raising=False)
    assert dist.maybe_initialize() is False


def test_barrier_single_process_noop():
    dist.barrier("test")  # must not raise


@pytest.mark.slow
def test_cli_distributed_single_process(data_dir, tmp_path):
    d = data_dir / "tiny"
    cmd = [sys.executable, "-m", "darwin_tpu.cli",
           str(d / "reads.fasta"), str(d / "reads.fasta"),
           "--params", str(d / "params.cfg"),
           "--batch-size", "64",
           "--distributed",
           "--out-dir", str(tmp_path),
           "--merged-out", str(tmp_path / "out.darwin")]
    env = {"PYTHONPATH": str(REPO), "PATH": "/usr/bin:/bin",
           "JAX_PLATFORMS": "cpu", "HOME": "/root"}
    r = subprocess.run(cmd, capture_output=True, text=True, env=env,
                       cwd=tmp_path)
    assert r.returncode == 0, r.stderr[-2000:]
    # Single process owns the whole read range -> darwin.0.out only.
    assert (tmp_path / "darwin.0.out").exists()
    got = (tmp_path / "out.darwin").read_text().splitlines()
    want = sorted(set((d / "out.darwin").read_text().splitlines()))
    assert got == want


@pytest.mark.slow
def test_cli_distributed_two_processes(data_dir, tmp_path):
    """Real 2-process jax.distributed run of the CLI: read ranges split
    across processes, records merged via the cross-process all-gather,
    merged output identical on both and equal to the oracle."""
    d = data_dir / "tiny"

    def proc(pid):
        env = {"PYTHONPATH": str(REPO), "PATH": "/usr/bin:/bin",
               "JAX_PLATFORMS": "cpu", "HOME": "/root",
               "JAX_COORDINATOR_ADDRESS": "127.0.0.1:9934",
               "JAX_NUM_PROCESSES": "2", "JAX_PROCESS_ID": str(pid)}
        cmd = [sys.executable, "-m", "darwin_tpu.cli",
               str(d / "reads.fasta"), str(d / "reads.fasta"),
               "--params", str(d / "params.cfg"),
               "--batch-size", "64", "--distributed",
               "--out-dir", str(tmp_path),
               "--paf-out", str(tmp_path / f"paf.{pid}.paf"),
               "--merged-out", str(tmp_path / f"merged.{pid}.out")]
        return subprocess.Popen(cmd, env=env, cwd=tmp_path,
                                stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)

    procs = [proc(0), proc(1)]
    for p in procs:
        out, err = p.communicate(timeout=300)
        assert p.returncode == 0, err[-2000:]

    # Per-process range outputs exist and cover disjoint read ranges.
    assert (tmp_path / "darwin.0.out").exists()
    assert (tmp_path / "darwin.1.out").exists()

    want = sorted(set((d / "out.darwin").read_text().splitlines()))
    m0 = (tmp_path / "merged.0.out").read_text().splitlines()
    m1 = (tmp_path / "merged.1.out").read_text().splitlines()
    assert m0 == m1 == want

    # PAF is all-gathered: every process writes the full merged set
    # (one record per merged overlap), identical across processes.
    p0 = (tmp_path / "paf.0.paf").read_text().splitlines()
    p1 = (tmp_path / "paf.1.paf").read_text().splitlines()
    assert p0 == p1 and len(p0) == len(want)
    for line in p0:
        assert len(line.split("\t")) == 13


@pytest.mark.slow
def test_abort_propagation_peer_death(data_dir, tmp_path):
    """Failure detection: when one process of a 2-process job dies,
    the survivor must fail loudly (missed-heartbeat RuntimeError)
    within the configured window instead of hanging at the merge."""
    d = data_dir / "tiny"

    def env(pid):
        return {"PYTHONPATH": str(REPO), "PATH": "/usr/bin:/bin",
                "JAX_PLATFORMS": "cpu", "HOME": "/root",
                "JAX_COORDINATOR_ADDRESS": "127.0.0.1:9951",
                "JAX_NUM_PROCESSES": "2", "JAX_PROCESS_ID": str(pid),
                "DARWIN_TPU_HEARTBEAT_S": "10"}

    cmd = [sys.executable, "-m", "darwin_tpu.cli",
           str(d / "reads.fasta"), str(d / "reads.fasta"),
           "--params", str(d / "params.cfg"), "--batch-size", "64",
           "--distributed", "--out-dir", str(tmp_path),
           "--merged-out", str(tmp_path / "merged.out")]
    p0 = subprocess.Popen(cmd, env=env(0), cwd=tmp_path,
                          stdout=subprocess.PIPE,
                          stderr=subprocess.PIPE, text=True)
    # Process 1 initializes the distributed runtime, then dies hard
    # before doing any work.
    killer = ("import darwin_tpu.parallel.distributed as dist, os, "
              "signal; dist.maybe_initialize(); "
              "os.kill(os.getpid(), signal.SIGKILL)")
    p1 = subprocess.Popen([sys.executable, "-c", killer], env=env(1),
                          cwd=tmp_path, stdout=subprocess.PIPE,
                          stderr=subprocess.PIPE, text=True)
    p1.communicate(timeout=120)
    try:
        out, err = p0.communicate(timeout=240)
    except subprocess.TimeoutExpired:
        p0.kill()
        p0.communicate()
        pytest.fail("survivor hung instead of aborting on peer death")
    assert p0.returncode != 0, f"survivor exited 0:\n{out[-1000:]}"


@pytest.mark.parametrize("coord,pid,want", [
    ("localhost:1234", 3, [3]), ("127.0.0.1:9934", 1, [1]),
    ("[::1]:9934", 0, [0]), ("10.0.0.7:9934", 2, None)])
def test_pinned_device_ids_one_card_per_local_process(
        monkeypatch, coord, pid, want):
    """Processes on one host (loopback coordinator) each own one card;
    a remote coordinator leaves every local card visible."""
    monkeypatch.delenv("LOCAL_RANK", raising=False)
    monkeypatch.delenv("JAX_LOCAL_DEVICE_IDS", raising=False)
    assert dist.pinned_device_ids(coord, pid) == want


def test_pinned_device_ids_launcher_rank(monkeypatch):
    monkeypatch.setenv("LOCAL_RANK", "2")
    monkeypatch.delenv("JAX_LOCAL_DEVICE_IDS", raising=False)
    assert dist.pinned_device_ids("10.0.0.7:9934", 5) == [2]
    monkeypatch.setenv("JAX_LOCAL_DEVICE_IDS", "0,1")
    assert dist.pinned_device_ids("localhost:1", 1) is None  # JAX's own


def test_maybe_initialize_pins_local_card(monkeypatch):
    """--distributed with several processes on one host passes one
    local device id per process to jax.distributed.initialize."""
    import jax

    seen = {}
    monkeypatch.setattr(jax.distributed, "is_initialized", lambda: False)
    monkeypatch.setattr(jax.distributed, "initialize",
                        lambda **kw: seen.update(kw))
    monkeypatch.delenv("LOCAL_RANK", raising=False)
    monkeypatch.delenv("JAX_LOCAL_DEVICE_IDS", raising=False)
    dist.maybe_initialize("localhost:9999", 4, 3)
    assert seen["local_device_ids"] == [3]
    assert seen["num_processes"] == 4 and seen["process_id"] == 3

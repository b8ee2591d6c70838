"""Memory observability: host RSS polling + device memory stats.

Counterpart of the reference's y_measure_mem_usage.sh (RSS polling via
/proc) plus the GPU-free-memory print in cuda_host.cu:230-232.

Usage:
    python tools/mem_usage.py watch <pid> [interval_s]   # poll RSS
    python tools/mem_usage.py device                     # device stats
"""

from __future__ import annotations

import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def rss_kb(pid: int) -> int | None:
    try:
        for line in Path(f"/proc/{pid}/status").read_text().splitlines():
            if line.startswith("VmRSS:"):
                return int(line.split()[1])
    except (FileNotFoundError, ProcessLookupError):
        return None
    return None


def watch(pid: int, interval: float) -> None:
    peak = 0
    while True:
        kb = rss_kb(pid)
        if kb is None:
            break
        peak = max(peak, kb)
        print(f"rss_mb={kb / 1024:.1f} peak_mb={peak / 1024:.1f}",
              flush=True)
        time.sleep(interval)
    print(f"process {pid} exited; peak_rss_mb={peak / 1024:.1f}")


def device_stats() -> None:
    import jax

    for d in jax.devices():
        stats = {}
        try:
            stats = d.memory_stats() or {}
        except (AttributeError, NotImplementedError):
            pass
        used = stats.get("bytes_in_use")
        limit = stats.get("bytes_limit")
        if used is not None:
            print(f"{d}: {used / 2**20:.1f} MiB in use"
                  + (f" / {limit / 2**20:.1f} MiB" if limit else ""))
        else:
            print(f"{d}: memory stats unavailable")


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not argv or argv[0] not in ("watch", "device"):
        print(__doc__)
        return 2
    if argv[0] == "watch":
        watch(int(argv[1]), float(argv[2]) if len(argv) > 2 else 1.0)
    else:
        device_stats()
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Measure the host I/O under the mmap client store at FEMNIST's width.

One row is a client's 62 x 300 x 1568 int32 TA states (116.6 MB, the
store's largest leaf).  Under ``DIR`` (default ``build/store_probe``,
deleted at the end) the script times and meters:

* a memory-mapped leaf file of 40 rows (``np.memmap``, as the JAX
  package's store maps its files): the host memory in use before and
  after writing one row into it;
* positional I/O on a 1000-row file created sparse: 20 rows written at
  spread offsets (``os.pwrite``), ``fsync``, read back (``os.preadv``),
  with the memory in use after each;
* sha256 of one row (the per-row digest of a spill and of a verified
  gather), a host copy of 20 rows, and with a GPU 20 rows' copy to the
  card and back from pageable memory.

The memory in use is the cgroup's (``memory.usage_in_bytes``), else
``MemTotal - MemAvailable``.  Prints one JSON line:

    python3 tools/store_io_probe.py [DIR]
"""
import hashlib
import json
import os
import shutil
import sys
import time
from pathlib import Path

import numpy as np

ROW = 62 * 300 * 1568 * 4
N, K, MAPPED = 1000, 20, 40


def in_use() -> int:
    cg = Path("/sys/fs/cgroup/memory/memory.usage_in_bytes")
    if cg.exists():
        return int(cg.read_text())
    info = {line.split(":")[0]: int(line.split()[1]) * 1024
            for line in open("/proc/meminfo")}
    return info["MemTotal"] - info["MemAvailable"]


def clock(fn):
    t = time.perf_counter()
    fn()
    return time.perf_counter() - t


def main() -> None:
    root = Path(sys.argv[1] if len(sys.argv) > 1 else "build/store_probe")
    root.mkdir(parents=True, exist_ok=True)
    row = np.random.default_rng(0).integers(0, 127, ROW // 4, np.int32)
    out = {"row_bytes": ROW}
    try:
        mapped = root / "mapped.bin"
        with open(mapped, "wb") as f:
            f.truncate(MAPPED * ROW)
        mm = np.memmap(mapped, dtype=np.int32, mode="r+",
                       shape=(MAPPED, ROW // 4))
        before = in_use()
        mm[3] = row
        out["memmap_one_row_in_use_delta"] = in_use() - before
        del mm
        mapped.unlink()

        path = root / "rows.bin"
        with open(path, "wb") as f:
            f.truncate(N * ROW)
        before = in_use()
        fd = os.open(path, os.O_RDWR)
        at = [i * ROW for i in range(0, N, N // K)]
        out["pwrite_20_rows_s"] = clock(
            lambda: [os.pwrite(fd, row.data, off) for off in at])
        out["pwrite_in_use_delta"] = in_use() - before
        out["fsync_s"] = clock(lambda: os.fsync(fd))
        buf = np.empty_like(row)
        out["preadv_20_rows_s"] = clock(
            lambda: [os.preadv(fd, [buf.data], off) for off in at])
        out["preadv_in_use_delta"] = in_use() - before
        os.close(fd)
        st = path.stat()
        out["file_apparent"], out["file_st_blocks"] = \
            st.st_size, st.st_blocks * 512
        path.unlink()

        out["sha256_row_s"] = clock(lambda: hashlib.sha256(row.data))
        block = np.tile(row, K)
        out["host_copy_20_rows_s"] = clock(lambda: block.copy())
        try:
            import torch
            if torch.cuda.is_available():
                host = torch.from_numpy(block)
                dev = host.to("cuda")
                torch.cuda.synchronize()
                out["h2d_20_rows_s"] = clock(
                    lambda: (host.to("cuda"), torch.cuda.synchronize()))
                out["d2h_20_rows_s"] = clock(lambda: dev.cpu())
                out["device"] = torch.cuda.get_device_name(0)
        except ImportError:
            pass
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()

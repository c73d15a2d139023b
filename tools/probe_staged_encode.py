#!/usr/bin/env python3
"""Where the staged encoder's time goes on the card, phase by phase.

    python3 tools/probe_staged_encode.py

Builds copies of the kernel sources (``src/repro_torch/csrc``), each into a
library of its own, in which thread 0 of every block of
``bqcs_encode_kernel`` reads %globaltimer just before each line whose
comment carries a PROBE: number (start, tile product done, partials
published, cluster synced, reduced with alpha known, stored):

* ``as built``: the kernel as it ships, held against the plain version
  first;
* ``no product``: without the tile product's FMAs and shared loads (the
  line of ``common.cuh::tile_product`` marked PROBE:product is skipped);
* ``no staging``: without the copies after the ring's first stages (the
  line marked PROBE:staging is skipped).

The cut-down builds compute wrong codes and are not checked.  Each build is
timed at the paper's shape (300 x 1591 -> 530, top-S blocks, Q = 3) at
clusters 1, 2 and 4, and each line prints the kernel's time (CUDA events),
the last launch's span, and the mean (max) over the blocks of each phase in
us.  Needs one CUDA card and ``nvcc``; exits 2 without a card.
"""

from __future__ import annotations

import re
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PHASES = ("product", "publish", "cluster sync", "reduce", "quantize")
VARIANTS = {"as built": None, "no product": "product", "no staging": "staging"}
MAX_BLOCKS = 4096
HEADER = ('#include "common.cuh"\n'
          f"__device__ unsigned long long probe_stamps[{MAX_BLOCKS} * 8];\n"
          'extern "C" int probe_read(void* dst) {\n'
          "  return (int)cudaMemcpyFromSymbol(dst, probe_stamps, sizeof(probe_stamps));\n}\n")
STAMP = ('{indent}if (threadIdx.x == 0) asm volatile("mov.u64 %0, %%globaltimer;" : '
         '"=l"(probe_stamps[blockIdx.x * 8 + {i}]));\n')


def instrumented(kernel: str, common: str, variant: str) -> tuple[str, str]:
    """The texts of ``bqcs_encode.cu`` and ``common.cuh`` for one variant:
    a stamp before each line marked PROBE:<i> in the kernel (i = 0 .. 5, each
    once), and the common.cuh line marked PROBE:<cut> guarded by ``if
    (false)``.  Raises if a mark is missing or repeated."""
    lines = []
    for line in kernel.splitlines(keepends=True):
        m = re.search(r"PROBE:(\d+)", line)
        if m:
            lines.append(STAMP.format(indent=re.match(r"[ \t]*", line)[0], i=m[1]))
        lines.append(line)
    kernel = "".join(lines)
    marks = [int(i) for i in re.findall(r"PROBE:(\d+)", kernel)]
    if marks != list(range(len(PHASES) + 1)):
        raise ValueError(f"bqcs_encode.cu carries PROBE marks {marks}")
    if kernel.count('#include "common.cuh"\n') != 1:
        raise ValueError("bqcs_encode.cu must include common.cuh once")
    kernel = kernel.replace('#include "common.cuh"\n', HEADER)
    cut = VARIANTS[variant]
    if cut is not None:
        pat = re.compile(rf"^([ \t]*)(.*// PROBE:{cut}\n)", re.M)
        common, n = pat.subn(r"\1if (false) \2", common)
        if n != 1:
            raise ValueError(f"common.cuh carries PROBE:{cut} {n} times")
    return kernel, common


def main() -> int:
    try:
        import torch
    except ImportError:
        print("probe_staged_encode: PyTorch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("probe_staged_encode: no CUDA card", file=sys.stderr)
        return 2
    import ctypes
    import shutil
    import subprocess

    import numpy as np

    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from chip_smoke import M, N, Q, S, GpuTimer, check, kernels_from, staged_vs_plain
    from repro_torch.core.quantizer import design_lloyd_max
    from repro_torch.kernels import build, ref
    from repro_torch.kernels.bqcs_encode import TILE_COLS, TILE_ROWS, bqcs_encode

    dev = torch.device("cuda")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    rows = 300
    rng = np.random.default_rng(0)
    x = torch.as_tensor(rng.normal(0, 0.1, (rows, N)).astype(np.float32), device=dev)
    x = ref.block_topk_ref(x, S)[0]
    a_t = torch.as_tensor((rng.standard_normal((M, N)) / np.sqrt(M)).astype(np.float32),
                          device=dev).T.contiguous()
    taus = torch.as_tensor(design_lloyd_max(Q).thresholds.astype(np.float32), device=dev)
    timer = GpuTimer()
    csrc = build.CSRC
    for variant in VARIANTS:
        src = build.BUILD_ROOT / f"probe-{variant.replace(' ', '-')}"
        shutil.rmtree(src, ignore_errors=True)
        shutil.copytree(csrc, src)
        kernel, common = instrumented((src / "bqcs_encode.cu").read_text(),
                                      (src / "common.cuh").read_text(), variant)
        (src / "bqcs_encode.cu").write_text(kernel)
        (src / "common.cuh").write_text(common)
        with kernels_from(src) as lib:
            read = lib.lib.probe_read
            read.argtypes, read.restype = [ctypes.c_void_p], ctypes.c_int
            for c in (1, 2, 4):
                if variant == "as built":
                    staged_vs_plain(x, a_t, taus, c)
                ms = timer(lambda: bqcs_encode(x, a_t, taus, _cluster=c))
                torch.cuda.synchronize()
                buf = np.zeros(MAX_BLOCKS * 8, np.uint64)
                check(read(buf.ctypes.data) == 0, "probe_read failed")
                blocks = -(-rows // TILE_ROWS) * -(-M // TILE_COLS) * c
                t = buf.reshape(MAX_BLOCKS, 8)[:blocks, :len(PHASES) + 1].astype(np.int64)
                d = np.diff(t, axis=1) / 1e3
                phases = ", ".join(f"{p} {d[:, i].mean():.2f} ({d[:, i].max():.2f})"
                                   for i, p in enumerate(PHASES))
                print(f"[probe] {variant}, cluster {c} ({blocks} blocks): kernel {ms:.4f} ms; "
                      f"last launch's span {(t[:, -1].max() - t[:, 0].min()) / 1e3:.2f} us; "
                      f"per block, mean (max) us: {phases}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Builds the CUDA kernels under ``csrc/`` and binds them with ``ctypes``.

Each ``*.cu`` source compiles with its own ``nvcc`` process (all started
together) for ``sm_90a``, then one link step makes a shared library with a
plain C interface.  The build happens at first use, into
``<checkout>/build/kernels-<hash>/``, keyed by a hash of the sources and the
flags, so a changed source rebuilds and an unchanged one loads at once.  A
failed build raises with nvcc's output.  Nothing here runs at import: this
module is imported on machines without ``nvcc`` or a card, where only the
plain versions run.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Optional

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build"
SOURCES = (
    "bqcs_encode_fused.cu", "qgamp_step.cu", "gamp_step.cu", "block_topk.cu", "bqcs_encode.cu",
)
HEADERS = ("common.cuh", "gm_prior.cuh")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
# C entry points: name -> argtypes (every launcher returns cudaGetLastError()).
_SIGNATURES = {
    # blocks, residual, a_t, tab, cn, dither, words, alpha, resid, nb, n, mp,
    # m, s, bits, n_tab, vq_d, iters, stream
    "bqcs_encode_fused_launch": [_P] * 9 + [_I] * 9 + [_P],
    # x, sparse, resid, nb, n, s, iters, stream
    "block_topk_launch": [_P] * 3 + [_I] * 4 + [_P],
    # x, a_t, taus, codes, alpha, nb, n, m, n_taus, cluster, stream
    "bqcs_encode_launch": [_P] * 5 + [_I] * 5 + [_P],
    # ghat, nu_g, shat, theta, obs, alpha, lo_tau, hi_tau, a,
    # ghat_out, nug_out, shat_out, theta_out, nb, n, m, L, em, bits, obs_w,
    # n_lev, rows_per_tile, cluster, stream
    "qgamp_step_launch": [_P] * 13 + [_I] * 10 + [_P],
    # ghat, nu_g, shat, theta, y, nu_d, a, ghat_out, nug_out, shat_out,
    # theta_out, nb, n, m, L, em, rows_per_cta, cluster, stream
    "gamp_step_launch": [_P] * 11 + [_I] * 7 + [_P],
}


class KernelLibrary:
    """The loaded shared library plus what its build cost."""

    def __init__(self, path: Path, build_s: float, log: str):
        self.path = path
        self.build_s = build_s  # 0.0 when an earlier build was reused
        self.log = log
        self.lib = ctypes.CDLL(str(path))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(self.lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        self.lib.fedqcs_error_string.argtypes = [ctypes.c_int]
        self.lib.fedqcs_error_string.restype = ctypes.c_char_p

    def call(self, name: str, *args) -> None:
        """Launches one kernel; raises if the launch reported an error."""
        err = getattr(self.lib, name)(*args)
        if err != 0:
            msg = self.lib.fedqcs_error_string(err).decode()
            raise RuntimeError(f"{name} failed: CUDA error {err} ({msg})")


_LOADED: Optional[KernelLibrary] = None


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is")
    return found


def _build(out: Path) -> tuple[float, str]:
    nvcc = _nvcc()
    out.parent.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=out.parent) as tmp:
        procs = []
        for src in SOURCES:
            obj = Path(tmp) / (src + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-c", str(CSRC / src), "-o", str(obj)]
            procs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
            )))
        log, failed = [], []
        for src, _, proc in procs:
            text, _ = proc.communicate()
            log.append(f"== {src}\n{text}")
            if proc.returncode != 0:
                failed.append(src)
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(log))
        lib_tmp = Path(tmp) / out.name
        link = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
                "-o", str(lib_tmp)] + [str(obj) for _, obj, _ in procs]
        res = subprocess.run(link, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        log.append(f"== link\n{res.stdout}")
        if res.returncode != 0:
            raise RuntimeError("nvcc link failed:\n" + "\n".join(log))
        text = "\n".join(log)
        out.with_suffix(".log").write_text(text)
        os.replace(lib_tmp, out)  # atomic: a concurrent build never sees half a file
    return time.perf_counter() - t0, text


def library() -> KernelLibrary:
    """The kernel library, built on first call in this process."""
    global _LOADED
    if _LOADED is None:
        out = BUILD_ROOT / f"kernels-{_digest()}" / "libfedqcs_kernels.so"
        if out.exists():
            build_s, log = 0.0, out.with_suffix(".log").read_text()
        else:
            build_s, log = _build(out)
        _LOADED = KernelLibrary(out, build_s, log)
    return _LOADED


def stream_handle(device) -> int:
    """PyTorch's current CUDA stream on ``device``, as a pointer-sized int."""
    import torch

    return torch.cuda.current_stream(device).cuda_stream

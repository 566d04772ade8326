"""Build, load and time the hand-written CUDA kernels of ``aosx_torch/csrc``.

Each ``csrc/<name>.cu`` has a plain C entry point that returns
``cudaGetLastError()``. It is compiled with ``nvcc`` for ``sm_90a`` (Hopper)
into ``aosx_torch/_build/lib<name>-<hash>.so`` on first use, where the hash
covers the source and the flags, and loaded with ``ctypes``. Nothing is
built at import time: the CPU-only test environment imports every module.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import statistics
import subprocess
import time

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parent / "_build"

# -fmad=false: no multiply-add contraction, so every float expression
# rounds exactly like the plain PyTorch version, op by op
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-fmad=false",
    "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)
# about 0.25 ms of torch.cuda._sleep queued ahead of a timed call, so that
# CUDA events time the card's work and not the host's launch latency (a
# cooperative launch alone takes the host some 20-40 us)
BUSY_CYCLES = 500_000


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels of aosx_torch need "
                       "the CUDA toolkit (nvcc on PATH or in /usr/local/cuda)")


def library_path(name: str) -> pathlib.Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    key = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{key}.so"


def build(name: str) -> pathlib.Path:
    """Compile ``csrc/<name>.cu`` unless its library is already built.
    The compiler's resource report is kept beside it as ``.log``."""
    so = library_path(name)
    if so.exists():
        return so
    BUILD_DIR.mkdir(exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    r = subprocess.run(cmd, capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{r.stdout}\n{r.stderr}")
    so.with_suffix(".log").write_text(r.stdout + r.stderr)
    os.replace(tmp, so)
    return so


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """The built library of ``csrc/<name>.cu`` (built on first use)."""
    return ctypes.CDLL(str(build(name)))


def device_scalar(v, dtype, device):
    """``v`` as the one-element tensor of ``dtype`` on ``device`` that a kernel
    reads through a pointer. A tensor that is one already (a GridWorld's
    bounds and origin) passes through untouched: no copy, no host read."""
    import torch

    if (isinstance(v, torch.Tensor) and v.dtype == dtype and v.numel() == 1
            and v.device == device):
        return v
    return torch.as_tensor(v).to(device=device, dtype=dtype).reshape(())


def check(rc: int, what: str) -> None:
    """Raise when a C entry point returned a non-zero cudaError_t."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc}")


def timed_ms(fn, device, reps: int = 3, setup=None):
    """(warm-up result, median ms of ``reps`` timed calls) of ``fn()``, or of
    ``fn(setup())`` with a fresh ``setup()`` a call made outside the timed
    window (for a function that consumes its input). CUDA events on the
    card, each call behind BUSY_CYCLES of queued sleep; the host clock on the
    CPU."""
    import torch

    def args():
        return () if setup is None else (setup(),)

    out = fn(*args())
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.synchronize(device)
    times = []
    for _ in range(reps):
        a = args()
        if cuda:
            torch.cuda._sleep(BUSY_CYCLES)
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            fn(*a)
            end.record()
            torch.cuda.synchronize(device)
            times.append(start.elapsed_time(end))
        else:
            t0 = time.perf_counter()
            fn(*a)
            times.append(1e3 * (time.perf_counter() - t0))
    return out, statistics.median(times)

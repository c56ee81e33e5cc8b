"""Build and load the CUDA kernel library (``csrc/*.cu``).

The sources compile with ``nvcc`` for ``sm_90a`` into ONE shared
library with a plain C interface, loaded with ``ctypes`` — no PyTorch
headers, so a build takes seconds.  Each source compiles to its own
object in parallel; the library is linked from them and named by a
hash of the sources, under ``build/kernels/`` at the repository root
(listed in ``.gitignore``).  The build runs at the first launch of any
kernel, never at import: the CPU tests import every module.

``KernelInfo`` carries each kernel's identity and its ``launches``
count: a wrapper adds one exactly where it calls into the library.
"""
from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from dataclasses import dataclass
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
REPO = Path(__file__).resolve().parents[3]
BUILD_DIR = REPO / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC"]

# (name, argtypes) of every C entry point; each returns cudaGetLastError()
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "bp_binarize_pack": [_P, _P, _I, _I, _I, _F, _I, _P],
    "bp_pack_patches": [_P, _P] + [_I] * 12 + [_F, _I, _P],
    "fb_b1_mma_rate": [_P, _I, _I, _P],
    "fb_fused_bnn": [_P] * 5 + [_I] * 4 + [_F, _I, _P],
    "pa_paged_attention": [_P] * 10 + [_I] * 11 + [_F, _P],
    "pm_paged_attention_mla": [_P] * 14 + [_I] * 14 + [_F, _P],
    "xp_xnor_popcount": [_P] * 6 + [_I] * 9 + [_P],
}


@dataclass
class KernelInfo:
    """One hand-written kernel: its name, its source, the TPU kernel it
    replaces, and how often its wrapper launched it."""
    name: str
    source: str
    replaces: str
    launches: int = 0


class _Library:
    """The loaded library plus how long the build took (0 when a
    library built earlier from the same sources was found)."""

    def __init__(self):
        self.handle = None
        self.build_s = 0.0
        self.path: Path | None = None

    def load(self) -> ctypes.CDLL:
        if self.handle is None:
            t0 = time.perf_counter()
            self.path = build()
            self.build_s = time.perf_counter() - t0
            lib = ctypes.CDLL(str(self.path))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            self.handle = lib
        return self.handle


LIBRARY = _Library()


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (PATH, CUDA_HOME or /usr/local/cuda): "
                       "the CUDA kernels cannot be built")


def build() -> Path:
    """Compile every ``csrc/*.cu`` (in parallel) and link the library;
    returns its path.  Reuses a library built from identical sources."""
    sources = sorted(CSRC.glob("*.cu"))
    digest = hashlib.sha256()
    for src in sorted(CSRC.glob("*.cu*")):
        digest.update(src.name.encode() + src.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    out = BUILD_DIR / f"librepro_torch_{digest.hexdigest()[:16]}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [Path(tmp) / (src.stem + ".o") for src in sources]
        procs = [subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-Xptxas", "-v", "-c", str(src), "-o", str(obj)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for src, obj in zip(sources, objs)]
        logs = [p.communicate()[0] for p in procs]
        for src, proc, log in zip(sources, procs, logs):
            if proc.returncode:
                raise RuntimeError(f"nvcc failed on {src.name}:\n{log}")
        (BUILD_DIR / "ptxas.log").write_text("".join(logs))
        tmp_lib = Path(tmp) / out.name
        link = subprocess.run([nvcc, *NVCC_FLAGS, "-shared", *map(str, objs),
                               "-o", str(tmp_lib)],
                              capture_output=True, text=True)
        if link.returncode:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}{link.stderr}")
        os.replace(tmp_lib, out)        # atomic: concurrent builders agree
    return out


def launch(fn_name: str, device: torch.device, *args) -> None:
    """Call one C entry point on ``device``, the device of the tensors
    in ``args``: under that device (the entry points read the current
    device's SM count and shared-memory opt-ins) and on its current
    stream.  Raise on any CUDA error it reports."""
    fn = getattr(LIBRARY.load(), fn_name)
    idx = device.index
    switch = idx is not None and idx != torch.cuda.current_device()
    with torch.cuda.device(idx) if switch else contextlib.nullcontext():
        stream = torch.cuda.current_stream(idx).cuda_stream
        err = fn(*args, ctypes.c_void_p(stream))
    if err:
        raise RuntimeError(f"{fn_name}: CUDA error {err}")


_SM_COUNT: dict[int, int] = {}


def sm_count(device: torch.device) -> int:
    """The SM count of a CUDA device, read from its properties once per
    device (the kernels' launch policies ask for it on every call)."""
    idx = torch.cuda.current_device() if device.index is None else device.index
    if idx not in _SM_COUNT:
        _SM_COUNT[idx] = torch.cuda.get_device_properties(
            idx).multi_processor_count
    return _SM_COUNT[idx]


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def check(t: torch.Tensor, name: str, dtype: torch.dtype,
          shape: tuple[int, ...], device: torch.device) -> None:
    """Raise unless ``t`` is a contiguous ``dtype`` tensor of ``shape``
    on ``device`` — what the kernels take, and nothing else."""
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")

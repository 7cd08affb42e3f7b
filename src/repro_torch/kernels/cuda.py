"""Build and bind the port's hand-written CUDA kernels.

Each kernel is one ``csrc/*.cu`` file with a plain C interface: a
``<name>_launch(...)`` function that launches on the stream it is given
and returns ``cudaGetLastError()``, plus ``<name>_error_string``. The
source is compiled by ``nvcc`` for ``sm_90a`` into a shared library on
first use, under ``kernels/_build/`` (git-ignored), keyed by a hash of
the source and the flags, and loaded with ``ctypes``.

A :class:`CudaKernel` also counts its launches (``launches``), so a run
can show that its main path went through the kernel.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Iterable, List, Optional, Sequence

BUILD_DIR = Path(__file__).resolve().parent / "_build"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def nvcc_path() -> str:
    """The CUDA compiler: ``nvcc`` on PATH, else under the toolkit that
    PyTorch found (``CUDA_HOME``)."""
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME:
        cand = Path(CUDA_HOME) / "bin" / "nvcc"
        if cand.exists():
            return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels are compiled on "
                       "first use and need the CUDA toolkit")


class CudaKernel:
    """One hand-written kernel: its source, its C entry point and its
    launch count."""

    def __init__(self, name: str, source: Path, argtypes: Sequence):
        self.name = name
        self.source = Path(source)
        self.argtypes = list(argtypes)
        self.launches = 0
        self.build_log = ""
        self._lib: Optional[ctypes.CDLL] = None
        self._fn = None

    @property
    def library_path(self) -> Path:
        h = hashlib.sha256(self.source.read_bytes())
        h.update(" ".join(NVCC_FLAGS).encode())
        return BUILD_DIR / f"{self.name}-{h.hexdigest()[:16]}.so"

    def start_build(self) -> Optional[subprocess.Popen]:
        """Start ``nvcc`` for this kernel (None when already built)."""
        out = self.library_path
        if out.exists():
            return None
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".so.tmp{os.getpid()}")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(self.source)]
        return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)

    def finish_build(self, proc: Optional[subprocess.Popen]) -> None:
        if proc is None:
            return
        self.build_log, _ = proc.communicate()
        tmp = Path(proc.args[proc.args.index("-o") + 1])
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {self.source}:\n"
                               f"{self.build_log}")
        os.replace(tmp, self.library_path)

    def _function(self):
        if self._fn is None:
            self.finish_build(self.start_build())
            lib = ctypes.CDLL(str(self.library_path))
            fn = getattr(lib, f"{self.name}_launch")
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            err = getattr(lib, f"{self.name}_error_string")
            err.argtypes = [ctypes.c_int]
            err.restype = ctypes.c_char_p
            self._lib, self._fn, self._err = lib, fn, err
        return self._fn

    def launch(self, *args) -> None:
        """Call the C launcher; raise if the launch was refused."""
        code = self._function()(*args)
        if code != 0:
            msg = self._err(code).decode()
            raise RuntimeError(f"{self.name}: kernel launch failed with "
                               f"CUDA error {code} ({msg})")
        self.launches += 1


def build_all(kernels: Iterable[CudaKernel]) -> List[CudaKernel]:
    """Compile every kernel at once, one ``nvcc`` per source, all
    started together; returns the kernels."""
    kernels = list(kernels)
    procs = [k.start_build() for k in kernels]
    for k, p in zip(kernels, procs):
        k.finish_build(p)
    return kernels


def check_tensors(kernel: str, device, want) -> None:
    """Raise ValueError unless every ``(name, tensor, dtype, shape)`` of
    ``want`` lies on CUDA ``device`` with that dtype and shape
    (``None`` in a shape matches any size) and is contiguous.

    One pass over plain attributes: this runs on every launch, and a
    short kernel waits for it."""
    idx = device.index if device.type == "cuda" else -2
    for name, t, dtype, shape in want:
        if not t.is_cuda or t.get_device() != idx:
            raise ValueError(f"{kernel}: {name} is on {t.device}; every "
                             f"operand must be on {device} (CUDA)")
        if t.dtype != dtype:
            raise ValueError(f"{kernel}: {name} is {t.dtype}, "
                             f"expected {dtype}")
        ts = t.shape
        if len(ts) != len(shape) or any(
                s is not None and s != x for s, x in zip(shape, ts)):
            raise ValueError(f"{kernel}: {name} has shape "
                             f"{tuple(ts)}, expected {shape}")
        if not t.is_contiguous():
            raise ValueError(f"{kernel}: {name} is not contiguous")


_SM_COUNT = {}
_SAME_DEVICE = contextlib.nullcontext()


def sm_count(device) -> int:
    """The card's streaming multiprocessors (read once per device)."""
    idx = device.index
    if idx not in _SM_COUNT:
        import torch
        _SM_COUNT[idx] = torch.cuda.get_device_properties(
            device).multi_processor_count
    return _SM_COUNT[idx]


def on_device(device):
    """A context that makes ``device`` the current CUDA device for a
    launch; a no-op when it already is."""
    import torch
    if device.index is None or device.index == torch.cuda.current_device():
        return _SAME_DEVICE
    return torch.cuda.device(device)


def current_stream(device) -> int:
    """PyTorch's current stream on ``device``, as the launcher's handle:
    the raw ``cudaStream_t``, read without building a
    ``torch.cuda.Stream`` object on every launch."""
    import torch
    idx = device.index
    return torch._C._cuda_getCurrentRawStream(
        torch.cuda.current_device() if idx is None else idx)

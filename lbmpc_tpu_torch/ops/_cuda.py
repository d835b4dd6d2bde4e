"""Build and bind the port's CUDA kernels (nvcc + a plain C interface + ctypes).

Each kernel source `csrc/<source>.cu` exports one `<name>_launch(...)` per
kernel in it, which launches on the stream it is given and returns
cudaGetLastError(), and `<source>_error_string(code)`. The shared library is
compiled at first use into build/lbmpc_tpu_torch/ for sm_90a, keyed by a hash
of the source, the shared device headers (csrc/*.cuh) and the flags, so an
edited source is rebuilt and an unchanged one is loaded as it is. Kernels
that share a source share its library.

The wide kernels K1w, K2w and K3w are built with -fmad=false (WIDE_FLAGS):
K3w runs K1w's and K2w's device code in one kernel, and nvcc and ptxas
fuse multiplies and adds into FMAs differently in different kernels, so
without it K3w and K1w -> K2w round apart in late Mehrotra iterations.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess

import torch

CSRC = pathlib.Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parent.parent.parent / "build" / "lbmpc_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

WIDE_FLAGS = ("-fmad=false",)

P = ctypes.c_void_p
I = ctypes.c_int
F = ctypes.c_float


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = pathlib.Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels build on a machine "
                       "with the CUDA toolkit (set CUDA_HOME or PATH)")


class CudaKernel:
    """One kernel: its source's library, its build, its C entry
    `<name>_launch` and the count of launches made through it (`launches`,
    a plain integer that the wrapper bumps once per kernel launch and
    nowhere else). `source` names the .cu file when it is not `<name>.cu`;
    `flags` are nvcc flags beyond NVCC_FLAGS."""

    def __init__(self, name: str, argtypes: list, source: str | None = None,
                 flags: tuple = ()):
        self.name = name
        self.source = CSRC / f"{source or name}.cu"
        self.argtypes = argtypes
        self.flags = tuple(flags)
        self.launches = 0
        self._fn = None
        self._err = None

    def library_path(self) -> pathlib.Path:
        # the shared device headers (the source's *.cuh) are part of every source
        text = self.source.read_bytes() + b"".join(
            p.read_bytes() for p in sorted(self.source.parent.glob("*.cuh")))
        flags = " ".join(NVCC_FLAGS + self.flags)
        digest = hashlib.sha256(text + flags.encode()).hexdigest()[:16]
        return BUILD_DIR / f"lib{self.source.stem}-{digest}.so"

    def build_command(self, out: pathlib.Path, verbose: bool = False) -> list:
        cmd = [nvcc_path(), *NVCC_FLAGS, *self.flags, "-o", str(out), str(self.source)]
        if verbose:
            cmd[1:1] = ["-Xptxas", "-v"]
        return cmd

    def start_build(self, verbose: bool = False):
        """Start nvcc for this kernel unless its library exists; returns the
        Popen (stdout+stderr piped) or None."""
        out = self.library_path()
        if out.exists() and not verbose:
            return None
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        return subprocess.Popen(self.build_command(tmp, verbose),
                                stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                text=True)

    def finish_build(self, proc) -> str:
        """Wait for `start_build`'s process, install the library, and return
        the compiler's output. Raises if nvcc failed."""
        if proc is None:
            return ""
        log, _ = proc.communicate()
        out = self.library_path()
        tmp = pathlib.Path(proc.args[proc.args.index("-o") + 1])
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {self.source.name}:\n{log}")
        os.replace(tmp, out)
        return log

    def fn(self):
        """The bound `<name>_launch` C function (building it if needed)."""
        if self._fn is None:
            self.finish_build(self.start_build())
            lib = ctypes.CDLL(str(self.library_path()))
            fn = getattr(lib, f"{self.name}_launch")
            fn.argtypes = self.argtypes
            fn.restype = I
            err = getattr(lib, f"{self.source.stem}_error_string")
            err.argtypes = [I]
            err.restype = ctypes.c_char_p
            self._fn, self._err = fn, err
        return self._fn

    def launch(self, device: torch.device, *args) -> None:
        """Launch on `device`'s current stream; raises on a launch error."""
        fn = self.fn()
        stream = torch.cuda.current_stream(device).cuda_stream
        with torch.cuda.device(device):
            rc = fn(*args, P(stream))
        if rc != 0:
            raise RuntimeError(f"{self.name} launch failed: CUDA error {rc} "
                               f"({self._err(rc).decode()})")
        self.launches += 1


def build_all(kernels, verbose: bool = False) -> dict:
    """Build several kernels at once (one nvcc per library: a source under
    one set of flags; all started together); returns {library file name:
    compiler output}."""
    procs = {}
    for k in kernels:
        lib = k.library_path()
        if lib not in procs:
            procs[lib] = (k, k.start_build(verbose))
    return {lib.name: k.finish_build(p) for lib, (k, p) in procs.items()}


def ptr(t: torch.Tensor) -> P:
    return P(t.data_ptr())


def check(name: str, t: torch.Tensor, shape: tuple, device: torch.device,
          dtype=torch.float32) -> None:
    """Raise unless `t` is a contiguous `dtype` tensor of `shape` on
    `device` — what the kernels take."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")

"""Build and bind the port's CUDA kernels.

Each ``csrc/*.cu`` source is compiled by ``nvcc`` into its own shared
library with a plain C interface (``extern "C"``), loaded with ``ctypes``.
Libraries are built at first use into ``build/repro_torch_kernels/`` at
the root of the checkout, named by a hash of their sources and flags so an
edited source is rebuilt; ``build_all`` starts one ``nvcc`` per source,
all at once.  Nothing is built when a module is imported.

Every kernel object keeps a plain-integer launch count: its wrapper adds
one where it launches the kernel, and nowhere else.
"""
from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
from typing import Optional, Sequence

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
HEADERS = ("tnn_column.cuh",)

# --fmad=false: no contraction of w + mu * s into an FMA (bit parity with
# the plain PyTorch versions); sm_90a: Hopper.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "--fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# Shared memory one block may use on an H100 (227 KB).
MAX_SMEM_BYTES = 232448

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float


def nvcc_path() -> str:
    """``nvcc`` from CUDA_HOME / CUDA_PATH, PATH, or PyTorch's own lookup."""
    for env in ("CUDA_HOME", "CUDA_PATH"):
        home = os.environ.get(env)
        if home and os.path.isfile(os.path.join(home, "bin", "nvcc")):
            return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils import cpp_extension

    home = cpp_extension.CUDA_HOME
    if home and os.path.isfile(os.path.join(home, "bin", "nvcc")):
        return os.path.join(home, "bin", "nvcc")
    raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")


@dataclasses.dataclass
class CudaKernel:
    """One hand-written kernel: its source, its C entry point, its count.

    ``replaces`` names the TPU kernel of the JAX package it ports.
    """

    name: str
    source: str
    symbol: str
    argtypes: tuple
    replaces: str
    launches: int = 0
    ptxas_log: str = ""
    _fn: Optional[object] = dataclasses.field(default=None, repr=False)
    _smem: Optional[object] = dataclasses.field(default=None, repr=False)
    _lib: Optional[ctypes.CDLL] = dataclasses.field(default=None, repr=False)

    def library_path(self) -> pathlib.Path:
        h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
        for f in (self.source,) + HEADERS:
            h.update((CSRC / f).read_bytes())
        return BUILD_DIR / f"{pathlib.Path(self.source).stem}-{h.hexdigest()[:16]}.so"

    def _start_build(self) -> Optional[tuple[subprocess.Popen, str, pathlib.Path]]:
        """Start nvcc unless the library exists; None when already built."""
        out = self.library_path()
        if out.exists():
            return None
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        proc = subprocess.Popen(
            [nvcc_path(), *NVCC_FLAGS, "-o", tmp, str(CSRC / self.source)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        return proc, tmp, out

    def _bind(self) -> None:
        lib = ctypes.CDLL(str(self.library_path()))
        fn = getattr(lib, self.symbol)
        fn.argtypes = list(self.argtypes)
        fn.restype = ctypes.c_int
        smem = getattr(lib, self.symbol + "_smem_bytes")
        smem.argtypes = [_I, _I]
        smem.restype = ctypes.c_size_t
        self._lib, self._fn, self._smem = lib, fn, smem

    def function(self):
        """The bound C entry point, building the library on first use."""
        if self._fn is None:
            build_all([self])
        return self._fn

    def smem_bytes(self, p: int, q: int) -> int:
        self.function()
        return int(self._smem(p, q))


def _finish(kernel: CudaKernel, started) -> None:
    proc, tmp, out = started
    log, _ = proc.communicate()
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(
            f"nvcc failed on {kernel.source} (exit {proc.returncode}):\n{log}"
        )
    kernel.ptxas_log = log
    os.replace(tmp, out)  # atomic publish: concurrent builds race safely


def build_all(kernels: Sequence[CudaKernel]) -> None:
    """Build every kernel's library, one ``nvcc`` per source, in parallel,
    and bind their entry points.  Raises if any build fails."""
    started = [(k, k._start_build()) for k in kernels]
    errors = []
    for k, s in started:
        if s is None:
            continue
        try:
            _finish(k, s)
        except RuntimeError as e:
            errors.append(str(e))
    if errors:
        raise RuntimeError("\n".join(errors))
    for k in kernels:
        if k._fn is None:
            k._bind()


def check_launch(kernel: CudaKernel, rc: int) -> None:
    """Raise if the C entry point reported a CUDA error at launch."""
    if rc != 0:
        raise RuntimeError(
            f"{kernel.name} launch failed: CUDA error {rc}"
        )


FUSED_STEP = CudaKernel(
    name="fused_step",
    source="fused_step.cu",
    symbol="tnn_fused_step",
    argtypes=(_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _F, _P),
    replaces="src/repro/kernels/fused_column.py:468 _fused_kernel",
)

RNL_FIRE = CudaKernel(
    name="rnl_fire",
    source="rnl_fire.cu",
    symbol="tnn_rnl_fire",
    argtypes=(_P, _P, _P, _I, _I, _I, _F, _I, _I, _P),
    replaces="src/repro/kernels/rnl_response.py:49 _rnl_kernel",
)

KERNELS = (FUSED_STEP, RNL_FIRE)

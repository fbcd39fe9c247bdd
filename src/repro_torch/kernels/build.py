"""Build and bind the port's CUDA kernels.

Each ``csrc/*.cu`` source is compiled by ``nvcc`` into its own shared
library with a plain C interface (``extern "C"``), loaded with ``ctypes``.
Libraries are built at first use into ``build/repro_torch_kernels/`` at
the root of the checkout, named by a hash of their sources and flags so an
edited source is rebuilt; ``build_all`` starts one ``nvcc`` per source,
all at once.  Nothing is built when a module is imported.

Every kernel object keeps plain-integer counts: ``launches`` (its wrapper
adds one where it launches the kernel, and nowhere else), ``builds`` (runs
of ``nvcc`` on its source) and ``binds`` (loads of its library).
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

import torch

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"

# sm_90a: Hopper.  Each kernel adds its own flags (``CudaKernel.flags``).
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
# --fmad=false: no contraction of w + mu * s into an FMA (bit parity of the
# TNN column kernels with their plain PyTorch versions).
EXACT_FLAGS = ("--fmad=false",)
TNN_HEADERS = ("tnn_column.cuh",)

# Shared memory one block may use on an H100 (227 KB).
MAX_SMEM_BYTES = 232448

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong


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
    # argument types of the ``<symbol>_smem_bytes`` entry point: the shape
    # dimensions that size the block's shared memory, then the layout
    # (1: the design's weights resident in shared memory, 0: in device
    # memory); None for a kernel without that entry point
    smem_argtypes: Optional[tuple] = None
    flags: tuple = EXACT_FLAGS
    headers: tuple = TNN_HEADERS
    launches: int = 0
    builds: int = 0
    binds: int = 0
    ptxas_log: str = ""
    _fn: Optional[object] = dataclasses.field(default=None, repr=False)
    _smem: Optional[object] = dataclasses.field(default=None, repr=False)
    _lib: Optional[ctypes.CDLL] = dataclasses.field(default=None, repr=False)

    def library_path(self) -> pathlib.Path:
        h = hashlib.sha256(" ".join(NVCC_FLAGS + self.flags).encode())
        for f in (self.source,) + self.headers:
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
            [nvcc_path(), *NVCC_FLAGS, *self.flags, "-o", tmp,
             str(CSRC / self.source)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        return proc, tmp, out

    def _bind(self) -> None:
        lib = ctypes.CDLL(str(self.library_path()))
        fn = getattr(lib, self.symbol)
        fn.argtypes = list(self.argtypes)
        fn.restype = ctypes.c_int
        smem = None
        if self.smem_argtypes is not None:
            smem = getattr(lib, self.symbol + "_smem_bytes")
            smem.argtypes = list(self.smem_argtypes)
            smem.restype = ctypes.c_size_t
        self._lib, self._fn, self._smem = lib, fn, smem
        self.binds += 1

    def function(self):
        """The bound C entry point.  The first use of any kernel builds
        every kernel of ``KERNELS``, one ``nvcc`` each, in parallel."""
        if self._fn is None:
            build_all(KERNELS)
        return self._fn

    def smem_bytes(self, *dims: int, resident: bool = True) -> int:
        """Shared memory one thread block needs at these dimensions, in the
        resident layout or in the device-memory one."""
        self.function()
        return int(self._smem(*dims, int(resident)))

    def resident(self, what: str, *dims: int) -> bool:
        """The layout a launch at these dimensions takes: True (the
        design's weights, and the fire kernels' integer grid, in shared
        memory) wherever that fits in what a block may use on an H100, else
        False (in device memory).  Raises ValueError when neither fits."""
        if self.smem_bytes(*dims) <= MAX_SMEM_BYTES:
            return True
        smem = self.smem_bytes(*dims, resident=False)
        if smem > MAX_SMEM_BYTES:
            raise ValueError(
                f"{self.name}: {what} needs {smem} B of shared memory even "
                f"with its weights in device memory (at most {MAX_SMEM_BYTES})"
            )
        return False


def grid_workspace(w: torch.Tensor, resident: bool) -> Optional[torch.Tensor]:
    """The integer fire grid's workspace of the device-memory layout (the
    shape of ``w``) of ``rnl_fire`` and ``fire_block``;
    None when the kernel keeps the grid in shared memory."""
    return None if resident else torch.empty_like(w)


def ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    """A tensor's device pointer for ctypes, None (NULL) for no tensor."""
    return None if t is None else t.data_ptr()


def _finish(kernel: CudaKernel, started) -> None:
    proc, tmp, out = started
    log, _ = proc.communicate()
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(
            f"nvcc failed on {kernel.source} (exit {proc.returncode}):\n{log}"
        )
    kernel.ptxas_log = log
    kernel.builds += 1
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
    argtypes=(_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I,
              _I, _F, _P),
    replaces="src/repro/kernels/fused_column.py:468 _fused_kernel",
    smem_argtypes=(_I, _I, _I, _I),  # p, q, t_window, resident
)

RNL_FIRE = CudaKernel(
    name="rnl_fire",
    source="rnl_fire.cu",
    symbol="tnn_rnl_fire",
    argtypes=(_P, _P, _P, _I, _I, _P, _I, _I, _I, _F, _I, _I, _P),
    replaces="src/repro/kernels/rnl_response.py:49 _rnl_kernel",
    smem_argtypes=(_I, _I, _I, _I),  # p, q, t_max, resident
)

FUSED_BLOCK = CudaKernel(
    name="fused_block",
    source="fused_block.cu",
    symbol="tnn_fused_block",
    argtypes=(_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I,
              _F, _P),
    replaces="src/repro/kernels/fused_column.py:596 _fused_block_kernel",
    smem_argtypes=(_I, _I, _I, _I, _I),  # p, q, v_blk, t_window, resident
)

FIRE_BLOCK = CudaKernel(
    name="fire_block",
    source="fire_block.cu",
    symbol="tnn_fire_block",
    argtypes=(_P, _P, _P, _P, _I, _I, _P, _I, _I, _I, _I, _I, _I, _P),
    replaces="src/repro/kernels/fused_column.py:1019 _fire_block_kernel",
    smem_argtypes=(_I, _I, _I, _I),  # p, q, t_window, resident
)

FIRE_FLOAT = CudaKernel(
    name="fire_float",
    source="fire_float.cu",
    symbol="tnn_fire_float",
    argtypes=(_P, _P, _P, _I, _I, _P, _I, _I, _I, _I, _I, _P),
    replaces="src/repro/kernels/fused_column.py:143 fire_dense_ref (the "
             "reference fire of assign_padded, :1082)",
    smem_argtypes=(_I, _I, _I, _I),  # p, q, t_window, resident
)

STDP_UPDATE = CudaKernel(
    name="stdp_update",
    source="stdp_update.cu",
    symbol="tnn_stdp_update",
    argtypes=(_P, _P, _P, _P, _I, _I, _F, _F, _F, _F, _I, _I, _F, _I, _I, _P),
    replaces="src/repro/kernels/stdp_update.py:28 _stdp_kernel",
)

# no bit parity to keep (a tolerance, see kernels/flash_attention.py), so
# nvcc may contract multiply-adds
FLASH_ATTENTION = CudaKernel(
    name="flash_attention",
    source="flash_attention.cu",
    symbol="flash_attention",
    argtypes=(_P, _P, _P, _P, _I, _I, _I, _P, _I, _I, _I, _I, _I, _I, _I, _F, _P),
    replaces="src/repro/kernels/flash_attention.py:29 _flash_kernel",
    flags=(),
    headers=(),
)

# a kernel for a jnp path of the JAX package (no bit parity: a tolerance,
# see kernels/ssd_scan.py); its own roundings are explicit _rn intrinsics
SSD_SCAN = CudaKernel(
    name="ssd_scan",
    source="ssd_scan.cu",
    symbol="ssd_scan",
    argtypes=(_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I)
    + (_L,) * 12 + (_I, _P),
    replaces="none: src/repro/models/ssm.py ssd_chunked is jnp (no pallas_call)",
    flags=(),
    headers=(),
)

# a kernel for a jnp path of the JAX package, bit-equal to its plain
# version: its taps are explicit _rn intrinsics, and its SiLU is compiled
# under nvcc's default flags, as PyTorch's silu is
CAUSAL_CONV = CudaKernel(
    name="causal_conv",
    source="causal_conv.cu",
    symbol="causal_conv",
    argtypes=(_P, _P, _P, _P, _P, _P, _I, _I, _I, _L, _L, _I, _I, _P),
    replaces="none: src/repro/models/ssm.py _causal_conv is jnp (no pallas_call)",
    flags=(),
    headers=(),
)

# a kernel for a jnp path of the JAX package: its conv step, step sizes and
# state update are bit-equal to its plain version (explicit _rn intrinsics,
# addcmul's FMA; SiLU, softplus and exp as ATen writes them, under nvcc's
# default flags), its y and norm within a bound (kernels/ssm_step.py); one
# call is two launches
SSM_STEP = CudaKernel(
    name="ssm_step",
    source="ssm_step.cu",
    symbol="ssm_step",
    argtypes=(_P,) * 14 + (_I, _L) + (_I,) * 5 + (_F, _I, _I, _F, _I, _P),
    replaces="none: src/repro/models/ssm.py runs a decode token as a jnp chunk of one",
    flags=(),
    headers=(),
)

KERNELS = (FUSED_STEP, RNL_FIRE, FUSED_BLOCK, FIRE_BLOCK, FIRE_FLOAT,
           STDP_UPDATE, FLASH_ATTENTION, SSD_SCAN, CAUSAL_CONV, SSM_STEP)

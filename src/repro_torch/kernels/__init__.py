# Hand-written Hopper kernels for the TNN column hot spots, each beside its
# plain PyTorch version:
#   fused_column — the training hot path: RNL fire + k-WTA + expected STDP
#                  for one volley in ONE kernel (csrc/fused_step.cu)
#   rnl_response — batched RNL firing times (csrc/rnl_fire.cu)
# ref.py holds the plain oracles; build.py compiles csrc/ with nvcc at
# first use and binds it with ctypes.  Importing this package builds
# nothing.
from repro_torch.kernels import build, fused_column, ops, ref, rnl_response  # noqa: F401

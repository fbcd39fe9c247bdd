# Hand-written Hopper kernels for the TNN column hot spots, each beside its
# plain PyTorch version:
#   fused_column — the training hot path: RNL fire + k-WTA + expected STDP
#                  for a whole single-column fit in ONE launch
#                  (csrc/fused_step.cu), for a block of volleys of the
#                  padded sweep (csrc/fused_block.cu), and the padded
#                  sweep's batched assignment fire (csrc/fire_block.cu)
#   rnl_response — batched RNL firing times (csrc/rnl_fire.cu)
#   stdp_update  — the expected STDP update of one volley (csrc/stdp_update.cu)
#   flash_attention — the LM's prefill attention (csrc/flash_attention.cu);
#                  imported by models.layers, not here, so that importing
#                  the TNN kernels does not import the LM
#   ssd_scan     — the SSM prefill's chunked SSD scan (csrc/ssd_scan.cu);
#                  imported by models.ssm, not here, for the same reason
#   causal_conv  — the SSM prefill's causal conv, bias and SiLU
#                  (csrc/causal_conv.cu); imported by models.ssm too
#   ssm_step     — the SSM decode step's mixer up to out_proj's input
#                  (csrc/ssm_step.cu); imported by models.ssm too
#   ops          — the public entry points: column_forward, rnl_fire,
#                  stdp_step, train_volleys
# ref.py holds the plain oracles; build.py compiles csrc/ with nvcc at
# first use and binds it with ctypes.  Importing this package builds
# nothing.
from repro_torch.kernels import (  # noqa: F401
    build, fused_column, ops, ref, rnl_response, stdp_update,
)
from repro_torch.kernels.ops import (  # noqa: F401
    column_forward, rnl_fire, stdp_step, train_volleys,
)

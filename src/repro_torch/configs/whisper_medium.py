"""Whisper-medium backbone (arXiv:2212.04356): encoder-decoder transformer.

24 encoder + 24 decoder layers, d_model 1024, 16 heads (kv=16), d_ff 4096,
vocab 51865.  The conv frontend is a stub: callers pass precomputed frame
embeddings [B, 1500, 1024] (``launch.serve`` passes zeros).
"""
from repro_torch.models.config import ArchConfig

ARCH_ID = "whisper-medium"


def full() -> ArchConfig:
    return ArchConfig(
        name=ARCH_ID, family="audio",
        n_layers=24, enc_layers=24, encoder_decoder=True, enc_seq=1500,
        d_model=1024, n_heads=16, n_kv_heads=16, d_head=64,
        d_ff=4096, vocab_size=51865, remat="full",
    )


def smoke() -> ArchConfig:
    return ArchConfig(
        name=ARCH_ID + "-smoke", family="audio",
        n_layers=2, enc_layers=2, encoder_decoder=True, enc_seq=16,
        d_model=64, n_heads=4, n_kv_heads=4, d_head=16,
        d_ff=128, vocab_size=256, dtype="float32", kv_chunk=16,
    )

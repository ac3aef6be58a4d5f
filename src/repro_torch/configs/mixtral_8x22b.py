"""Mixtral-8x22B [arXiv:2401.04088] (counterpart:
``src/repro/configs/mixtral_8x22b.py``).

8 experts, top-2 routing, sliding-window attention (every layer) — SWA makes
the arch sub-quadratic, so it runs long_500k.  56L · d_model 6144 · 48H
(GQA kv=8) · d_ff 16384 · vocab 32768.
"""
from repro_torch.models.config import ArchConfig, BlockKind

FULL = ArchConfig(
    name="mixtral-8x22b",
    num_layers=56,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    d_ff=16384,
    vocab_size=32_768,
    pattern=(BlockKind.ATTN_LOCAL,),
    window=4096,
    num_experts=8,
    top_k=2,
    source="arXiv:2401.04088",
)

SMOKE = FULL.scaled(
    num_layers=2, d_model=128, num_heads=4, num_kv_heads=2, d_ff=256,
    vocab_size=512, num_experts=4, window=32, q_chunk=64,
    max_seq_len=512, dtype="float32", remat=False,
)

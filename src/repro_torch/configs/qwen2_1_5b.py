"""Qwen2-1.5B [arXiv:2407.10671] (counterpart: ``src/repro/configs/qwen2_1_5b.py``).

Dense GQA decoder with QKV bias.  28L · d_model 1536 · 12H (GQA kv=2) ·
d_ff 8960 · vocab 151936.  Full attention → long_500k skipped.
"""
from repro_torch.models.config import ArchConfig, BlockKind

FULL = ArchConfig(
    name="qwen2-1.5b",
    num_layers=28,
    d_model=1536,
    num_heads=12,
    num_kv_heads=2,
    d_ff=8960,
    vocab_size=151_936,
    pattern=(BlockKind.ATTN,),
    qkv_bias=True,
    source="arXiv:2407.10671",
)

SMOKE = FULL.scaled(
    num_layers=2, d_model=128, num_heads=4, num_kv_heads=2, d_ff=256,
    vocab_size=512, q_chunk=64, max_seq_len=512, dtype="float32", remat=False,
)

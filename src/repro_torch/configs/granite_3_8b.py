"""Granite-3 8B [hf:ibm-granite/granite-3.0-2b-base family, 8B point]
(counterpart: ``src/repro/configs/granite_3_8b.py``).

Dense GQA decoder: 40L · d_model 4096 · 32H (GQA kv=8) · d_ff 12800 ·
vocab 49155.  Pure full attention → long_500k skipped.
"""
from repro_torch.models.config import ArchConfig, BlockKind

FULL = ArchConfig(
    name="granite-3-8b",
    num_layers=40,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=12800,
    vocab_size=49_155,
    pattern=(BlockKind.ATTN,),
    source="hf:ibm-granite/granite-3.0-2b-base",
)

SMOKE = FULL.scaled(
    num_layers=2, d_model=128, num_heads=4, num_kv_heads=2, d_ff=256,
    vocab_size=512, q_chunk=64, max_seq_len=512, dtype="float32", remat=False,
)

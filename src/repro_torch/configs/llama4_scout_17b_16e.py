"""Llama-4-Scout-17B-16E [hf:meta-llama/Llama-4-Scout-17B-16E] (counterpart:
``src/repro/configs/llama4_scout_17b_16e.py``).

MoE: 16 experts, top-1 routing, plus a shared expert.  Attention is the
iRoPE interleave — 3 chunked-local (RoPE) layers per 1 global NoPE layer —
which is Llama 4's documented long-context recipe, so this arch *runs*
long_500k.  48L · d_model 5120 · 40H (GQA kv=8) · d_ff 8192 · vocab 202048.
"""
from repro_torch.models.config import ArchConfig, BlockKind

FULL = ArchConfig(
    name="llama4-scout-17b-16e",
    num_layers=48,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    d_ff=8192,
    vocab_size=202_048,
    pattern=(BlockKind.ATTN_CHUNKED, BlockKind.ATTN_CHUNKED,
             BlockKind.ATTN_CHUNKED, BlockKind.ATTN_NOPE),
    attn_chunk=8192,
    num_experts=16,
    top_k=1,
    shared_expert=True,
    source="hf:meta-llama/Llama-4-Scout-17B-16E",
)

SMOKE = FULL.scaled(
    num_layers=4, d_model=128, num_heads=4, num_kv_heads=2, d_ff=256,
    vocab_size=512, num_experts=4, attn_chunk=64, q_chunk=64,
    max_seq_len=512, dtype="float32", remat=False,
)

"""Qwen1.5-32B [hf:Qwen/Qwen1.5-0.5B family, 32B point]
(counterpart: ``src/repro/configs/qwen1_5_32b.py``).

Dense decoder with QKV bias and kv=40 (MHA-like: every q head has its own kv
head).  64L · d_model 5120 · 40H (kv=40) · d_ff 27392 · vocab 152064.
Full attention → long_500k skipped.  Its bf16 weights (≈ 69 GB) do not fit
one 80 GB card beside a cache, so on the card it is served with
``quantize="int8"``, which ``init_model`` applies to each layer as it is
drawn.
"""
from repro_torch.models.config import ArchConfig, BlockKind

FULL = ArchConfig(
    name="qwen1.5-32b",
    num_layers=64,
    d_model=5120,
    num_heads=40,
    num_kv_heads=40,
    d_ff=27392,
    vocab_size=152_064,
    pattern=(BlockKind.ATTN,),
    qkv_bias=True,
    source="hf:Qwen/Qwen1.5-0.5B",
)

SMOKE = FULL.scaled(
    num_layers=2, d_model=128, num_heads=4, num_kv_heads=4, d_ff=256,
    vocab_size=512, q_chunk=64, max_seq_len=512, dtype="float32", remat=False,
)

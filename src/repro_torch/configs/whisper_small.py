"""Whisper-small [arXiv:2212.04356] (counterpart:
``src/repro/configs/whisper_small.py``).

Encoder–decoder: 12L encoder over 1500 precomputed mel/conv frame embeddings
(the conv frontend is a stub, as in the reference: the caller supplies
(B, 1500, 768) frames), 12L decoder with cross-attention, LayerNorm, GELU
MLP, learned (decoder) and sinusoidal (encoder) absolute positions, no
RoPE.  d_model 768 · 12H (kv=12, i.e. MHA) · d_ff 3072 · vocab 51865.
"""
from repro_torch.models.config import ArchConfig, BlockKind

FULL = ArchConfig(
    name="whisper-small",
    num_layers=12,
    d_model=768,
    num_heads=12,
    num_kv_heads=12,
    d_ff=3072,
    vocab_size=51_865,
    pattern=(BlockKind.ATTN,),
    encoder_layers=12,
    encoder_seq=1500,
    cross_attention=True,
    mlp_kind="gelu",
    norm_kind="layernorm",
    use_rope=False,
    learned_pos=True,
    max_seq_len=448,
    source="arXiv:2212.04356",
)

SMOKE = FULL.scaled(
    num_layers=2, d_model=128, num_heads=4, num_kv_heads=4, d_ff=256,
    vocab_size=512, encoder_layers=2, encoder_seq=64, q_chunk=64,
    max_seq_len=128, dtype="float32", remat=False,
)

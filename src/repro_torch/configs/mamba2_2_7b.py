"""Mamba-2 2.7B [arXiv:2405.21060] (counterpart: ``src/repro/configs/mamba2_2_7b.py``).

Attention-free SSM using SSD (state-space duality): the chunked dual form
for prefill (kernel ``ssd_chunk_scan``), the O(1) recurrent state for
decode.  64L · d_model 2560 · no MLP · vocab 50280 · ssm_state N=128 ·
head_dim P=64 · expand 2 (d_inner 5120, 80 SSD heads) · chunk 256.
"""
from repro_torch.models.config import ArchConfig, BlockKind

FULL = ArchConfig(
    name="mamba2-2.7b",
    num_layers=64,
    d_model=2560,
    num_heads=0,
    num_kv_heads=0,
    d_ff=0,
    vocab_size=50_280,
    pattern=(BlockKind.SSD,),
    mlp_kind="none",
    ssm_state=128,
    ssd_head_dim=64,
    ssd_expand=2,
    ssd_chunk=256,
    use_rope=False,
    source="arXiv:2405.21060",
)

SMOKE = FULL.scaled(
    num_layers=2, d_model=128, num_heads=0, num_kv_heads=0, d_ff=0,
    vocab_size=512, ssm_state=16, ssd_head_dim=16, ssd_chunk=32,
    max_seq_len=512, dtype="float32", remat=False,
)

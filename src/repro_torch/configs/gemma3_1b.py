"""Gemma-3 1B [hf:google/gemma-3-1b-pt] (counterpart: ``src/repro/configs/gemma3_1b.py``).

Dense with a 5:1 local:global attention interleave: sliding-window layers
keep a ring cache of ``window`` slots, and every 6th layer attends
globally.  The assigned depth 26 is not a multiple of the 6-layer (5L+1G)
period; the reference encodes the same cadence as a 13-layer period —
kind(i) = ATTN if i % 6 == 5 else ATTN_LOCAL — giving globals at layers 6,
12, 19, 25 of 26.  d_model 1152 · 4H (GQA kv=1, head_dim 256) · d_ff 6912 ·
vocab 262144 · window 512.  As in the reference: a SwiGLU MLP, plain
RMSNorm, one ``rope_base``, no QK-norm, no sandwich norms and no embedding
scale (the published block has them).
"""
from repro_torch.models.config import ArchConfig, BlockKind

_PERIOD = tuple(
    BlockKind.ATTN if i % 6 == 5 else BlockKind.ATTN_LOCAL for i in range(13)
)

FULL = ArchConfig(
    name="gemma3-1b",
    num_layers=26,
    d_model=1152,
    num_heads=4,
    num_kv_heads=1,
    d_ff=6912,
    vocab_size=262_144,
    head_dim=256,
    pattern=_PERIOD,
    probe_pattern=tuple(
        BlockKind.ATTN if i % 6 == 5 else BlockKind.ATTN_LOCAL
        for i in range(6)),
    window=512,
    rope_base=1_000_000.0,
    source="hf:google/gemma-3-1b-pt",
)

SMOKE = FULL.scaled(
    num_layers=2, d_model=128, num_heads=4, num_kv_heads=1, d_ff=256,
    vocab_size=512, head_dim=32, window=32, q_chunk=64, max_seq_len=512,
    dtype="float32", remat=False,
    pattern=(BlockKind.ATTN_LOCAL, BlockKind.ATTN),
)

"""LLaVA-NeXT 34B [hf:llava-hf/llava-v1.6-mistral-7b-hf family, 34B point]
(counterpart: ``src/repro/configs/llava_next_34b.py``).

VLM: the vision tower and the anyres tiling projector are a stub, as in the
reference: the caller supplies (B, 2880, d_model) patch embeddings (5
anyres tiles × 576 patches), which are put before the text tokens.
Language backbone: dense 60L · d_model 7168 · 56H (GQA kv=8) · d_ff 20480 ·
vocab 64000.  Full attention → long_500k skipped.
"""
from repro_torch.models.config import ArchConfig, BlockKind

FULL = ArchConfig(
    name="llava-next-34b",
    num_layers=60,
    d_model=7168,
    num_heads=56,
    num_kv_heads=8,
    d_ff=20480,
    vocab_size=64_000,
    pattern=(BlockKind.ATTN,),
    vision_tokens=2880,           # 5 anyres tiles x 576 patches
    source="hf:llava-hf/llava-v1.6-mistral-7b-hf",
)

SMOKE = FULL.scaled(
    num_layers=2, d_model=128, num_heads=4, num_kv_heads=2, d_ff=256,
    vocab_size=512, vision_tokens=16, q_chunk=64, max_seq_len=512,
    dtype="float32", remat=False,
)

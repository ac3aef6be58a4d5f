"""RecurrentGemma-9B (Griffin) [arXiv:2402.19427]
(counterpart: ``src/repro/configs/recurrentgemma_9b.py``).

Hybrid: RG-LRU recurrent blocks interleaved with local (sliding-window)
attention at 1 attention : 2 recurrent.  The assigned depth is 38, which a
pure (R,R,A) period cannot tile (38 % 3 ≠ 0); the reference encodes the
same cadence as a 19-layer period — kind(i) = ATTN_LOCAL if i % 3 == 2 else
RGLRU — i.e. the RRA cycle with one extra R per 19 layers (12 A + 26 R over
the full 38).  d_model 4096 · 16H (GQA kv=1 for the local attention, head
dim 256) · d_ff 12288 · vocab 256000 · rnn width 4096 · window 2048.  Every
block, recurrent or attention, is followed by its MLP.  Its recurrent
blocks prefill per request (a recurrent state would absorb a pad tail).
"""
from repro_torch.models.config import ArchConfig, BlockKind

_PERIOD = tuple(
    BlockKind.ATTN_LOCAL if i % 3 == 2 else BlockKind.RGLRU for i in range(19)
)

FULL = ArchConfig(
    name="recurrentgemma-9b",
    num_layers=38,
    d_model=4096,
    num_heads=16,
    num_kv_heads=1,
    d_ff=12288,
    vocab_size=256_000,
    pattern=_PERIOD,
    probe_pattern=(BlockKind.RGLRU, BlockKind.RGLRU, BlockKind.ATTN_LOCAL),
    window=2048,
    rnn_width=4096,
    conv_width=4,
    source="arXiv:2402.19427",
)

SMOKE = FULL.scaled(
    num_layers=3, d_model=128, num_heads=4, num_kv_heads=1, d_ff=256,
    vocab_size=512, rnn_width=128, window=32, q_chunk=64, max_seq_len=512,
    dtype="float32", remat=False,
    pattern=(BlockKind.RGLRU, BlockKind.RGLRU, BlockKind.ATTN_LOCAL),
)

"""Architecture configuration (counterpart: ``src/repro/models/config.py``,
copied as it is: the module is a plain dataclass).

One ``ArchConfig`` drives the whole zoo: the decoder (and optional encoder)
stack is a repeated *period* of blocks (``pattern``), which expresses the
assigned architectures' layer interleavings:

    dense GQA            pattern=[ATTN]
    gemma3 5:1 local     pattern=[ATTN_LOCAL]*5 + [ATTN]
    llama4 3:1 chunked   pattern=[ATTN_CHUNKED]*3 + [ATTN_NOPE]   (iRoPE)
    recurrentgemma 1:2   pattern=[RGLRU, RGLRU, ATTN_LOCAL]       (Griffin)
    mamba2               pattern=[SSD]
    whisper              decoder pattern=[ATTN] + cross-attention, encoder stack

Every block is followed by its MLP (dense or MoE) except SSD blocks, which
are self-contained (mamba2 has no MLP: d_ff=0).  RG-LRU blocks have their
MLP too: the reference's code gives it them
(``src/repro/models/transformer.py:70-74``, ``:237-240``), although its copy
of this docstring says they are self-contained.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Optional, Tuple

__all__ = ["BlockKind", "ArchConfig"]


class BlockKind(str, enum.Enum):
    ATTN = "attn"                  # global causal attention (RoPE unless nope)
    ATTN_LOCAL = "attn_local"      # sliding-window attention
    ATTN_CHUNKED = "attn_chunked"  # llama4-style chunked local attention
    ATTN_NOPE = "attn_nope"        # global attention, no positional encoding
    RGLRU = "rglru"                # RecurrentGemma RG-LRU recurrent block
    SSD = "ssd"                    # Mamba-2 state-space duality block


ATTENTION_KINDS = (BlockKind.ATTN, BlockKind.ATTN_LOCAL,
                   BlockKind.ATTN_CHUNKED, BlockKind.ATTN_NOPE)


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None          # default d_model // num_heads

    # stack pattern (one period; layers = periods * len(pattern))
    pattern: Tuple[BlockKind, ...] = (BlockKind.ATTN,)
    # reduced same-mix pattern for the dry-run cost probes (archs whose
    # period is too long to unroll twice, e.g. recurrentgemma's 19);
    # None → probe with the full pattern
    probe_pattern: Optional[Tuple[BlockKind, ...]] = None

    # attention details
    window: int = 4096                      # for ATTN_LOCAL
    attn_chunk: int = 8192                  # for ATTN_CHUNKED
    qkv_bias: bool = False                  # qwen-style
    rope_base: float = 10000.0
    causal: bool = True

    # MLP / MoE
    mlp_kind: str = "swiglu"                # "swiglu" | "gelu" | "none"
    num_experts: int = 0                    # 0 == dense MLP
    top_k: int = 1
    capacity_factor: float = 1.25
    shared_expert: bool = False             # llama4 has a shared expert
    router_aux_weight: float = 0.01         # load-balance loss weight
    moe_dispatch: str = "einsum"            # "einsum" (one-hot dispatch
    #   tensors, GSPMD all-to-all friendly) | "gather" (§Perf: sort-based
    #   index dispatch, no (g,s,E,C) blowup — O(tokens·d) traffic)

    # recurrent / ssm
    rnn_width: Optional[int] = None         # RG-LRU recurrence width
    conv_width: int = 4
    ssm_state: int = 128                    # mamba2 N
    ssd_head_dim: int = 64                  # mamba2 P
    ssd_expand: int = 2
    ssd_chunk: int = 256

    # encoder-decoder (whisper)
    encoder_layers: int = 0
    encoder_seq: int = 1500                 # whisper 30s → 1500 frames
    cross_attention: bool = False

    # multimodal stub frontend
    vision_tokens: int = 0                  # llava: patch embeddings prepended

    # norms / embeddings
    norm_kind: str = "rmsnorm"              # "rmsnorm" | "layernorm" (whisper)
    use_rope: bool = True                   # False → absolute positions
    learned_pos: bool = False               # whisper decoder learned pos table
    norm_eps: float = 1e-6
    tie_embeddings: bool = True
    max_seq_len: int = 524288

    # numerics & perf knobs
    dtype: str = "bfloat16"                 # activation / param dtype
    remat: bool = True
    unroll_periods: bool = False            # Python-loop the period stack
    loss_vocab_chunk: Optional[int] = None  # chunked streaming xent (§Perf):
    #   never materialize (tokens, V) logits in training; value = vocab chunk
    #   (dry-run probes: XLA's cost_analysis counts a lax.scan body ONCE
    #    regardless of trip count, so the roofline extrapolates from two
    #    unrolled shallow probes; see launch/dryrun.py)
    q_chunk: int = 1024                     # q-block size for chunked attention scan
    use_flash_kernel: bool = False          # never read (as in the reference);
    #   the port's attention always goes through its flash kernel
    cache_dtype: str = "bfloat16"           # "int8" enables quantized KV cache
    quantize: str = "none"                  # weight quantization for serving:
    #   "none" | "bf16" (cast float params) | "int8" (symmetric per-channel
    #   attention/MLP projections via models.layers.quant, served through the
    #   quant_matmul CUDA kernel)

    # provenance
    source: str = ""

    def __post_init__(self):
        if self.num_layers % len(self.pattern) != 0:
            raise ValueError(
                f"{self.name}: num_layers {self.num_layers} not divisible by "
                f"pattern period {len(self.pattern)}"
            )
        if self.num_heads and self.num_heads % max(self.num_kv_heads, 1) != 0:
            raise ValueError(f"{self.name}: heads must divide into kv groups")
        if self.quantize not in ("none", "bf16", "int8"):
            raise ValueError(
                f"{self.name}: quantize={self.quantize!r} (want none|bf16|int8)")

    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim is not None:
            return self.head_dim
        return self.d_model // self.num_heads

    @property
    def num_periods(self) -> int:
        return self.num_layers // len(self.pattern)

    @property
    def is_attention_free(self) -> bool:
        return all(b in (BlockKind.SSD, BlockKind.RGLRU) for b in self.pattern)

    @property
    def sub_quadratic(self) -> bool:
        """True iff no block attends globally with RoPE-free unbounded span —
        i.e. the arch can run long_500k."""
        full = (BlockKind.ATTN, BlockKind.ATTN_NOPE)
        # chunked/local/global-NoPE mixes still qualify if *most* layers are
        # bounded; llama4/gemma3 style interleaves are their documented
        # long-context recipe.  Pure full-attention stacks do not qualify.
        return any(b not in full for b in self.pattern)

    @property
    def d_inner_ssd(self) -> int:
        return self.ssd_expand * self.d_model

    @property
    def ssd_heads(self) -> int:
        return self.d_inner_ssd // self.ssd_head_dim

    def scaled(self, *, num_layers=None, d_model=None, num_heads=None,
               num_kv_heads=None, d_ff=None, vocab_size=None, num_experts=None,
               **kw) -> "ArchConfig":
        """Reduced variant of the same family (for CPU smoke tests)."""
        updates = dict(
            num_layers=num_layers or self.num_layers,
            d_model=d_model or self.d_model,
            num_heads=num_heads or self.num_heads,
            num_kv_heads=num_kv_heads or self.num_kv_heads,
            d_ff=d_ff if d_ff is not None else self.d_ff,
            vocab_size=vocab_size or self.vocab_size,
        )
        if num_experts is not None:
            updates["num_experts"] = num_experts
        updates.update(kw)
        if d_model and self.head_dim is not None and "head_dim" not in kw:
            updates["head_dim"] = max(8, d_model // max(updates.get("num_heads") or 1, 1))
        if d_model and self.rnn_width is not None and "rnn_width" not in kw:
            updates["rnn_width"] = updates["d_model"]
        return dataclasses.replace(self, **updates)

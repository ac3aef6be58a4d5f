"""Transformer stack driven by ArchConfig (counterpart:
``src/repro/models/transformer.py``).

The decoder is ``num_periods`` repetitions of the config's block
*pattern*; each pattern position's parameters are stacked on a leading
layer axis, as in the reference, and a Python loop over that axis takes the
place of its ``lax.scan``.  Per-period caches are stacked the same way and
written in place through per-layer views.  ``remat`` and
``unroll_periods`` have no meaning in eager PyTorch and are not read.

Public entry points:

    init_model(gen, cfg)                 -> params
    TransformerLM.encode(...)            -> encoder output    [whisper]
    TransformerLM.forward(...)           -> logits, aux
    TransformerLM.prefill(...)           -> logits, cache
    TransformerLM.prefill_ragged(...)    -> logits, cache
    TransformerLM.decode_step(...)       -> logits, cache   [1 token]
    TransformerLM.init_cache(...)        -> cache

The port runs decoders whose pattern entries are ``ATTENTION_KINDS``
(with a dense MLP, or none), Mamba-2 SSD blocks (``ssd.py``, no MLP) and
Griffin's RG-LRU blocks (``rglru.py``, each with its MLP, as the
reference's code has it); Whisper's encoder-decoder (``encode`` over
precomputed frame embeddings with sinusoidal positions, a bidirectional
stack, and cross-attention in every decoder block, its K/V cached at the
prefill; a learned position table in the decoder); and LLaVA's stubbed
vision frontend (``vision_embeds=`` put before the text); and the MoE
decoders (``moe.py`` in place of an attention block's MLP), whose ``aux``
losses ``forward`` sums over the layers in layer order.  At a decode step
an MoE block's norm is applied by the ``rmsnorm`` kernel, not folded into
a product, since the router and the dispatch both read it.
``prefill_ragged`` serves attention-only dense text-only stacks alone: a
recurrent state would absorb the pad tail, a vision prefix or an
encoder's memory is not a padded prompt, and an MoE group's capacity
would count the pad tokens, so those stacks prefill per request (the
serving engine picks the path).

``init_model`` draws one block at a time and writes it into the stacked
tree (``models/params.py``'s ``LayerStack``).  It quantizes each block as
``cfg.quantize`` says as it is drawn, before the next one is drawn, so the
tree is bitwise the plain tree of the same draws put through
``quantize_model_params`` (the generator is consumed in the same order)
and a model whose bf16 weights do not fit the card (Qwen1.5-32B's ≈ 69 GB)
never holds more than one block of them beside the stack (a period of
Llama4's would be four MoE layers, ≈ 17 GB).  The encoder is drawn the
same way, a layer at a time, after the decoder.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.config import ATTENTION_KINDS, ArchConfig, BlockKind
from repro_torch.models.layers.attention import attn_apply, attn_init, init_kv_cache
from repro_torch.models.layers.embedding import (embed_init, embed_tokens, logits_from,
                                                 sinusoidal_positions)
from repro_torch.models.layers.mlp import mlp_apply, mlp_init
from repro_torch.models.layers.moe import moe_apply, moe_init
from repro_torch.models.layers.norms import (PreNorm, layernorm, layernorm_init, rmsnorm,
                                             rmsnorm_init)
from repro_torch.models.layers.quant import (QTensor, _quantize_period,
                                             quantize_model_params)
from repro_torch.models.layers.rglru import init_rglru_cache, rglru_apply, rglru_init
from repro_torch.models.layers.ssd import init_ssd_cache, ssd_apply, ssd_init
from repro_torch.models.params import LayerStack, projection_layout

__all__ = ["init_model", "TransformerLM", "layer_slice"]


def _dtype(cfg: ArchConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def _norm_init(cfg: ArchConfig, dtype, device):
    return rmsnorm_init(cfg.d_model, dtype, device) if cfg.norm_kind == "rmsnorm" \
        else layernorm_init(cfg.d_model, dtype, device)


def _norm_apply(cfg: ArchConfig, params, x):
    return rmsnorm(params, x, cfg.norm_eps) if cfg.norm_kind == "rmsnorm" \
        else layernorm(params, x, cfg.norm_eps)


def _pre_norm(cfg: ArchConfig, params, x, mode: str):
    """A block's norm in front of its layer: at a decode step an RMSNorm is
    handed over whole (``PreNorm``), for the layer's first products to fold
    into their launch; otherwise it is applied here."""
    if mode == "decode" and cfg.norm_kind == "rmsnorm":
        return PreNorm(x, params["scale"], cfg.norm_eps)
    return _norm_apply(cfg, params, x)


def layer_slice(tree, i: int):
    """Layer ``i`` of a tree stacked on a leading layer axis (views)."""
    if isinstance(tree, dict):
        return {k: layer_slice(v, i) for k, v in tree.items()}
    if isinstance(tree, QTensor):
        return tree.layer(i)
    return tree[i]


# --------------------------------------------------------------------------- #
# init
# --------------------------------------------------------------------------- #
def _block_init(gen: torch.Generator, cfg: ArchConfig, kind: BlockKind,
                dtype) -> Dict[str, Any]:
    dev = gen.device
    block: Dict[str, Any] = {"ln1": _norm_init(cfg, dtype, dev)}
    if kind == BlockKind.SSD:
        block["ssd"] = ssd_init(gen, cfg, dtype)
        return block
    if kind == BlockKind.RGLRU:
        block["rglru"] = rglru_init(gen, cfg, dtype)
    else:
        block["attn"] = attn_init(gen, cfg, dtype)
        if cfg.cross_attention:
            block["ln_cross"] = _norm_init(cfg, dtype, dev)
            block["cross"] = attn_init(gen, cfg, dtype, cross=True)
    if cfg.mlp_kind != "none":
        block["ln2"] = _norm_init(cfg, dtype, dev)
        if cfg.num_experts and kind != BlockKind.RGLRU:     # as the reference's
            block["moe"] = moe_init(gen, cfg, dtype)
        else:
            block["mlp"] = mlp_init(gen, cfg, dtype)
    return block


def _encoder_cfg(cfg: ArchConfig) -> ArchConfig:
    """The encoder's stack as the reference configures it: bidirectional
    attention blocks with the decoder's widths, norms and MLP."""
    return dataclasses.replace(cfg, causal=False, cross_attention=False, num_experts=0,
                               pattern=(BlockKind.ATTN,), num_layers=cfg.encoder_layers)


def _draw_stack(gen: torch.Generator, cfg: ArchConfig, dtype) -> Dict[str, Any]:
    """``cfg``'s blocks drawn one at a time in period order, each quantized
    as ``cfg.quantize`` says as soon as it is drawn and written into its
    layer of the stack."""
    on_card = gen.device.type == "cuda"
    stack = LayerStack(cfg.num_periods, projection_layout if on_card else None)
    for p in range(cfg.num_periods):
        for i, kind in enumerate(cfg.pattern):
            block = {f"b{i}": _block_init(gen, cfg, kind, dtype)}
            stack.add(p, _quantize_period(block, cfg.quantize))
            del block                # before the next block is drawn
    return stack.tree


def init_model(gen: torch.Generator, cfg: ArchConfig) -> Dict[str, Any]:
    """The param tree of ``cfg``, drawn from ``gen`` on ``gen``'s device,
    one block at a time.  The reference also returns logical sharding
    axes; the port has no mesh yet, so it returns the params alone.  On the
    card the plain projection weights are stacked in ``kernel_layout``
    (``models/params.py``), the storage the decode products read in place.
    Each block is quantized as ``cfg.quantize`` says as soon as it is
    drawn, so a model whose plain weights do not fit the card never holds
    them all; the tree is bitwise the plain tree of the same draws put
    through ``quantize_model_params(tree, cfg.quantize)``."""
    dtype = _dtype(cfg)
    params: Dict[str, Any] = {"embed": embed_init(gen, cfg, dtype)}
    params["blocks"] = _draw_stack(gen, cfg, dtype)
    params["final_norm"] = _norm_init(cfg, dtype, gen.device)
    if cfg.encoder_layers:
        params["encoder"] = {"blocks": _draw_stack(gen, _encoder_cfg(cfg), dtype),
                             "final_norm": _norm_init(cfg, dtype, gen.device)}
    # "bf16" casts the embedding and the final norm too; the blocks are done
    return quantize_model_params(params, cfg.quantize)


# --------------------------------------------------------------------------- #
# model
# --------------------------------------------------------------------------- #
class TransformerLM:
    """Stateless functional model bound to an ArchConfig; caches are made
    on ``device`` (the CUDA card unless ``device="cpu"``)."""

    def __init__(self, cfg: ArchConfig, device: DeviceLike = None):
        self.cfg = cfg
        self.device = resolve_device(device)

    # ---------------- caches ---------------- #
    def init_cache(self, batch: int, max_seq: int) -> Dict[str, Any]:
        """Per-period caches stacked on the layer axis; with
        cross-attention each attention block also holds its cross cache
        ``{"k", "v"}`` of (batch, encoder_seq, kv heads, hd), which a
        prefill with ``encoder_frames=`` fills."""
        cfg = self.cfg
        dtype = _dtype(cfg)

        def block_cache(kind: BlockKind):
            if kind == BlockKind.SSD:
                return {"ssd": init_ssd_cache(cfg, batch, dtype, self.device)}
            if kind == BlockKind.RGLRU:
                return {"rglru": init_rglru_cache(cfg, batch, dtype, self.device)}
            c = {"attn": init_kv_cache(cfg, kind, batch, max_seq, dtype, self.device)}
            if cfg.cross_attention:
                shape = (batch, cfg.encoder_seq, cfg.num_kv_heads, cfg.resolved_head_dim)
                c["cross"] = {"k": torch.zeros(shape, dtype=dtype, device=self.device),
                              "v": torch.zeros(shape, dtype=dtype, device=self.device)}
            return c

        stack = LayerStack(cfg.num_periods)
        for p in range(cfg.num_periods):
            stack.add(p, {f"b{i}": block_cache(kind) for i, kind in enumerate(cfg.pattern)})
        return stack.tree

    # ---------------- encoder ---------------- #
    def encode(self, params: Dict, frames: torch.Tensor) -> torch.Tensor:
        """Whisper's encoder over precomputed frame embeddings (B, Se, D)
        (the reference stubs the conv frontend): sinusoidal positions added
        in the frames' dtype, the bidirectional stack, the encoder's final
        norm."""
        cfg = self.cfg
        enc_cfg = _encoder_cfg(cfg)
        frames = torch.as_tensor(frames, device=self.device)
        x = frames + sinusoidal_positions(frames.shape[1], cfg.d_model, frames.dtype,
                                          self.device)[None]
        positions = torch.arange(x.shape[1], device=self.device)
        blocks = params["encoder"]["blocks"]
        for layer in range(cfg.encoder_layers):
            bp = layer_slice(blocks, layer)["b0"]
            h = _norm_apply(cfg, bp["ln1"], x)
            h, _ = attn_apply(bp["attn"], h, cfg=enc_cfg, kind=BlockKind.ATTN, mode="prefill",
                              positions=positions, use_rope=False)
            x = x + h
            x = x + mlp_apply(bp["mlp"], _norm_apply(cfg, bp["ln2"], x))
        return _norm_apply(cfg, params["encoder"]["final_norm"], x)

    # ---------------- block application ---------------- #
    def _apply_block(self, kind: BlockKind, bp: Dict, x, *, mode: str,
                     positions=None, pos=None, cache=None, lengths=None, memory=None,
                     start_pos=None):
        """The block's output and its MoE aux loss (None for a block
        without experts, and at a decode step)."""
        cfg = self.cfg
        h = _pre_norm(cfg, bp["ln1"], x, mode)
        if kind == BlockKind.SSD:
            h, _ = ssd_apply(bp["ssd"], h, cfg=cfg, mode=mode,
                             cache=None if cache is None else cache["ssd"])
            return x + h, None
        if kind == BlockKind.RGLRU:
            h, _ = rglru_apply(bp["rglru"], h, cfg=cfg, mode=mode,
                               cache=None if cache is None else cache["rglru"])
        else:
            h, _ = attn_apply(bp["attn"], h, cfg=cfg, kind=kind, mode=mode,
                              positions=positions, pos=pos,
                              cache=None if cache is None else cache["attn"],
                              use_rope=cfg.use_rope, lengths=lengths, start_pos=start_pos)
        x = x + h
        # cross-attention where there is a memory or a cross cache to read,
        # as the reference has it (a forward without frames skips it)
        if "cross" in bp and (memory is not None or (cache is not None and "cross" in cache)):
            h = _pre_norm(cfg, bp["ln_cross"], x, mode)
            h, _ = attn_apply(bp["cross"], h, cfg=cfg, kind=BlockKind.ATTN, mode=mode,
                              positions=positions, pos=pos,
                              cache=None if cache is None else cache["cross"],
                              kv_src=memory, is_cross=True, use_rope=False)
            x = x + h
        aux = None
        if "moe" in bp:
            # read twice (router and dispatch), so applied here, not folded
            h = _norm_apply(cfg, bp["ln2"], x)
            h, aux = moe_apply(bp["moe"], h, cfg, aux=mode != "decode")
            x = x + h
        elif "mlp" in bp:
            h = _pre_norm(cfg, bp["ln2"], x, mode)
            x = x + mlp_apply(bp["mlp"], h)
        return x, aux

    def _run_stack(self, params, x, *, mode, positions=None, pos=None,
                   cache=None, lengths=None, memory=None, start_pos=None):
        """The decoder's blocks in layer order: (x, the aux losses summed in
        layer order, cache)."""
        cfg = self.cfg
        aux_tot = torch.zeros((), dtype=torch.float32, device=x.device)
        for p in range(cfg.num_periods):
            pp = layer_slice(params["blocks"], p)
            pc = None if cache is None else layer_slice(cache, p)
            for i, kind in enumerate(cfg.pattern):
                x, aux = self._apply_block(
                    kind, pp[f"b{i}"], x, mode=mode, positions=positions,
                    pos=pos, cache=None if pc is None else pc[f"b{i}"],
                    lengths=lengths, memory=memory, start_pos=start_pos)
                if aux is not None:
                    aux_tot = aux_tot + aux
        return x, aux_tot, cache

    # ---------------- public entry points ---------------- #
    def forward(self, params: Dict, tokens: torch.Tensor, *,
                vision_embeds: Optional[torch.Tensor] = None,
                encoder_frames: Optional[torch.Tensor] = None,
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Full-sequence logits.  Returns (logits, aux)."""
        x, aux = self.forward_hidden(params, tokens, vision_embeds=vision_embeds,
                                     encoder_frames=encoder_frames)
        return logits_from(params["embed"], x), aux

    def _inputs(self, params, tokens, vision_embeds, encoder_frames):
        """The prompt's embeddings (learned positions added where the
        config has them, a vision prefix put before the text), their
        positions, and the encoder's memory (None without frames)."""
        tokens = torch.as_tensor(tokens, device=self.device)
        S = tokens.shape[1]
        x = embed_tokens(params["embed"], tokens, torch.arange(S) if self.cfg.learned_pos else None)
        if vision_embeds is not None:
            vision = torch.as_tensor(vision_embeds, device=self.device).to(x.dtype)
            x = torch.cat([vision, x], dim=1)
        memory = None if encoder_frames is None else self.encode(params, encoder_frames)
        return x, torch.arange(x.shape[1], device=self.device), memory

    def forward_hidden(self, params: Dict, tokens: torch.Tensor, *,
                       vision_embeds: Optional[torch.Tensor] = None,
                       encoder_frames: Optional[torch.Tensor] = None):
        """Forward up to the final norm, without the LM head."""
        x, positions, memory = self._inputs(params, tokens, vision_embeds, encoder_frames)
        x, aux, _ = self._run_stack(params, x, mode="prefill", positions=positions,
                                    memory=memory)
        return _norm_apply(self.cfg, params["final_norm"], x), aux

    def prefill(self, params: Dict, tokens: torch.Tensor, cache: Dict, *,
                vision_embeds: Optional[torch.Tensor] = None,
                encoder_frames: Optional[torch.Tensor] = None):
        """Runs the full prompt (after the vision prefix, if any), fills the
        cache (the cross caches from the encoder's output of
        ``encoder_frames``), returns (last-token logits, cache)."""
        x, positions, memory = self._inputs(params, tokens, vision_embeds, encoder_frames)
        x, _, cache = self._run_stack(params, x, mode="prefill", positions=positions,
                                      cache=cache, memory=memory)
        x = _norm_apply(self.cfg, params["final_norm"], x[:, -1:])
        return logits_from(params["embed"], x), cache

    def prefill_ragged(self, params: Dict, tokens: torch.Tensor,
                       lengths: torch.Tensor, cache: Dict, start_pos=None):
        """Mixed-length prefill for continuous batching: ``tokens`` is
        (B, S) with row b's prompt right-padded (real tokens in columns
        0..lengths[b]-1).  Causal masking keeps pad columns out of every
        real token's view, and the cache fill drops them, so each row's
        cache is what a lone batch-1 prefill would write.  Returns (per-row
        next-token logits (B, 1, V), cache).  Attention-only stacks alone:
        a recurrent state (SSD or RG-LRU h, conv taps) would absorb the pad tail, so
        those stacks raise the reference's ``ValueError`` and prefill per
        request instead.

        ``start_pos`` (B,) makes it a tail prefill (the prefix cache's): row
        b's tokens are its prompt's uncached suffix at positions
        ``start_pos[b] .. start_pos[b] + lengths[b] − 1``, over a cache
        whose rings already hold the prefix K/V; every attention layer runs
        kernel 6's tail form (``attn_apply(start_pos=)``), and a
        ``start_pos == 0`` row is a plain prefill."""
        cfg = self.cfg
        if any(k not in ATTENTION_KINDS for k in cfg.pattern):
            raise ValueError(f"{cfg.name}: prefill_ragged requires an "
                             "attention-only pattern (recurrent state would "
                             "absorb the pad tail)")
        if cfg.num_experts or cfg.cross_attention or cfg.vision_tokens:
            raise ValueError(f"{cfg.name}: prefill_ragged supports dense "
                             "text-only decoders")
        lengths = torch.as_tensor(lengths, device=self.device).long()
        if start_pos is None:
            x, positions, _ = self._inputs(params, tokens, None, None)
        else:
            tokens = torch.as_tensor(tokens, device=self.device)
            S = tokens.shape[1]
            start_pos = torch.as_tensor(start_pos).to(self.device)
            positions = torch.arange(S, device=self.device)
            emb_pos = (start_pos.long()[:, None] + positions[None, :]
                       if self.cfg.learned_pos else None)
            x = embed_tokens(params["embed"], tokens, emb_pos)
        x, _, cache = self._run_stack(params, x, mode="prefill",
                                      positions=positions, cache=cache,
                                      lengths=lengths, start_pos=start_pos)
        # each row's last real token (right-padding puts it at lengths-1),
        # then the norm and the LM head on (B, 1, D) only
        idx = (lengths - 1)[:, None, None].expand(-1, 1, x.shape[-1])
        x_last = _norm_apply(self.cfg, params["final_norm"], torch.gather(x, 1, idx))
        return logits_from(params["embed"], x_last), cache

    def decode_step(self, params: Dict, token: torch.Tensor, pos, cache: Dict):
        """One decode step.  token: (B, 1) int; pos: scalar (all rows at one
        position) or (B,) (continuous batching: per-slot positions).
        Returns (logits (B, 1, V), cache)."""
        token = torch.as_tensor(token, device=self.device)
        emb_pos = None
        if self.cfg.learned_pos:     # where the caller's positions lie (host: no sync)
            emb_pos = torch.as_tensor(pos)
            emb_pos = emb_pos[:, None] if emb_pos.ndim == 1 else emb_pos[None]
        pos = torch.as_tensor(pos, device=self.device)
        x = embed_tokens(params["embed"], token, emb_pos)
        x, _, cache = self._run_stack(params, x, mode="decode", pos=pos, cache=cache)
        x = _norm_apply(self.cfg, params["final_norm"], x)
        return logits_from(params["embed"], x), cache

"""Model configuration for the unified architecture zoo.

One ``ModelConfig`` drives every assigned architecture family:
dense GQA decoders, MoE decoders, RWKV6 (attention-free SSM), RG-LRU
hybrids (recurrentgemma), VLM cross-attention decoders and encoder-only
audio backbones.  The transformer assembly (``repro_torch.models.transformer``)
consumes ``block_groups()`` — a list of ``(pattern, repeats)`` where
``pattern`` is a tuple of block-type strings — and scans over ``repeats``
so that 100-layer configs lower to compact HLO.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

BLOCK_ATTN = "attn"        # self-attention + MLP (dense)
BLOCK_MOE = "moe"          # self-attention + MoE FFN
BLOCK_CROSS = "cross"      # cross-attention (vision KV) + MLP
BLOCK_REC = "rec"          # RG-LRU recurrent block + MLP
BLOCK_RWKV = "rwkv"        # RWKV6 time-mix + channel-mix


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    arch_type: str                  # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_head: int
    d_ff: int
    vocab_size: int

    act: str = "silu"               # silu | sq_relu | gelu
    qk_norm: bool = False
    rope_theta: float = 1e6
    norm_eps: float = 1e-6
    tie_embeddings: bool = False

    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    d_ff_expert: int = 0
    shared_expert: bool = False     # llama4-style always-on shared expert
    router_norm_topk: bool = True   # normalize top-k gate probs (qwen3 style)
    capacity_factor: float = 1.25   # EP dispatch capacity

    # --- RWKV6 ---
    rwkv_head_size: int = 64
    rwkv_lora_decay: int = 64       # low-rank dim of data-dependent decay

    # --- RG-LRU hybrid (recurrentgemma / griffin) ---
    hybrid_pattern: Tuple[str, ...] = ()   # e.g. ("rec","rec","attn")
    lru_width: int = 0
    conv_width: int = 4
    local_window: int = 0           # sliding window of the local-attn blocks

    # --- VLM ---
    cross_attn_every: int = 0       # every k-th block is cross-attention
    n_vision_tokens: int = 0
    d_vision: int = 0

    # --- encoder-only (audio) ---
    is_encoder: bool = False        # bidirectional, no decode step

    # --- serving variant ---
    sliding_window: int = 0         # >0: SWA variant for long-context decode
    kv_cache_dtype: str = ""        # "int8": quantized KV cache variant
    max_seq_len: int = 32768

    source: str = ""                # citation (paper / model card)

    # ------------------------------------------------------------------
    @property
    def causal(self) -> bool:
        return not self.is_encoder

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.d_head

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.d_head

    @property
    def attention_free(self) -> bool:
        return self.arch_type == "ssm"

    @property
    def has_decode(self) -> bool:
        """Encoder-only backbones have no autoregressive decode step."""
        return not self.is_encoder

    def attn_cache_len(self, cache_len: int) -> int:
        """Per-request attention-cache length: ``cache_len`` capped by
        the sliding/local window (ring caches never exceed it).  The ONE
        definition both execution backends size paged pools from — any
        drift here breaks backend parity (DESIGN.md §3)."""
        win = self.sliding_window or (
            self.local_window if self.arch_type == "hybrid" else 0)
        return min(cache_len, win) if win else cache_len

    @property
    def chunkable_prefill(self) -> bool:
        """Chunked prefill needs a POSITIONAL KV cache (chunks written
        contiguously, causal mask hides unwritten slots).  Ring caches
        (sliding-window / hybrid-local) and cross-attention vision KV
        are excluded — those configs fall back to whole-prompt prefill.
        Shared gate for the real engine and the cost model."""
        if self.arch_type == "vlm":
            return False
        win = self.sliding_window or (
            self.local_window if self.arch_type == "hybrid" else 0)
        return win == 0

    @property
    def prefix_cacheable(self) -> bool:
        """Cross-request prefix cache gate (DESIGN.md §3 "Prefix
        sharing").  Skipping prefill after a cached prefix requires (a)
        chunked prefill (resume at an absolute offset — positional,
        non-ring caches only) and (b) that the ENTIRE per-token state
        lives in pageable self-attention KV: recurrent carries (RWKV /
        RG-LRU) and vision cross-KV depend on the whole prefix and
        cannot be restored from shared pages.  Shared gate for the real
        engine and the cost model (backend parity)."""
        if not self.has_decode or not self.chunkable_prefill:
            return False
        return all(b in (BLOCK_ATTN, BLOCK_MOE)
                   for pat, _ in self.block_groups() for b in pat)

    @property
    def subquadratic(self) -> bool:
        """Can this config serve 500k-token contexts?

        True for SSM / hybrid (state or window bounded) and for any config
        running the sliding-window serving variant.
        """
        if self.arch_type == "ssm":
            return True
        if self.arch_type == "hybrid":
            return True  # RG-LRU state + bounded local window
        return self.sliding_window > 0

    def block_groups(self) -> Tuple[Tuple[Tuple[str, ...], int], ...]:
        """(pattern, repeats) groups; each group lowers to one lax.scan."""
        if self.arch_type == "ssm":
            return (((BLOCK_RWKV,), self.n_layers),)
        if self.arch_type == "hybrid":
            pat = self.hybrid_pattern or (BLOCK_REC, BLOCK_REC, BLOCK_ATTN)
            reps, rem = divmod(self.n_layers, len(pat))
            groups = []
            if reps:
                groups.append((tuple(pat), reps))
            if rem:
                groups.append((tuple(pat[:rem]), 1))
            return tuple(groups)
        if self.arch_type == "vlm" and self.cross_attn_every > 0:
            k = self.cross_attn_every
            assert self.n_layers % k == 0, "vlm layers must tile the pattern"
            pat = (BLOCK_ATTN,) * (k - 1) + (BLOCK_CROSS,)
            return ((pat, self.n_layers // k),)
        if self.arch_type == "moe":
            return (((BLOCK_MOE,), self.n_layers),)
        # dense / audio
        return (((BLOCK_ATTN,), self.n_layers),)

    def kv_bytes_per_token(self, bytes_per_el: int = 2) -> int:
        """Per-token KV-cache bytes — the `2·L·H·D·B` factor of paper Eq. (1).

        Attention-free layers contribute nothing (their state is O(1) in
        sequence length); windowed layers contribute only up to the window
        (handled by the batcher's memory model, see core/batcher.py).
        """
        n_attn = 0
        for pat, reps in self.block_groups():
            for b in pat:
                if b in (BLOCK_ATTN, BLOCK_MOE):
                    n_attn += reps
        return 2 * n_attn * self.n_kv_heads * self.d_head * bytes_per_el

    def cache_bytes_per_token(self) -> int:
        """Runtime per-token cache bytes honoring the serving variant:
        bf16 (2B) by default, int8 (1B + f32 per-(token,head) scales).
        This is the HOT-tier (device pool) denomination — the spill
        tier's is :meth:`spill_bytes_per_token`."""
        if self.kv_cache_dtype == "int8":
            n_attn = self.kv_bytes_per_token(1) // max(
                2 * self.n_kv_heads * self.d_head, 1)
            return self.kv_bytes_per_token(1) +                 2 * n_attn * self.n_kv_heads * 4
        return self.kv_bytes_per_token(2)

    def spill_bytes_per_token(self, spill_dtype: str = "") -> int:
        """Per-token bytes one KV token occupies in the HOST spill tier
        (DESIGN.md §3 "Tier precision") — precision is a property of
        the tier, so the cold tier may be narrower than the hot pool:

        * ``""``/``"bf16"`` — pass-through: pages spill at the hot
          pool's own width (``cache_bytes_per_token``), bit-exactly;
        * ``"int8"`` — 1 B/element plus f32 per-(token, head) scales
          (for an int8 hot pool this IS the pass-through width — the
          pool's int8 payload and scale planes spill verbatim);
        * ``"int4"`` — two elements packed per byte plus the same f32
          scale planes (the scales don't shrink: they are what bounds
          the dequantization error).

        Both execution backends size host slots and price the modeled
        PCIe channel from this ONE number, so quantized spill counts
        and restore times hold under backend parity."""
        if spill_dtype in ("", "bf16"):
            return self.cache_bytes_per_token()
        n_attn = self.kv_bytes_per_token(1) // max(
            2 * self.n_kv_heads * self.d_head, 1)
        scales = 2 * n_attn * self.n_kv_heads * 4
        if spill_dtype == "int8":
            return self.kv_bytes_per_token(1) + scales
        if spill_dtype == "int4":
            return max(self.kv_bytes_per_token(1) // 2, 1) + scales
        raise ValueError(f"unknown spill dtype {spill_dtype!r}")

    def state_bytes(self, bytes_per_el: int = 2) -> int:
        """Sequence-length-independent per-request state (SSM/hybrid)."""
        total = 0
        for pat, reps in self.block_groups():
            for b in pat:
                if b == BLOCK_RWKV:
                    n_h = self.d_model // self.rwkv_head_size
                    total += reps * (
                        n_h * self.rwkv_head_size ** 2 + 2 * self.d_model
                    ) * bytes_per_el
                elif b == BLOCK_REC:
                    total += reps * (
                        self.lru_width * (1 + self.conv_width - 1)
                    ) * bytes_per_el
        return total

    def param_count(self) -> int:
        """Analytic parameter count (used for roofline MODEL_FLOPS)."""
        emb = self.vocab_size * self.d_model
        total = emb if self.tie_embeddings else 2 * emb
        for pat, reps in self.block_groups():
            for b in pat:
                total += reps * self._block_params(b)
        total += self.d_model  # final norm
        if self.arch_type == "vlm":
            total += self.d_vision * self.d_model  # projector
        return total

    def active_param_count(self) -> int:
        """Params touched per token (MoE: routed top-k + shared only)."""
        if self.arch_type != "moe":
            return self.param_count()
        total = self.param_count()
        ff = 3 * self.d_model * self.d_ff_expert
        total -= self.n_layers * self.n_experts * ff          # remove all experts
        total += self.n_layers * self.top_k * ff              # add active
        return total

    def _block_params(self, b: str) -> int:
        d, q, kv = self.d_model, self.q_dim, self.kv_dim
        attn = d * q + 2 * d * kv + q * d
        if self.act in ("silu", "gelu"):
            mlp = 3 * d * self.d_ff      # gated
        else:
            mlp = 2 * d * self.d_ff      # squared-relu: up/down only
        norms = 2 * d
        if b == BLOCK_ATTN:
            return attn + mlp + norms
        if b == BLOCK_CROSS:
            return attn + mlp + norms
        if b == BLOCK_MOE:
            router = d * self.n_experts
            experts = self.n_experts * 3 * d * self.d_ff_expert
            shared = 3 * d * self.d_ff if self.shared_expert else 0
            return attn + router + experts + shared + norms
        if b == BLOCK_RWKV:
            n_h = self.d_model // self.rwkv_head_size
            tm = 4 * d * d + d * d  # r,k,v,g,out (square, lru-ish approx)
            tm += self.rwkv_lora_decay * 2 * d  # decay LoRA
            cm = 2 * d * int(3.5 * d)
            return tm + cm + norms + n_h * 0
        if b == BLOCK_REC:
            w = self.lru_width
            rec = d * w * 2 + w * d + 3 * w  # in x2, out, gates/Lambda
            rec += self.conv_width * w
            mlp = 3 * d * self.d_ff
            return rec + mlp + norms
        raise ValueError(b)


def reduced(cfg: ModelConfig, **overrides) -> ModelConfig:
    """Reduced same-family variant for CPU smoke tests."""
    small = dict(
        n_layers=2,
        d_model=min(cfg.d_model, 256),
        n_heads=min(cfg.n_heads, 4),
        n_kv_heads=min(cfg.n_kv_heads, 2),
        d_head=64,
        d_ff=min(cfg.d_ff, 512),
        vocab_size=min(cfg.vocab_size, 512),
        max_seq_len=256,
    )
    if cfg.n_experts:
        small.update(
            n_experts=min(cfg.n_experts, 4),
            top_k=min(cfg.top_k, 2),
            d_ff_expert=min(cfg.d_ff_expert, 256),
        )
    if cfg.lru_width:
        small["lru_width"] = min(cfg.lru_width, 256)
    if cfg.arch_type == "hybrid":
        small["n_layers"] = 3          # one full (rec, rec, attn) pattern
        small["local_window"] = min(cfg.local_window, 64)
    if cfg.arch_type == "ssm":
        small["d_model"] = 256         # multiple of rwkv_head_size
    if cfg.arch_type == "vlm":
        small["n_layers"] = 2          # one (attn, cross) pattern
        small["cross_attn_every"] = 2
        small["n_vision_tokens"] = min(cfg.n_vision_tokens, 16)
        small["d_vision"] = min(cfg.d_vision, 128)
    if cfg.sliding_window:
        small["sliding_window"] = min(cfg.sliding_window, 64)
    small.update(overrides)
    return dataclasses.replace(cfg, **small)

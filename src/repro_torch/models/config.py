"""Unified architecture configuration for all assigned model families — a
copy of ``repro.models.config`` (framework-free).

One dataclass covers dense / MoE / VLM / hybrid (RG-LRU) / audio (enc-dec) /
SSM (Mamba2-SSD) so the launcher, dry-run, and roofline code can treat every
architecture uniformly.  ``reduced()`` derives the CPU-smoke-test variant.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str  # dense | moe | vlm | hybrid | audio | ssm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0  # 0 → d_model // n_heads
    qk_norm: bool = False
    # attention pattern
    window: int = 0  # sliding-window size; 0 = global attention
    local_global_ratio: int = 0  # N local layers per 1 global (gemma3: 5)
    # MoE
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    moe_impl: str = "onehot"  # "onehot" (GShard baseline) | "sorted" (§Perf)
    moe_groups: int = 1  # shard-local dispatch groups (align with dp shards)
    # SSM / hybrid
    ssm_state: int = 0
    ssd_chunk: int = 64  # SSD intra-chunk length (perf knob; §Perf)
    attn_every: int = 0  # hybrid: one attention block every `attn_every` blocks
    conv_width: int = 4
    # encoder-decoder (audio)
    encoder_layers: int = 0
    # modality frontend stub (audio frames / vision patches)
    frontend: str = ""  # "" | "vision" | "audio"
    frontend_tokens: int = 0
    rope_theta: float = 10000.0
    tie_embeddings: bool = False
    dtype: str = "bfloat16"

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // max(self.n_heads, 1))

    @property
    def attention_free(self) -> bool:
        return self.family == "ssm"

    def param_count(self) -> int:
        """Analytic parameter count (embeddings + blocks), for roofline N."""
        d, ff, v = self.d_model, self.d_ff, self.vocab
        hd = self.resolved_head_dim
        emb = v * d * (1 if self.tie_embeddings else 2)
        attn = d * (self.n_heads * hd) + 2 * d * (self.n_kv_heads * hd) + (self.n_heads * hd) * d
        mlp = 3 * d * ff  # SwiGLU
        if self.family == "moe":
            mlp = self.n_experts * 3 * d * ff + d * self.n_experts
        blocks = 0
        if self.family == "ssm":
            # mamba2: in-proj (2*d_inner + 2*G*N + H), out-proj, conv, A/D/dt
            d_inner = 2 * d
            n_groups, n = 1, self.ssm_state
            blocks = self.n_layers * (
                d * (2 * d_inner + 2 * n_groups * n + d_inner // 64)
                + d_inner * d + self.conv_width * (d_inner + 2 * n_groups * n))
        elif self.family == "hybrid":
            d_rnn = d  # lru width
            rec = d * (2 * d_rnn) + d_rnn * d + 2 * d_rnn + self.conv_width * d_rnn
            n_attn = self.n_layers // max(self.attn_every, 1)
            blocks = (self.n_layers - n_attn) * (rec + mlp) + n_attn * (attn + mlp)
        elif self.family == "audio":
            blocks = self.encoder_layers * (attn + mlp) + self.n_layers * (2 * attn + mlp)
        else:
            blocks = self.n_layers * (attn + mlp)
        return emb + blocks

    def active_param_count(self) -> int:
        """Per-token active parameters (MoE: only top-k experts count)."""
        if self.family != "moe":
            return self.param_count()
        d, ff = self.d_model, self.d_ff
        dense_mlp = 3 * d * ff
        total = self.param_count()
        total -= self.n_layers * self.n_experts * dense_mlp
        total += self.n_layers * self.top_k * dense_mlp
        return total

    def reduced(self) -> "ArchConfig":
        """CPU smoke-test variant of the same family: same code paths, tiny dims."""
        return dataclasses.replace(
            self,
            name=self.name + "-reduced",
            n_layers=min(self.n_layers, 4 if self.family != "hybrid" else 6),
            d_model=128,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 2) or 1,
            d_ff=256,
            vocab=512,
            head_dim=32,
            window=min(self.window, 64) if self.window else 0,
            n_experts=min(self.n_experts, 4),
            top_k=min(self.top_k, 2),
            ssm_state=min(self.ssm_state, 32) if self.ssm_state else 0,
            encoder_layers=min(self.encoder_layers, 2),
            frontend_tokens=min(self.frontend_tokens, 16) if self.frontend_tokens else 0,
        )


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One input-shape cell: train or serve geometry."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"

    @property
    def is_decode(self) -> bool:
        return self.kind == "decode"


TRAIN_4K = ShapeConfig("train_4k", 4096, 256, "train")
PREFILL_32K = ShapeConfig("prefill_32k", 32768, 32, "prefill")
DECODE_32K = ShapeConfig("decode_32k", 32768, 128, "decode")
LONG_500K = ShapeConfig("long_500k", 524288, 1, "decode")

ALL_SHAPES = (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)

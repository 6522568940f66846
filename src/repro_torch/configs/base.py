"""Model / shape / run configuration schema and the architecture registry.

A ModelConfig describes any of the assigned architectures with one schema:
`layout` is a tuple of (pattern, repeats) groups; a pattern is a tuple of
blocks (mixer_kind, ffn_kind).  Heterogeneous stacks (gemma's 5:1
local:global, jamba's 1:7 attn:mamba, xlstm's mlstm/slstm alternation,
llama-vision's every-5th cross-attn) become repeating *period* patterns that
the model loops over layer by layer.

Mixer kinds: attn | attn_local | attn_bidir | cross | dec | mla | mamba |
             mlstm | slstm
FFN kinds:   dense | moe | none

The reference's ten architectures register with `register` and are what
`list_configs` returns; an architecture the port adds beyond them
registers with `register_port` and is listed by `list_port_configs`.
`get_config` and `smoke_config` take both.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

Pattern = Tuple[Tuple[str, str], ...]
Layout = Tuple[Tuple[Pattern, int], ...]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | hybrid | ssm | audio | vlm
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int                      # dense-FFN hidden size (0 = no FFN blocks)
    n_layers: int                  # informational total (layout is canonical)
    vocab_size: int
    layout: Layout
    head_dim: int = 0              # 0 -> d_model // n_heads
    # MoE
    n_experts: int = 0
    top_k: int = 0
    moe_dff: int = 0               # per-expert hidden size
    capacity_factor: float = 1.25
    moe_groups: int = 1            # dispatch groups (set to DP shard count)
    # attention
    qkv_bias: bool = False
    attn_softcap: Optional[float] = None
    final_softcap: Optional[float] = None
    window: Optional[int] = None   # sliding window for attn_local
    rope_theta: float = 10000.0
    # encoder-decoder (whisper): encoder layer count + frame count stub
    n_enc_layers: int = 0
    n_frames: int = 0
    # vlm: precomputed image-patch embedding count (frontend stub)
    n_img_tokens: int = 0
    # ssm
    d_state: int = 16
    d_conv: int = 4
    mamba_expand: int = 2
    # numerics / misc
    flash_kc: int = 512            # flash-attention KV chunk length
    activation: str = "silu"       # dense-FFN activation (gemma: gelu/GeGLU)
    dtype: str = "bfloat16"
    norm_eps: float = 1e-6
    tie_embeddings: bool = True
    embed_scale: bool = False      # gemma-style sqrt(d_model) embed scaling
    # which shapes are valid for this arch (long_500k needs sub-quadratic)
    supports_long_context: bool = False
    notes: str = ""

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    def scaled(self, **overrides) -> "ModelConfig":
        return dataclasses.replace(self, **overrides)


@dataclasses.dataclass(frozen=True)
class DeepSeekV3Config(ModelConfig):
    """A `ModelConfig` with DeepSeek-V3's block (model_type deepseek_v3),
    which the port adds to the reference's schema: its fields exist only
    here, so the reference's ten configs keep the reference's dataclass
    field for field."""
    # latent attention (mixer "mla", DeepSeek-V2 §2.1): the K/V latent's
    # width, each head's no-RoPE and RoPE query/key dims and its value dim
    kv_lora_rank: int = 0
    qk_nope_head_dim: int = 0
    qk_rope_head_dim: int = 0
    v_head_dim: int = 0
    # the MoE layers route as DeepSeek-V3 (§2.1.2) and send every
    # assignment to its expert (no capacity): sigmoid scores with a
    # selection bias moved by ``bias_update_rate`` after each step, the
    # chosen weights normalised and scaled by ``routed_scale``, and
    # ``n_shared_experts`` experts of width ``moe_dff`` every token takes
    routed_scale: float = 1.0
    n_shared_experts: int = 0
    bias_update_rate: float = 0.0


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                      # train | prefill | decode


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


_REGISTRY = {}
_PORT_REGISTRY = {}


def register(fn):
    """Decorator: configs/<id>.py modules register a zero-arg factory."""
    cfg = fn()
    _REGISTRY[cfg.name] = fn
    return fn


def register_port(fn):
    """`register` for an architecture the port adds to the reference's."""
    cfg = fn()
    _PORT_REGISTRY[cfg.name] = fn
    return fn


def get_config(name: str) -> ModelConfig:
    if name not in _REGISTRY and name not in _PORT_REGISTRY:
        # late import of all config modules
        from repro_torch import configs as _c  # noqa
        _c.load_all()
    return (_REGISTRY.get(name) or _PORT_REGISTRY[name])()


def list_configs():
    """The reference's architectures."""
    from repro_torch import configs as _c
    _c.load_all()
    return sorted(_REGISTRY)


def list_port_configs():
    """The architectures the port adds to the reference's."""
    from repro_torch import configs as _c
    _c.load_all()
    return sorted(_PORT_REGISTRY)


def smoke_config(name: str) -> ModelConfig:
    """Reduced same-family config for CPU smoke tests: same layout *kinds*
    and block structure, tiny dims (few layers, small width/vocab/experts)."""
    cfg = get_config(name)
    layout = tuple((pattern, min(repeats, 2)) for pattern, repeats in cfg.layout)
    n_heads = min(cfg.n_heads, 4)
    n_kv = max(1, min(cfg.n_kv_heads, n_heads, 2))
    if n_heads % n_kv:
        n_kv = 1
    mla = {}
    if getattr(cfg, "kv_lora_rank", 0):
        # a small latent, the value dim kept apart from the query/key dim
        mla = dict(kv_lora_rank=32, qk_nope_head_dim=16, qk_rope_head_dim=8,
                   v_head_dim=16)
    return cfg.scaled(
        **mla,
        d_model=64,
        n_heads=n_heads,
        n_kv_heads=n_kv,
        head_dim=16,
        d_ff=0 if cfg.d_ff == 0 else 128,
        n_layers=sum(len(p) * r for p, r in layout),
        vocab_size=512,
        layout=layout,
        n_experts=min(cfg.n_experts, 8) if cfg.n_experts else 0,
        top_k=min(cfg.top_k, 2) if cfg.top_k else 0,
        moe_dff=64 if cfg.moe_dff else 0,
        window=min(cfg.window, 32) if cfg.window else None,
        n_enc_layers=min(cfg.n_enc_layers, 2),
        n_frames=16 if cfg.n_frames else 0,
        n_img_tokens=16 if cfg.n_img_tokens else 0,
        dtype="float32",
    )


def valid_cells(name: str):
    """The (arch x shape) cells this arch runs (paper-mandated skips applied)."""
    cfg = get_config(name)
    cells = []
    for sname, shape in SHAPES.items():
        if sname == "long_500k" and not cfg.supports_long_context:
            continue  # pure full-attention arch: documented skip
        cells.append(sname)
    return cells

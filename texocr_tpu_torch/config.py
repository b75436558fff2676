"""Configuration: the reference's config dict, validated into typed views.

The same YAML/dict surface as ``texocr_tpu.config`` (runtime-injected
``max_length`` and ``vocab_size`` included), with the port's defaults. The one
difference: ``use_flash_attention: "auto"`` means "the model lives on a CUDA
device", which ``resolve_flash`` decides once the device is known.

Training keys, with the JAX package's defaults: ``mask_pad_loss`` (mask PAD
labels out of the loss; false is the reference's unmasked cross entropy),
``seq_pad_multiple`` (label batches padded up to a multiple of it), ``remat``
(recompute each transformer sub-layer and ResNet bottleneck in the backward
instead of storing its activations) and ``device_data`` (the dataset resident
on the device as uint8 shape buckets, batches picked and augmented there;
``training/device_data.py``). The ``device_data_*`` keys tune that path:
``steps_per_call`` (steps a call runs from one bucket), ``val`` (false
streams the val split from the host loader), ``augment`` (the on-device
augmentation; the host's ``ImageDataset.augment`` has no effect there),
``size_round``, ``bucket_cap``, ``pack_bits`` (8 or 4) and ``max_canvas``
((h, w): larger buckets are left out).

Model variants, as the JAX package builds them: ``encoder.embed_layer``
(``hybrid``, the ResNet backbone, or ``patch``, a plain strided patchify),
the top-level ``glu`` (the decoder's MLP is GeGLU or dense + gelu; the
encoder's is GeGLU always) and ``decoder.cross_attend`` (false: a decoder
without cross-attention layers, which trains but has no cached decode, as in
the JAX package).

Decoder kinds (``decoder.kind``): ``texocr`` (the default) is the
reference's cross-attending decoder with the keys above; ``mla_moe`` is a
prefix decoder in the form of Kimi-VL-A3B's language model (DeepSeek-V3's
layers: multi-head latent attention, sigmoid-routed experts beside shared
ones, a leading dense layer, RMSNorm and RoPE), read from the published
``config.json``'s own keys (``MlaMoeConfig``), beside ``projector_hidden``
(the image projector's hidden width) and ``merge`` (the 2-D pixel shuffle of
the encoder's grid). Its context is the encoder's image tokens, projected
and prefilled into its latent cache, not cross-attention K/V. A decoder key
that the chosen kind does not read raises ``ValueError``, as does a value
of a published key that the port does not implement. The top-level
``param_dtype`` (``float32`` or ``bfloat16``) is the type the prefix
decoder's parameters are held in (``MlaMoeConfig.param_dtype``); the
encoder's stay float32, as every parameter of the texocr model does.

Decode keys: ``kv_quant`` (``int8`` quantizes the cross-attention K/V once per
sequence, per (B, H, dh) scales) and ``self_kv_quant`` (``int8`` keeps the
self-attention prefix in int8 with per-position scales, merged chunk by
chunk). Either is ``none`` or ``int8``; the decode raises ``ValueError`` on
anything else.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, ClassVar, Dict, Optional, Tuple, Union

import torch

_DEFAULTS: Dict[str, Any] = {
    "dtype": "bfloat16",
    "use_flash_attention": "auto",
    "kv_quant": "none",
    "self_kv_quant": "none",
    "mask_pad_loss": True,
    "seq_pad_multiple": 32,
    "remat": False,
    "device_data": False,
    "device_data_steps_per_call": 16,
    "device_data_val": True,
    "device_data_augment": False,
    "device_data_size_round": 512,
    "device_data_bucket_cap": None,
    "device_data_pack_bits": 8,
    "device_data_max_canvas": None,
    "optimizer": "Adam",
    "optimizer_args": {"lr": 5e-4},
    "seed": 42,
    "save_checkpoint": True,
    "save_dir": "checkpoints",
    "save_freq": 1,
    "val_freq": 1,
    "mesh": {"data": -1, "model": 1},  # the process mesh (parallel/mesh.py)
}

#: The flagship architecture (the reference's config/config.yml widths): embed
#: 256, 8 heads, 4 + 4 layers, ResNet depths (2, 4, 6), vocab 1000.
FLAGSHIP: Dict[str, Any] = {
    "patch_size": 16,
    "glu": True,
    "bos_token": 998,
    "eos_token": 997,
    "trg_pad_idx": 999,
    "max_length": 512,
    "vocab_size": 1000,
    "dtype": "bfloat16",
    "encoder": {
        "n_channels": 1,
        "embed_dim": 256,
        "num_layers": 4,
        "heads": 8,
    },
    "decoder": {
        "embed_dim": 256,
        "num_layers": 4,
        "heads": 8,
        "cross_attend": True,
        "dropout": 0.1,
        "exp_factor": 4,
    },
}


EMBED_LAYERS = ("hybrid", "patch")
DECODER_KINDS = ("texocr", "mla_moe")
PARAM_DTYPES = ("float32", "bfloat16")

#: The ``texocr`` decoder's keys.
TEXOCR_DECODER_KEYS = frozenset(
    {"kind", "embed_dim", "num_layers", "heads", "cross_attend", "dropout", "exp_factor"})


def load_config(config_path: str) -> dict:
    """Load a YAML configuration file (or a ``.json`` one, which needs no
    PyYAML) into a plain dict."""
    config_path = str(config_path)
    with open(config_path, "r") as f:
        if config_path.endswith(".json"):
            return json.load(f)
        try:
            import yaml
        except ImportError:
            raise ImportError(f"reading the YAML config {config_path} needs PyYAML (the "
                              "'yaml' package); give a .json config with the same keys "
                              "instead") from None
        return yaml.safe_load(f)


def with_defaults(config: dict) -> dict:
    """A copy of ``config`` with the port's defaults filled in."""
    out = dict(_DEFAULTS)
    out.update(config)
    return out


def resolve_flash(value: Union[bool, str, None], device: torch.device) -> bool:
    """``use_flash_attention`` for a model on ``device``: "auto" (or None)
    means the kernel on a CUDA device and the math path elsewhere."""
    if value == "auto" or value is None:
        return torch.device(device).type == "cuda"
    return bool(value)


@dataclasses.dataclass(frozen=True)
class EncoderConfig:
    img_size: tuple  # (H, W) largest canvas
    patch_size: int
    n_channels: int
    embed_dim: int
    num_layers: int
    heads: int
    resnet_depths: tuple = (2, 4, 6)
    resnet_channels: tuple = (256, 512, 1024)
    stem_channels: int = 64
    embed_layer: str = "hybrid"  # "hybrid" (ResNet backbone) or "patch"


@dataclasses.dataclass(frozen=True)
class DecoderConfig:
    vocab_size: int
    max_length: int
    embed_dim: int
    num_layers: int
    heads: int
    cross_attend: bool = True
    glu: bool = True
    exp_factor: int = 4
    dropout: float = 0.0
    kind: ClassVar[str] = "texocr"


@dataclasses.dataclass(frozen=True)
class MlaMoeConfig:
    """A DeepSeek-V3-style language model (Kimi-VL-A3B's) as a prefix
    decoder, under its published ``config.json`` keys. The values the port
    implements are checked in ``from_dict``: no q LoRA, one expert group,
    sigmoid scores with ``noaux_tc``'s correction bias, SiLU, no RoPE
    scaling, no attention bias, an untied head, every layer after the first
    ``first_k_dense_replace`` an expert layer."""
    vocab_size: int
    max_position_embeddings: int
    hidden_size: int
    intermediate_size: int
    moe_intermediate_size: int
    num_hidden_layers: int
    num_attention_heads: int
    num_key_value_heads: int
    n_shared_experts: int
    n_routed_experts: int
    num_experts_per_tok: int
    routed_scaling_factor: float
    kv_lora_rank: int
    qk_nope_head_dim: int
    qk_rope_head_dim: int
    v_head_dim: int
    first_k_dense_replace: int
    norm_topk_prob: bool
    rms_norm_eps: float
    rope_theta: float
    projector_hidden: int
    merge: Tuple[int, int] = (2, 2)
    param_dtype: str = "float32"
    kind: ClassVar[str] = "mla_moe"

    #: Published keys whose value is fixed by what the port implements.
    FIXED = {"q_lora_rank": None, "topk_method": "noaux_tc", "n_group": 1, "topk_group": 1,
             "scoring_func": "sigmoid", "hidden_act": "silu", "rope_scaling": None,
             "attention_bias": False, "tie_word_embeddings": False, "moe_layer_freq": 1,
             "ep_size": 1}
    #: Published keys read and not used: the auxiliary loss of training.
    IGNORED = frozenset({"seq_aux"})

    @property
    def max_length(self) -> int:
        """Positions of the rotary table: prefix and decoded tokens together."""
        return self.max_position_embeddings

    @property
    def moe_layers(self) -> int:
        return self.num_hidden_layers - self.first_k_dense_replace

    @staticmethod
    def from_dict(dec: dict, param_dtype: str = "float32") -> "MlaMoeConfig":
        fields = {f.name for f in dataclasses.fields(MlaMoeConfig)} - {"param_dtype"}
        unknown = set(dec) - fields - set(MlaMoeConfig.FIXED) - MlaMoeConfig.IGNORED - {"kind"}
        if unknown:
            raise ValueError(f"decoder keys not read by kind 'mla_moe': {sorted(unknown)}")
        for key, value in MlaMoeConfig.FIXED.items():
            if key in dec and dec[key] != value:
                raise ValueError(f"decoder {key}={dec[key]!r}: the mla_moe decoder implements "
                                 f"{value!r} only")
        args = {k: v for k, v in dec.items() if k in fields}
        if "merge" in args:
            args["merge"] = tuple(args["merge"])
        missing = fields - set(args) - {"merge"}
        if missing:
            raise ValueError(f"mla_moe decoder keys missing: {sorted(missing)}")
        if param_dtype not in PARAM_DTYPES:
            raise ValueError(f"unknown param_dtype: {param_dtype!r}")
        cfg = MlaMoeConfig(**args, param_dtype=param_dtype)
        if cfg.num_key_value_heads != cfg.num_attention_heads:
            raise ValueError("latent attention has one K/V head per query head")
        if not 0 <= cfg.first_k_dense_replace <= cfg.num_hidden_layers:
            raise ValueError("first_k_dense_replace exceeds num_hidden_layers")
        return cfg


def decoder_config(config: dict) -> Union[DecoderConfig, MlaMoeConfig]:
    """The ``decoder`` block of a config dict, by its ``kind``."""
    dec = config["decoder"]
    kind = dec.get("kind", "texocr")
    if kind not in DECODER_KINDS:
        raise ValueError(f"unknown decoder kind: {kind!r}; known: {DECODER_KINDS}")
    if kind == "mla_moe":
        return MlaMoeConfig.from_dict(dec, config.get("param_dtype", "float32"))
    if config.get("param_dtype", "float32") != "float32":
        raise ValueError("param_dtype is the mla_moe decoder's: the texocr model holds float32 "
                         "parameters")
    unknown = set(dec) - TEXOCR_DECODER_KEYS
    if unknown:
        raise ValueError(f"decoder keys not read by kind 'texocr': {sorted(unknown)}")
    for key in ("max_length", "vocab_size"):
        if key not in config:
            raise ValueError(
                f"'{key}' not present in config — it is injected at run time "
                "from the dataset or the tokenizer."
            )
    return DecoderConfig(
        vocab_size=config["vocab_size"],
        max_length=config["max_length"],
        embed_dim=dec["embed_dim"],
        num_layers=dec["num_layers"],
        heads=dec["heads"],
        cross_attend=bool(dec.get("cross_attend", True)),
        glu=bool(config.get("glu", True)),
        exp_factor=dec.get("exp_factor", 4),
        dropout=dec.get("dropout", 0.0),
    )


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    encoder: EncoderConfig
    decoder: Union[DecoderConfig, MlaMoeConfig]
    bos_token: int
    eos_token: int
    pad_token: int
    dtype: str = "bfloat16"
    use_flash_attention: Union[bool, str] = "auto"
    kv_quant: str = "none"
    self_kv_quant: str = "none"
    remat: bool = False

    @staticmethod
    def from_dict(config: dict) -> "ModelConfig":
        """Typed config from a reference-format dict."""
        config = with_defaults(config)
        decoder = decoder_config(config)
        enc_args = config["encoder"]
        encoder = EncoderConfig(
            img_size=tuple(config.get("img_size", (160, 1008))),
            patch_size=config["patch_size"],
            n_channels=enc_args["n_channels"],
            embed_dim=enc_args["embed_dim"],
            num_layers=enc_args["num_layers"],
            heads=enc_args["heads"],
            resnet_depths=tuple(enc_args.get("resnet_depths", (2, 4, 6))),
            resnet_channels=tuple(enc_args.get("resnet_channels", (256, 512, 1024))),
            stem_channels=enc_args.get("stem_channels", 64),
            embed_layer=enc_args.get("embed_layer", "hybrid"),
        )
        if encoder.embed_layer not in EMBED_LAYERS:
            raise ValueError(f"unknown embed_layer: {encoder.embed_layer!r}")
        return ModelConfig(
            encoder=encoder,
            decoder=decoder,
            bos_token=config["bos_token"],
            eos_token=config["eos_token"],
            pad_token=config["trg_pad_idx"],
            dtype=config["dtype"],
            use_flash_attention=config["use_flash_attention"],
            kv_quant=config["kv_quant"],
            self_kv_quant=config["self_kv_quant"],
            remat=bool(config["remat"]),
        )


def model_config_from_yaml(config_path: str, max_length: Optional[int] = None,
                          vocab_size: Optional[int] = None) -> ModelConfig:
    """A config file (YAML, or ``.json`` without PyYAML) -> ``ModelConfig``,
    with the run-time keys ``max_length`` and ``vocab_size`` injected where
    given."""
    config = load_config(config_path)
    if max_length is not None:
        config["max_length"] = max_length
    if vocab_size is not None:
        config["vocab_size"] = vocab_size
    return ModelConfig.from_dict(config)


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    batch_size: int
    n_epochs: int
    optimizer: str
    optimizer_args: Dict[str, Any]
    seed: int
    save_checkpoint: bool
    save_dir: str
    save_freq: int
    val_freq: int
    mask_pad_loss: bool
    seq_pad_multiple: int

    @staticmethod
    def from_dict(config: dict) -> "TrainConfig":
        """The loop's keys; the loader's (``drop_last``, ``keep_small``,
        ``batch_shuffle``, ``id_shuffle``) are read by ``create_dataloader``,
        and the device-resident path's (``device_data*``, ``keep_small``,
        ``batch_shuffle``) by the loop from the config dict."""
        config = with_defaults(config)
        return TrainConfig(
            batch_size=config["batch_size"],
            n_epochs=config["n_epochs"],
            optimizer=config["optimizer"],
            optimizer_args=dict(config["optimizer_args"]),
            seed=config["seed"],
            save_checkpoint=config["save_checkpoint"],
            save_dir=config["save_dir"],
            save_freq=config["save_freq"],
            val_freq=config["val_freq"],
            mask_pad_loss=config["mask_pad_loss"],
            seq_pad_multiple=config["seq_pad_multiple"],
        )

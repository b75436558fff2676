"""Top-level OCR model: ViT encoder (hybrid or patch embed) + autoregressive
decoder.

``state_dict()`` gives exactly the reference PyTorch model's keys
(``encoder.*`` and ``decoder.net.*``), so its checkpoints and the committed
goldens load with ``strict=True``.

``forward(images, targets)`` is the teacher-forced pass of training: the
target mask is (targets != PAD), and the decoder reads targets[:, :-1] under
that mask trimmed to match and returns the logits of targets[:, 1:]. A
decoder without cross-attention reads no encoder output, so ``forward`` does
not encode (the JAX package's jitted step drops that dead encode as well);
its encoder's parameters get no gradient.

On a mesh (``mesh=``, ``parallel/mesh.py``) every rank builds the full model
from the seed, as one process does, then keeps its slices
(``parallel/sharding.py``): each rank starts from the single-process
weights. ``full_shapes`` records the full shape of every state-dict key,
which ``gather_state_dict`` needs to put the slices back together.

The ``decoder_*`` methods are the cached decode's. They, ``encode``'s
last part, ``forward`` and ``check_decodes`` delegate to ``decoding``, the
decode interface of the config's ``decoder.kind``, which ``__init__`` builds
once: ``CrossDecoding`` for ``texocr``, whose self-attention cache and
cross-attention K/V follow ``config.self_kv_quant`` and ``config.kv_quant``
and need the decoder's cross-attention layers, or ``PrefixDecoding``
(``models/prefix_decoder.py``) for ``mla_moe``.

The ``mla_moe`` kind builds the prefix decoder beside the same encoder:
``encode`` gives the image's tokens in the language model's width (encoder,
then ``multi_modal_projector``), ``decoder_cross_kv`` prefills them, so a
decode's context is each layer's filled latent cache, and ``decoder_start``
is the prefix's length, the position of BOS. Its state-dict keys are the
published checkpoint's (``language_model.*``, ``multi_modal_projector.*``)
beside ``encoder.*``. Its language model and projector are built on the
``meta`` device and never drawn on the host: with a ``state_dict`` they take
its tensors by assignment (moved to the device and type first where they
are elsewhere), so a card holds one copy of the weights; without one they
are drawn on the device (``prefix_decoder.init_weights``). It decodes
greedily and by sampling; beam search, a mesh and training raise
``NotImplementedError``.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import torch
from torch import nn

from texocr_tpu_torch.config import ModelConfig, resolve_flash
from texocr_tpu_torch.models.decoder import TransformerDecoder
from texocr_tpu_torch.models.encoder import VisionEncoder
from texocr_tpu_torch.models.layers import init_torch_default
from texocr_tpu_torch.models.prefix_decoder import (LanguageModel, PrefixDecoding, Projector,
                                                    init_weights)
from texocr_tpu_torch.parallel.mesh import mesh_axis
from texocr_tpu_torch.parallel.sharding import shard_tensor

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class CrossDecoding:
    """The ``texocr`` decoder's side of ``OCRModel``: the image's tokens are
    the encoder's output, a decode's context is each layer's cross-attention
    K/V, and BOS sits at position 0."""

    def __init__(self, net: TransformerDecoder, config: ModelConfig):
        self.net, self.config = net, config

    def check(self, mode: Optional[str] = None, mesh: bool = False) -> None:
        self.net.attn_layers.check_decodes()

    def tokens(self, enc: torch.Tensor, images: torch.Tensor) -> torch.Tensor:
        return enc

    def forward(self, encode: Callable, images: torch.Tensor, targets: torch.Tensor,
                generator: Optional[torch.Generator] = None):
        trg_mask = targets != self.config.pad_token
        enc = encode(images) if self.config.decoder.cross_attend else None
        logits = self.net(targets[:, :-1], enc, mask=trg_mask[:, :-1], generator=generator)
        return logits, targets[:, 1:]

    def context(self, enc: torch.Tensor):
        return self.net.attn_layers.precompute_cross_kv(enc, quant=self.config.kv_quant)

    def init_cache(self, batch: int, max_len: int, device):
        return self.net.attn_layers.init_cache(batch, max_len, device,
                                               quant=self.config.self_kv_quant)

    def start(self, context) -> int:
        return 0

    def step(self, token_t: torch.Tensor, t: int, cache, context,
             enc_mask: Optional[torch.Tensor] = None, t0: int = 0) -> torch.Tensor:
        return self.net.step(token_t, t, cache, context, enc_mask=enc_mask, t0=t0)


class OCRModel(nn.Module):
    """The model on ``device`` (CUDA unless the caller asks otherwise), with
    weights drawn from a ``torch.Generator`` seeded with ``seed`` the way
    torch initialises the reference, or loaded from ``state_dict``.
    ``mesh``: a data x model ``DeviceMesh``; the model then holds this
    rank's slices, and ``data`` and ``tp`` are its axes."""

    def __init__(self, config: ModelConfig, device="cuda", seed: int = 0, mesh=None,
                 state_dict: Optional[Dict[str, torch.Tensor]] = None):
        super().__init__()
        self.config = config
        dtype = DTYPES[config.dtype]
        use_flash = resolve_flash(config.use_flash_attention, device)
        self.encoder = VisionEncoder(config.encoder, dtype, use_flash, config.remat)
        if config.decoder.kind == "mla_moe":
            self._build_prefix_decoder(device, seed, mesh, state_dict)
            return
        # The reference holds the decoder stack as ``decoder.net``.
        self.decoder = nn.ModuleDict({"net": TransformerDecoder(
            config.decoder, dtype, use_flash, config.remat)})
        self.decoding = CrossDecoding(self.decoder["net"], config)
        generator = torch.Generator().manual_seed(seed)
        init_torch_default(self, generator)
        with torch.no_grad():
            for emb in (self.dec.token_embedding, self.dec.pos_embedding.embedding):
                emb.weight.normal_(0.0, 0.02, generator=generator)
        self.to(device)
        if state_dict is not None:
            self.load_state_dict(state_dict, strict=True)
        self.full_shapes: Dict[str, torch.Size] = {k: v.shape
                                                   for k, v in self.state_dict().items()}
        self.data, self.tp = mesh_axis(mesh, "data"), mesh_axis(mesh, "model")
        if mesh is not None:
            self._shard()

    def _build_prefix_decoder(self, device, seed: int, mesh, state_dict) -> None:
        """The ``mla_moe`` model: the encoder drawn as the TeXOCR model's is,
        the projector and language model built on ``meta`` and then assigned
        ``state_dict``'s tensors or drawn on ``device``."""
        if mesh is not None:
            raise NotImplementedError("the mla_moe decoder does not run on a mesh")
        dtype, param_dtype = DTYPES[self.config.dtype], DTYPES[self.config.decoder.param_dtype]
        init_torch_default(self.encoder, torch.Generator().manual_seed(seed))
        self.encoder.to(device)
        with torch.device("meta"):
            self.multi_modal_projector = Projector(self.config.encoder.embed_dim,
                                                   self.config.decoder, dtype, param_dtype)
            self.language_model = LanguageModel(self.config.decoder, dtype, param_dtype)
        self.decoding = PrefixDecoding(self.multi_modal_projector, self.language_model,
                                       self.encoder)
        if state_dict is None:
            generator = torch.Generator(device=device).manual_seed(seed)
            for part in (self.multi_modal_projector, self.language_model):
                part.to_empty(device=device)
                init_weights(part, generator)
        else:
            own = self.state_dict()
            self.load_state_dict({k: v.to(device=device, dtype=own[k].dtype)
                                  if k in own else v for k, v in state_dict.items()},
                                 strict=True, assign=True)
        self.full_shapes = {k: v.shape for k, v in self.state_dict().items()}
        self.data, self.tp = mesh_axis(None, "data"), mesh_axis(None, "model")

    def _shard(self) -> None:
        """Cuts every parameter to this rank's slice and puts the blocks in
        their tensor-parallel form (split parameters are marked
        ``tensor_model_parallel``: the gradient clip sums their norms over
        the model group)."""
        with torch.no_grad():
            for name, p in self.named_parameters():
                local = shard_tensor(name, p.data, self.tp.size, self.tp.rank)
                if local.shape != p.shape:
                    p.data = local
                    p.tensor_model_parallel = True
        self.encoder.attn_layers.shard(self.tp)
        self.dec.shard(self.data, self.tp)

    def parameter_keys(self) -> List[str]:
        """The state-dict key of each parameter, in ``parameters()`` order
        (the optimizer's indices)."""
        return [name for name, _ in self.named_parameters()]

    @property
    def dec(self) -> TransformerDecoder:
        return self.decoding.net

    def encode(self, images: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 1) -> (B, N_patches + 1, D); with the prefix decoder the
        image's tokens (B, P, hidden) in the language model's width."""
        return self.decoding.tokens(self.encoder(images), images)

    def forward(self, images: torch.Tensor, targets: torch.Tensor,
                generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Teacher-forced logits: (B, H, W, 1) images and (B, T) targets ->
        (logits (B, T-1, V), labels targets[:, 1:]), the shifted pair the loss
        is taken over. ``generator`` draws the decoder's dropout mask (none
        without it)."""
        return self.decoding.forward(self.encode, images, targets, generator)

    def check_decodes(self, mode: Optional[str] = None, mesh: bool = False) -> None:
        """Raises ``ValueError`` unless the decoder has the cross-attention
        layers the cached decode needs, and ``NotImplementedError`` for a
        ``mode`` or a ``mesh`` decode the decoder does not run: call before
        encoding for a decode."""
        self.decoding.check(mode, mesh)

    def check_unsharded(self, what: str) -> None:
        """Raises ``NotImplementedError`` for ``what`` (the CUDA-graph
        engine) on a tensor-parallel model. Its decode step all-reduces over
        the model group, so a graph would have to capture those collectives:
        gloo's cannot be captured, and NCCL's need a GPU per rank, which one
        card cannot give, so such a graph could be neither run nor checked
        here. Every eager decode mode runs on such a model."""
        if self.tp.size > 1:
            raise NotImplementedError(
                f"{what} does not run on a tensor-parallel model: its step all-reduces over "
                "the model group, gloo's collectives cannot be captured in a CUDA graph, and "
                "NCCL's need one GPU per rank; decode eagerly (generate, mesh_generate)")

    def decoder_init_cache(self, batch: int, max_len: int, device):
        return self.decoding.init_cache(batch, max_len, device)

    def decoder_cross_kv(self, enc: torch.Tensor):
        """The decode's context of ``encode``'s output: the cross-attention
        K/V, or the prefix decoder's filled latent cache."""
        return self.decoding.context(enc)

    def decoder_start(self, cross_kv) -> int:
        """The position of BOS, step 0's input: after the prefix, or 0."""
        return self.decoding.start(cross_kv)

    def decoder_step(self, token_t: torch.Tensor, t: int, cache, cross_kv,
                     enc_mask: Optional[torch.Tensor] = None, t0: int = 0) -> torch.Tensor:
        return self.decoding.step(token_t, t, cache, cross_kv, enc_mask=enc_mask, t0=t0)

def create_model(config: dict, device="cuda", seed: int = 0,
                 state_dict: Optional[Dict[str, torch.Tensor]] = None) -> OCRModel:
    """The model of a reference-format config dict (``ModelConfig.from_dict``
    validates it) on ``device``, weights drawn from ``seed`` or loaded from
    ``state_dict``."""
    return OCRModel(ModelConfig.from_dict(config), device=device, seed=seed,
                    state_dict=state_dict)

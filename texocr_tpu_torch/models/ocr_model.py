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

The ``decoder_*`` methods are the cached decode's: the self-attention cache
and the cross-attention K/V follow ``config.self_kv_quant`` and
``config.kv_quant``; they need the decoder's cross-attention layers
(``check_decodes``).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
from torch import nn

from texocr_tpu_torch.config import ModelConfig, resolve_flash
from texocr_tpu_torch.models.decoder import TransformerDecoder
from texocr_tpu_torch.models.encoder import VisionEncoder
from texocr_tpu_torch.models.layers import init_torch_default
from texocr_tpu_torch.parallel.mesh import mesh_axis
from texocr_tpu_torch.parallel.sharding import shard_tensor

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class OCRModel(nn.Module):
    """The model on ``device`` (CUDA unless the caller asks otherwise), with
    weights drawn from a ``torch.Generator`` seeded with ``seed`` the way
    torch initialises the reference (load a state dict to replace them).
    ``mesh``: a data x model ``DeviceMesh``; the model then holds this
    rank's slices, and ``data`` and ``tp`` are its axes."""

    def __init__(self, config: ModelConfig, device="cuda", seed: int = 0, mesh=None):
        super().__init__()
        self.config = config
        dtype = DTYPES[config.dtype]
        use_flash = resolve_flash(config.use_flash_attention, device)
        self.encoder = VisionEncoder(config.encoder, dtype, use_flash, config.remat)
        # The reference holds the decoder stack as ``decoder.net``.
        self.decoder = nn.ModuleDict({"net": TransformerDecoder(
            config.decoder, dtype, use_flash, config.remat)})
        generator = torch.Generator().manual_seed(seed)
        init_torch_default(self, generator)
        with torch.no_grad():
            for emb in (self.dec.token_embedding, self.dec.pos_embedding.embedding):
                emb.weight.normal_(0.0, 0.02, generator=generator)
        self.to(device)
        self.full_shapes: Dict[str, torch.Size] = {k: v.shape
                                                   for k, v in self.state_dict().items()}
        self.data, self.tp = mesh_axis(mesh, "data"), mesh_axis(mesh, "model")
        if mesh is not None:
            self._shard()

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
        return self.decoder["net"]

    def encode(self, images: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 1) -> (B, N_patches + 1, D)."""
        return self.encoder(images)

    def target_mask(self, targets: torch.Tensor) -> torch.Tensor:
        return targets != self.config.pad_token

    def forward(self, images: torch.Tensor, targets: torch.Tensor,
                generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Teacher-forced logits: (B, H, W, 1) images and (B, T) targets ->
        (logits (B, T-1, V), labels targets[:, 1:]), the shifted pair the loss
        is taken over. ``generator`` draws the decoder's dropout mask (none
        without it)."""
        trg_mask = self.target_mask(targets)
        enc = self.encode(images) if self.config.decoder.cross_attend else None
        logits = self.dec(targets[:, :-1], enc, mask=trg_mask[:, :-1], generator=generator)
        return logits, targets[:, 1:]

    def check_decodes(self) -> None:
        """Raises ``ValueError`` unless the decoder has the cross-attention
        layers the cached decode needs: call before encoding for a decode."""
        self.dec.attn_layers.check_decodes()

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
        return self.dec.attn_layers.init_cache(batch, max_len, device,
                                               quant=self.config.self_kv_quant)

    def decoder_cross_kv(self, enc: torch.Tensor):
        return self.dec.attn_layers.precompute_cross_kv(enc, quant=self.config.kv_quant)

    def decoder_step(self, token_t: torch.Tensor, t: int, cache, cross_kv,
                     enc_mask: Optional[torch.Tensor] = None, t0: int = 0) -> torch.Tensor:
        return self.dec.step(token_t, t, cache, cross_kv, enc_mask=enc_mask, t0=t0)


def create_model(config: dict, device="cuda", seed: int = 0) -> OCRModel:
    """The model of a reference-format config dict (``ModelConfig.from_dict``
    validates it) on ``device``, weights drawn from ``seed``."""
    return OCRModel(ModelConfig.from_dict(config), device=device, seed=seed)

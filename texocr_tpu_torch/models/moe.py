"""The feed-forward layers of the ``mla_moe`` decoder: the gated MLP of its
leading dense layers and shared experts, and the routed-expert layer.

Expert layer (DeepSeek-V3's, Kimi-VL-A3B's), for a normalised row x:

- s = sigmoid(W_g x) over the routed experts (float32, ``gate.weight``);
  the top ``num_experts_per_tok`` of s + b (``gate.e_score_correction_bias``;
  one expert group, so group selection is a no-op) are chosen;
- their weights w = s_sel / sum(s_sel) (``norm_topk_prob``) x
  ``routed_scaling_factor``;
- y = sum_i w_i E_i(x) + S(x), E(x) = W_down(silu(W_gate x) * W_up x) at
  ``moe_intermediate_size``, S the same form at ``n_shared_experts`` times it.

The routed product is ``ops/moe_experts.routed`` (the Triton kernels on the
card). The experts' weights are held stacked, (E, I, D) and (E, D, I), and
appear in the state dict under the published checkpoint's per-expert names
(``experts.{e}.gate_proj.weight``, ...). A load stacks them without a copy
where they are the consecutive slices of one tensor, as
``portbench/reference/kimivl.py`` makes them, and with one otherwise.

Each expert layer adds its rows per expert to the device counter
``moe.expert_rows`` ((expert layers, E) int64, ``telemetry.device_counter``),
and 1 for each expert with rows to ``moe.expert_launches`` (so a layer's sum
over its experts is the expert weights its launches read), inside any CUDA
graph that captures it, so replays count too; and 1 to the host counter
``moe.layers`` for each call (``models/graphed.py`` adds a graph's calls
when it replays).
"""

from __future__ import annotations

from typing import List, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from texocr_tpu_torch import telemetry
from texocr_tpu_torch.config import MlaMoeConfig
from texocr_tpu_torch.models.mla import Linear
from texocr_tpu_torch.ops import moe_experts

#: The device counters of routed rows, and of the launches in which each
#: expert had rows: (expert layers, routed experts) each.
EXPERT_ROWS = "moe.expert_rows"
EXPERT_LAUNCHES = "moe.expert_launches"
PROJECTIONS = ("gate_proj", "up_proj", "down_proj")


class GatedMLP(nn.Module):
    """down(silu(gate(x)) * up(x)) in the compute type; takes and returns
    float32 rows. Keys ``gate_proj``, ``up_proj``, ``down_proj``."""

    def __init__(self, dim: int, hidden: int, dtype: torch.dtype, param_dtype: torch.dtype):
        super().__init__()
        self.gate_proj = Linear(dim, hidden, dtype, param_dtype)
        self.up_proj = Linear(dim, hidden, dtype, param_dtype)
        self.down_proj = Linear(hidden, dim, dtype, param_dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.down_proj(F.silu(self.gate_proj(x)) * self.up_proj(x)).float()


class Router(nn.Module):
    """The ``gate`` of an expert layer: (T, D) float32 rows -> (choices (T, k)
    int64, their weights (T, k) float32)."""

    def __init__(self, cfg: MlaMoeConfig, param_dtype: torch.dtype):
        super().__init__()
        self.top_k, self.norm = cfg.num_experts_per_tok, cfg.norm_topk_prob
        self.scaling = cfg.routed_scaling_factor
        self.weight = nn.Parameter(torch.empty(cfg.n_routed_experts, cfg.hidden_size,
                                               dtype=param_dtype))
        self.e_score_correction_bias = nn.Parameter(torch.empty(cfg.n_routed_experts,
                                                                dtype=torch.float32))

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        scores = torch.sigmoid(F.linear(x.float(), self.weight.float()))
        ids = torch.topk(scores + self.e_score_correction_bias.float(), self.top_k, dim=-1).indices
        weights = scores.gather(1, ids)
        if self.norm:
            weights = weights / (weights.sum(-1, keepdim=True) + 1e-20)
        return ids, weights * self.scaling


class Experts(nn.Module):
    """The routed experts' weights, stacked; the state dict names them per
    expert."""

    def __init__(self, cfg: MlaMoeConfig, param_dtype: torch.dtype):
        super().__init__()
        e, d, i = cfg.n_routed_experts, cfg.hidden_size, cfg.moe_intermediate_size
        self.gate_proj = nn.Parameter(torch.empty(e, i, d, dtype=param_dtype))
        self.up_proj = nn.Parameter(torch.empty(e, i, d, dtype=param_dtype))
        self.down_proj = nn.Parameter(torch.empty(e, d, i, dtype=param_dtype))
        self._register_state_dict_hook(_per_expert_keys)
        self._register_load_state_dict_pre_hook(_stacked_keys)


def _per_expert_keys(module: Experts, state: dict, prefix: str, _meta) -> None:
    for name in PROJECTIONS:
        stacked = state.pop(prefix + name)
        for e in range(stacked.shape[0]):
            state[f"{prefix}{e}.{name}.weight"] = stacked[e]


def stack(tensors: List[torch.Tensor]) -> torch.Tensor:
    """The tensors stacked on a new first dimension: a view where they are
    the consecutive slices of one contiguous tensor, else a copy."""
    first = tensors[0]
    n = first.numel()
    if all(t.is_contiguous() and t.shape == first.shape and t.dtype == first.dtype
           and t.untyped_storage().data_ptr() == first.untyped_storage().data_ptr()
           and t.storage_offset() == first.storage_offset() + i * n
           for i, t in enumerate(tensors)):
        return first.new_empty(0).set_(first.untyped_storage(), first.storage_offset(),
                                       (len(tensors), *first.shape))
    return torch.stack(tensors)


def _stacked_keys(state: dict, prefix: str, _meta, _strict, missing: list, _unexpected,
                  _errors) -> None:
    count = 0
    while f"{prefix}{count}.gate_proj.weight" in state:
        count += 1
    if not count:
        return
    for name in PROJECTIONS:
        keys = [f"{prefix}{e}.{name}.weight" for e in range(count)]
        if all(k in state for k in keys):
            state[prefix + name] = stack([state.pop(k) for k in keys])


class MoE(nn.Module):
    """An expert layer: the ``mlp`` of each layer after the leading dense
    ones. ``index`` is its row of ``moe.expert_rows``."""

    def __init__(self, cfg: MlaMoeConfig, index: int, dtype: torch.dtype,
                 param_dtype: torch.dtype):
        super().__init__()
        self.index, self.dtype, self.moe_layers = index, dtype, cfg.moe_layers
        self.gate = Router(cfg, param_dtype)
        self.experts = Experts(cfg, param_dtype)
        self.shared_experts = GatedMLP(cfg.hidden_size,
                                       cfg.moe_intermediate_size * cfg.n_shared_experts,
                                       dtype, param_dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, N, D) float32 normalised rows -> (B, N, D) float32."""
        rows = x.reshape(-1, x.shape[-1])
        ids, weights = self.gate(rows)
        xs = rows.to(self.dtype).contiguous()
        e = self.experts
        y, counts = moe_experts.routed(xs, ids, weights, e.gate_proj.to(self.dtype),
                                       e.up_proj.to(self.dtype), e.down_proj.to(self.dtype))
        shape = (self.moe_layers, counts.shape[0])
        telemetry.device_counter(EXPERT_ROWS, shape, counts.device)[self.index].add_(counts)
        telemetry.device_counter(EXPERT_LAUNCHES, shape, counts.device)[self.index].add_(counts > 0)
        telemetry.count("moe.layers")
        return (y + self.shared_experts(xs)).view(x.shape)

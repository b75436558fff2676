"""The comparisons that decide ``correct``.

Served tokens (greedy): the reference is run once, teacher-forced, over each
sampled image with the tokens it was served, and at every position the gap
by which the served token's logit lies below the reference's best logit is
read; the numbers compared are the widest gap of the sample (``logit_gap``)
and, where a cell's limits name it, the mean over every position
(``mean_gap``). A served row
that ended before ``max_len`` was ended by EOS or PAD, whichever the
reference ranks higher. A control (a lower precision put in the program's
place) is read at the same positions: the gap of the token it ranks first.

Training: each step's loss, the first gradient per parameter (the
program's from Adam's first moment after one step) and each parameter's
change after the compared steps, against the reference's (``train_numbers``).
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from portbench import traffic
from portbench.reference import model as ref

#: Rows the reference decodes at once.
BLOCK = 8

#: The lower precisions a control may put in the program's place.
CONTROLS = {"fp8": ref.Precision(fp8=True), "int4_cache": ref.Precision(cache_bits=4),
            "int8_cache": ref.Precision(cache_bits=8)}


def sample_rows(lengths: Sequence[int], k: int, seed: int) -> List[int]:
    """k row indices drawn from the seed, the longest row among them."""
    n = len(lengths)
    longest = int(np.argmax(lengths))
    others = [i for i in traffic.rng(seed, 9).permutation(n).tolist() if i != longest]
    return sorted([longest] + others[: max(0, min(k, n) - 1)])


def _gaps(logits: torch.Tensor, picks: torch.Tensor) -> torch.Tensor:
    return logits.max(-1).values - logits.gather(-1, picks[..., None])[..., 0]


class Gaps:
    """Gaps of the served tokens (``program``) and of each control's
    first-ranked tokens at the same positions, gathered over blocks:
    ``logit_gap`` is the widest, ``mean_gap`` the mean over every position."""

    def __init__(self, controls: Sequence[str] = ()):
        self.sides = ["program", *controls]
        self.widest = {s: 0.0 for s in self.sides}
        self.total = {s: 0.0 for s in self.sides}
        self.positions = {s: 0 for s in self.sides}
        self.rows = self.tokens = 0

    def add(self, side: str, gaps: torch.Tensor) -> None:
        self.widest[side] = max(self.widest[side], float(gaps.max()))
        self.total[side] += float(gaps.sum())
        self.positions[side] += gaps.numel()

    def numbers(self) -> Dict[str, Dict[str, float]]:
        return {s: {"logit_gap": self.widest[s],
                    "mean_gap": self.total[s] / max(self.positions[s], 1)} for s in self.sides}


def token_gaps(acc: Gaps, canvases: torch.Tensor, served: List[List[int]], params: ref.Params,
               arch: ref.Arch, max_len: int) -> None:
    """Adds to ``acc`` the gaps of the served tokens of ``canvases`` (B, H,
    W) uint8 of one shape, and of each control's first-ranked tokens."""
    end = (arch.eos, arch.pad)
    device = canvases.device
    acc.rows += len(served)
    acc.tokens += sum(len(r) for r in served)
    for lo in range(0, len(served), BLOCK):
        rows = served[lo: lo + BLOCK]
        # A row cut short was ended by EOS or PAD: one more position.
        n_pos = [min(len(r) + 1, max_len) for r in rows]
        width = max(n_pos)
        inp = torch.full((len(rows), width), arch.bos, dtype=torch.long)
        for i, r in enumerate(rows):
            inp[i, 1: n_pos[i]] = torch.tensor(r[: n_pos[i] - 1], dtype=torch.long)
        inp = inp.to(device)
        x = ref.model_input(canvases[lo: lo + BLOCK])
        with torch.no_grad():
            logits = ref.decode_logits(inp, ref.encode(x, params, arch), params, arch)
            for i, r in enumerate(rows):
                lg = logits[i, : n_pos[i]]
                got = torch.tensor(r[: n_pos[i]], dtype=torch.long, device=device)
                g = _gaps(lg[: len(got)], got)
                if len(got) < n_pos[i]:
                    last = lg[len(got)]
                    g = torch.cat([g, (last.max() - last[list(end)].max())[None]])
                acc.add("program", g)
            for c in acc.sides[1:]:
                prec = CONTROLS[c]
                low = ref.decode_logits(inp, ref.encode(x, params, arch, prec), params, arch,
                                        prec)
                for i in range(len(rows)):
                    acc.add(c, _gaps(logits[i, : n_pos[i]], low[i, : n_pos[i]].argmax(-1)))
                del low
            del logits


def served_gaps(served: List[Tuple[np.ndarray, List[int]]], params: ref.Params, arch: ref.Arch,
                *, max_len: int, sample: int, seed: int, controls: Sequence[str] = ()) -> Gaps:
    """``token_gaps`` over a seeded sample of (image, served ids) pairs,
    the longest among them, grouped by canvas."""
    picked = sample_rows([len(ids) for _, ids in served], sample, seed)
    groups: Dict[tuple, list] = {}
    for i in picked:
        img, ids = served[i]
        c = ref.to_canvas(img, arch)
        groups.setdefault(c.shape, []).append((c, ids))
    device = next(iter(params.values())).device
    acc = Gaps(controls)
    for items in groups.values():
        canv = torch.from_numpy(np.stack([c for c, _ in items])).to(device)
        with ref.float32_products():
            token_gaps(acc, canv, [list(i) for _, i in items], params, arch, max_len)
    return acc


def relative(values: Dict[str, float], reference: Dict[str, float],
             keys: Sequence[str]) -> List[Tuple[float, str]]:
    """Each key's value over max(its reference norm, the median key's),
    largest first."""
    med = float(np.median([reference[k] for k in keys]))
    return sorted(((values[k] / max(reference[k], med, 1e-30), k) for k in keys), reverse=True)


def train_numbers(program: dict, reference: dict) -> Dict[str, object]:
    """The training numbers, each as a share of the reference's norm of a
    parameter or of the median parameter's, whichever is larger:

    - ``loss_gap``: the worst step's |loss - reference| / reference;
    - ``grad_gap``: the median parameter's gap between the first gradient's
      norms (the worst parameter's is ``grad_worst``);
    - ``change_gap``: the median parameter's gap between the norms of its
      change after the compared steps (worst: ``change_worst``), leaving out
      parameters whose reference gradient is under a thousandth of the
      median parameter's, which rounding alone moves;
    - ``grad_error``: the median parameter's norm of the first gradient's
      difference from the reference's.

    ``grad1`` holds each parameter's first gradient, ``change`` the norm of
    its change."""
    losses = [abs(p - r) / abs(r) for p, r in zip(program["losses"], reference["losses"])]
    ref_g = {k: float(torch.linalg.vector_norm(g)) for k, g in reference["grad1"].items()}
    keys = list(ref_g)
    prog_g = {k: float(torch.linalg.vector_norm(program["grad1"][k])) for k in keys}
    diff = {k: float(torch.linalg.vector_norm(program["grad1"][k] - reference["grad1"][k]))
            for k in keys}
    grads = relative({k: abs(prog_g[k] - ref_g[k]) for k in keys}, ref_g, keys)
    errors = relative(diff, ref_g, keys)
    med = float(np.median(list(ref_g.values())))
    moved = [k for k in keys if ref_g[k] >= 1e-3 * med]
    changes = relative({k: abs(program["change"][k] - reference["change"][k]) for k in moved},
                       reference["change"], moved)

    def median(pairs):
        return float(np.median([v for v, _ in pairs]))

    return {"loss_gap": max(losses), "grad_gap": median(grads),
            "change_gap": median(changes), "grad_error": median(errors),
            "grad_worst": grads[:3], "change_worst": changes[:3], "error_worst": errors[:3],
            "left_out": sorted(set(keys) - set(moved))}

"""The weights, made on the card from the seed, and handed to both sides.

Each leaf the reference model names (``Model.leaf_specs``) is made by its
init rule in blocks of ``ROWS_PER_CALL`` rows, block k of leaf i from a
card generator seeded by ``(seed, i, k)``: a block can be made again alone,
so the change of a leaf after some steps is read block by block without a
copy of the whole table.  The program receives the same values in its own
layout: a table under its fused touched-rows optimizer takes them in its
parameter columns and the program's own initial slot values beside them.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, List, Tuple

import numpy as np
import torch

from reference.model import init_block, init_leaf

ROWS_PER_CALL = 1 << 21


def _gen_seed(seed: int, leaf: int, block: int) -> int:
    return int(np.random.SeedSequence([int(seed), leaf, block])
               .generate_state(1, np.uint64)[0]) & ((1 << 63) - 1)


class Weights:
    def __init__(self, specs: List[Tuple[str, Tuple[int, ...], Any, str]],
                 seed: int, device):
        self.specs = specs
        self.index = {s[0]: i for i, s in enumerate(specs)}
        self.seed = int(seed)
        self.device = torch.device(device)

    def _gen(self, leaf: int, block: int) -> torch.Generator:
        return torch.Generator(device=self.device).manual_seed(
            _gen_seed(self.seed, leaf, block))

    def leaf(self, path: str) -> torch.Tensor:
        i = self.index[path]
        return init_leaf(self.specs[i], lambda k: self._gen(i, k),
                         self.device, ROWS_PER_CALL)

    def blocks(self, path: str) -> Iterator[Tuple[int, torch.Tensor]]:
        """(first row, block) of a leaf's initial values."""
        i = self.index[path]
        spec = self.specs[i]
        for k, lo in enumerate(range(0, spec[1][0], ROWS_PER_CALL)):
            yield lo, init_block(spec, k, self._gen(i, k), self.device,
                                 ROWS_PER_CALL)

    def change_norm(self, path: str, current: torch.Tensor) -> float:
        """||current - initial|| of a leaf (``current`` in the leaf's
        logical shape), summed in float64, block by block."""
        total = 0.0
        current = current.detach()
        for lo, block in self.blocks(path):
            d = current[lo:lo + block.shape[0]].float() - block.float()
            total += float(torch.sum(d * d, dtype=torch.float64))
        return total ** 0.5

    def all(self) -> Dict[str, torch.Tensor]:
        return {s[0]: self.leaf(s[0]) for s in self.specs}


def const_change_norm(current: torch.Tensor, start: float) -> float:
    """||current - start|| of a tensor that started at the constant
    ``start`` (an optimizer slot), summed in float64, block by block of
    rows."""
    total = 0.0
    current = current.detach()
    for lo in range(0, current.shape[0], ROWS_PER_CALL):
        d = current[lo:lo + ROWS_PER_CALL].float() - start
        total += float(torch.sum(d * d, dtype=torch.float64))
    return total ** 0.5

"""Paged KV block pool: the fixed-shape device tensors and the host-side
block allocator (counterpart of ``rocket_tpu/serve/kv_pool.py``).

The pool is two ``(L, num_blocks, block_len, Hkv, D)`` tensors allocated
once, sized independently of how many requests flow through. Requests own
blocks, handed out as integer ids on the host; the engine indexes the pool
through per-slot block tables. Block 0 is reserved as the trash sink
(masked writes land there, unmapped table entries point at it) and is
never allocated.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

__all__ = ["KVPoolSpec", "BlockAllocator"]


@dataclass(frozen=True)
class KVPoolSpec:
    """Shape of the paged pool for one model."""

    num_layers: int
    num_blocks: int
    block_len: int
    num_kv_heads: int
    head_dim: int
    dtype: str = "float32"

    def __post_init__(self):
        if self.num_blocks < 2:
            raise ValueError(
                "KVPoolSpec: need at least 2 blocks (block 0 is the reserved "
                f"trash sink), got {self.num_blocks}"
            )
        if self.block_len < 1:
            raise ValueError(f"KVPoolSpec: block_len {self.block_len} < 1")

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @property
    def block_bytes(self) -> int:
        """Device bytes ONE block costs across K+V and all layers."""
        itemsize = torch.empty((), dtype=self.torch_dtype).element_size()
        return 2 * self.num_layers * self.block_len * self.num_kv_heads * self.head_dim * itemsize

    @property
    def pool_bytes(self) -> int:
        """The whole pool: ``num_blocks * block_bytes``."""
        return self.num_blocks * self.block_bytes

    def init_pages(self, device=None):
        """The zeroed pool ``(k_pages, v_pages)``, each ``(L, NB, BL, Hkv, D)``."""
        shape = (self.num_layers, self.num_blocks, self.block_len,
                 self.num_kv_heads, self.head_dim)
        return (torch.zeros(shape, dtype=self.torch_dtype, device=device),
                torch.zeros(shape, dtype=self.torch_dtype, device=device))


class BlockAllocator:
    """Free list over block ids ``1 .. num_blocks-1``.

    ``alloc(n)`` is all-or-nothing; double alloc, double free and freeing
    the reserved block raise.
    """

    RESERVED = 0  # the trash block, never allocated

    def __init__(self, num_blocks: int) -> None:
        if num_blocks < 2:
            raise ValueError(f"BlockAllocator: need at least 2 blocks, got {num_blocks}")
        self.num_blocks = num_blocks
        self._free = list(range(num_blocks - 1, 0, -1))  # pop() hands out low ids first
        self._used: set[int] = set()

    @property
    def capacity(self) -> int:
        """Allocatable blocks (the trash block excluded)."""
        return self.num_blocks - 1

    @property
    def num_free(self) -> int:
        return len(self._free)

    @property
    def num_used(self) -> int:
        return len(self._used)

    @property
    def free_fraction(self) -> float:
        return len(self._free) / max(self.capacity, 1)

    def alloc(self, n: int = 1) -> Optional[list[int]]:
        """``n`` block ids, or None when the pool cannot serve all of them
        (the caller applies back-pressure or evicts)."""
        if n < 0:
            raise ValueError(f"BlockAllocator.alloc: n {n} < 0")
        if n > len(self._free):
            return None
        blocks = [self._free.pop() for _ in range(n)]
        self._used.update(blocks)
        return blocks

    def free(self, blocks) -> None:
        for block in blocks:
            if block == self.RESERVED:
                raise ValueError("BlockAllocator.free: block 0 is the reserved trash sink")
            if block not in self._used:
                raise ValueError(
                    f"BlockAllocator.free: block {block} is not allocated (double free?)"
                )
            self._used.remove(block)
            self._free.append(block)

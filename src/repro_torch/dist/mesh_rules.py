"""The batch half of the sharding rules (counterpart of the batch part
of ``repro/dist/mesh_rules.py``'s ``Rules``), as host arithmetic.

Axes: ``pod`` (data parallel across pods: batch only, parameters stay
replicated and gradients cross the long haul through
``dist.lcmp_collectives``), ``data`` (FSDP: the batch dim of inputs)
and ``model`` (tensor parallel). A spec is a tuple with one entry per
dimension, where the reference builds a ``PartitionSpec``: the mesh
axes that shard the dimension, or None. The parameter and cache specs
wait for the sharded step (ROADMAP.md queue A item 9).
"""
from __future__ import annotations

from typing import Dict


class Rules:
    """Batch spec builders bound to one arch config and one mesh shape
    (``{axis_name: size}``)."""

    def __init__(self, cfg, axis_sizes: Dict[str, int]):
        self.cfg = cfg
        self.axis_sizes = dict(axis_sizes)
        self.data = int(axis_sizes.get("data", 1))
        self.model = int(axis_sizes.get("model", 1))
        self.pod = int(axis_sizes.get("pod", 1))

    @property
    def _dp_size(self) -> int:
        return self.pod * self.data

    def _batch_axes(self, batch: int):
        """Axes for a batch dim (pods are plain data-parallel for inputs)."""
        if self._dp_size <= 1 or batch % self._dp_size != 0:
            return None
        return ("pod", "data") if self.pod > 1 else "data"

    def train_batch_specs(self, batch: int, seq: int) -> Dict[str, tuple]:
        b = self._batch_axes(batch)
        return {"tokens": (b, None), "labels": (b, None),
                "extra": (b, None, None)}

    def decode_token_spec(self, batch: int) -> tuple:
        return (self._batch_axes(batch), None)

"""Shape buckets: the padded capacities of an eval batch.

Counterpart of ``segdino3d_tpu/data/bucketing.py``, with the same rungs.
Ragged scenes pad to the smallest rung of a geometric ladder that holds
them, which bounds the padding waste and the number of distinct batch
shapes (the eval loader pins one plan capacity vector per rung).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence

from segdino3d_tpu_torch.data.collate import PadSpec


def geometric_ladder(lo: int, hi: int, ratio: float = 1.35,
                     multiple: int = 1024) -> List[int]:
    """Capacities lo..hi spaced by ~ratio, rounded up to a multiple."""
    out = []
    x = float(lo)
    while True:
        v = -(-int(x) // multiple) * multiple
        if not out or v > out[-1]:
            out.append(v)
        if v >= hi:
            break
        x *= ratio
    return out


@dataclass(frozen=True)
class BucketPolicy:
    point_buckets: Sequence[int]
    sp_buckets: Sequence[int]
    inst_buckets: Sequence[int]
    q2d_buckets: Sequence[int]
    num_semantic_classes: int = 200

    @staticmethod
    def default(num_semantic_classes: int = 200, max_points: int = 524288,
                max_superpoints: int = 8192, max_instances: int = 256,
                max_queries2d: int = 256) -> "BucketPolicy":
        """The ladders' floors clamp to the caps, so that a small config
        does not pad up to full-size rungs."""
        return BucketPolicy(
            point_buckets=geometric_ladder(
                min(32768, max_points), max_points, 1.4,
                min(8192, max_points)),
            sp_buckets=geometric_ladder(
                min(512, max_superpoints), max_superpoints, 1.5,
                min(256, max_superpoints)),
            inst_buckets=tuple(b for b in (32, 64, 128, 256)
                               if b < max_instances) + (max_instances,),
            q2d_buckets=tuple(b for b in (32, 64, 128, 256)
                              if b < max_queries2d) + (max_queries2d,),
            num_semantic_classes=num_semantic_classes)

    @staticmethod
    def _pick(buckets: Sequence[int], n: int) -> int:
        for b in buckets:
            if n <= b:
                return b
        raise ValueError(f"{n} exceeds the largest bucket {buckets[-1]}")

    def spec_for(self, records) -> PadSpec:
        """The smallest rungs that hold every record of a batch."""
        p = max(r["points"].shape[0] for r in records)
        s = max(int(r["superpoint_ids"].max()) + 1 for r in records)
        i = max(len(r["inst_labels"]) for r in records)
        k = max((0 if r.get("query2d_pos") is None
                 else r["query2d_pos"].shape[0]) for r in records)
        return PadSpec(self._pick(self.point_buckets, p),
                       self._pick(self.sp_buckets, s),
                       self._pick(self.inst_buckets, i),
                       self._pick(self.q2d_buckets, max(k, 1)),
                       self.num_semantic_classes)

    def n_programs_bound(self) -> int:
        """Upper bound on the distinct batch shapes."""
        return (len(self.point_buckets) * len(self.sp_buckets)
                * len(self.inst_buckets) * len(self.q2d_buckets))

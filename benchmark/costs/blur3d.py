"""Least time of separable 3-D blurs: a float32 (Z, Y, X) volume read once
and written once; tz + ty + tx multiply-adds a voxel on the float32 cores."""

from typing import Iterable, Tuple

from benchmark.costs.peaks import FP32_FLOPS, least_seconds


def launch_cost(z: int, y: int, x: int, tz: int, ty: int, tx: int
                ) -> Tuple[float, float]:
    """(bytes, operations) of one blur of a (z, y, x) volume."""
    voxels = z * y * x
    return 8.0 * voxels, 2.0 * voxels * (tz + ty + tx)


def least_total_seconds(launches: Iterable[Tuple[tuple, int]]) -> float:
    """Sum of the least times of ``(shape + taps, count)`` launches, each
    bounded on its own."""
    return sum(n * least_seconds(*launch_cost(*key), FP32_FLOPS)
               for key, n in launches)

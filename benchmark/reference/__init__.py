"""Plain references of the benchmark's scenes (one module a ``kind``)."""
import torch


def f32(v: float) -> float:
    """``v`` rounded to float32: a threshold of a discrete decision that
    the configuration takes in float32."""
    return float(torch.tensor(v, dtype=torch.float32))

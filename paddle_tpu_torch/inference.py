"""The pad-to-bucket rule of ``paddle_tpu/inference.py`` (``pick_bucket``,
:23-43), which the bucketed serving fallback sizes its prefill launches
with. The port keeps its own copy: the JAX module's ``Predictor`` is not
ported."""
from __future__ import annotations

__all__ = ["pick_bucket"]


def pick_bucket(n, buckets, strict=False):
    """Smallest bucket >= ``n``. When ``n`` exceeds the largest bucket the
    default clamps down to it (callers that split oversize batches
    themselves); ``strict=True`` raises instead, for callers whose launch
    sized by a clamped-down bucket would index past its padding and
    silently truncate the round."""
    for b in buckets:
        if b >= n:
            return b
    if strict:
        raise ValueError(
            f"batch of {n} exceeds the largest configured bucket "
            f"{buckets[-1]} — split the round or widen the bucket set "
            "(a clamped-down launch would truncate the round)")
    return buckets[-1]

"""Fixed (polynomial) predictor statistics, batched.

The order-k fixed residual is the k-th difference of the signal, because
the fixed predictor taps are the binomial coefficients, so all five
orders come from one chain of first differences.
"""

from __future__ import annotations

import torch

from flacx_torch.ops.rice import zigzag


def shift_right_one(x: torch.Tensor) -> torch.Tensor:
    """x[..., i] -> x[..., i-1], zero-filling position 0."""
    return torch.cat([torch.zeros_like(x[..., :1]), x[..., :-1]], dim=-1)


def fixed_order_zz_sums(x: torch.Tensor) -> torch.Tensor:
    """Exact zigzag magnitude sums of all five fixed-order residuals.

    ``out[..., o] = Σ_i zigzag(Δᵒx)[i] · (i >= o)`` — the candidate-size
    statistic the encoder ranks fixed predictors by.  Differences and
    zigzag stay in the input dtype (int32 for the encoder, exact for
    samples up to 26 bits); sums are int64.

    Args:
      x: integer samples ``[..., n]``.
    Returns:
      ``[..., 5]`` int64.
    """
    n = x.shape[-1]
    i_pos = torch.arange(n, dtype=torch.int32, device=x.device)
    cols = []
    cur = x
    for o in range(5):
        if o:
            cur = cur - shift_right_one(cur)
        cols.append((zigzag(cur) * (i_pos >= o)).sum(-1, dtype=torch.int64))
    return torch.stack(cols, dim=-1)

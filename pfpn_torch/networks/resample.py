"""PFPN particle resampling.

Counterpart of ``pfpn_tpu/networks/resample.py``. A particle is dead when its largest weight over the interval is below the
threshold (default 0.05 / N). Each dead slot takes a candidate particle,
drawn per dimension in proportion to the average weights (``resample < 0``)
or uniformly from the ``resample`` most active; it receives the candidate's
mean (jittered by +-std uniform noise, at least 1e-4 in magnitude), log-std
and logit column, and the candidate's logit bias drops by
log(count + 1) so that the weight mass is preserved. For a squashed head
with fixed stds the jitter is added in tanh space and taken back through
atanh of the value clipped to +-(1 - 1e-6) (``resample.py:84-101``); with
trainable stds it is added in the particle's own (atanh) space, the JAX
package's documented deviation from the reference (``resample.py:21-24``).

The random draws (:func:`resample_draws`) are kept apart from the dense
surgery (:func:`resample_apply`), so a test can feed the JAX package's
draws to the port. The surgery edits the head's parameters in place under
``torch.no_grad()``: the optimizer's Adam moments of the resampled entries
stay stale, as in the reference.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from .heads import ParticleHead, ParticleHeadModule


def _threshold(cfg: ParticleHead) -> float:
    return cfg.resample_threshold if cfg.resample_threshold else 0.05 / cfg.particles


def resample_draws(cfg: ParticleHead, stats: Dict,
                   generator: Optional[torch.Generator]) -> Tuple[torch.Tensor, torch.Tensor]:
    """(candidate particle per slot [D, N] int64, uniform jitter in [-1, 1)
    [D, N]) (resample.py:49-62)."""
    d, n = cfg.action_dim, cfg.particles
    sum_active = stats["sum_active"]
    dev = sum_active.device
    total = torch.sum(sum_active, 1, keepdim=True)
    avg = torch.where(total > 0, sum_active / torch.clamp(total, min=1e-12),
                      torch.full_like(sum_active, 1.0 / n))
    if cfg.resample < 0:
        # a candidate per slot ~ Categorical(average weight)
        cand = torch.multinomial(torch.clamp(avg, min=1e-12), n, replacement=True,
                                 generator=generator)
    else:
        k = min(n, cfg.resample)
        top = torch.topk(avg, k, dim=1).indices
        choice = torch.randint(0, k, (d, n), generator=generator, device=dev)
        cand = torch.gather(top, 1, choice)
    u = 2.0 * torch.rand(d, n, generator=generator, device=dev) - 1.0
    return cand, u


@torch.no_grad()
def resample_apply(cfg: ParticleHead, head: ParticleHeadModule, stats: Dict,
                   cand: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """The dense surgery of resample.py:64-145, in place on ``head``.
    Returns the source particle of every slot [D, N] (itself where alive)."""
    d, n = cfg.action_dim, cfg.particles
    invalid = stats["max_active"] < _threshold(cfg)
    slots = torch.arange(n, device=cand.device).expand(d, n)
    tgt = torch.where(invalid, cand, slots)

    # logit bias mass splitting (resample.py:66-73)
    b = head.fc_policy.bias.reshape(d, n)
    inv_f = invalid.to(b.dtype)
    count = torch.zeros_like(b).scatter_add_(1, tgt, inv_f)
    new_bias = b - torch.log(count + 1.0 - inv_f)
    b1 = torch.where(count > 0, new_bias, b)
    b2 = torch.where(invalid, torch.gather(new_bias, 1, tgt), b1)

    # logit weight column copy (resample.py:75-80); weight is (D N, feat)
    w = head.fc_policy.weight
    w_r = w.reshape(d, n, -1)
    w_t = torch.gather(w_r, 1, tgt[..., None].expand_as(w_r))
    w_new = torch.where(invalid[..., None], w_t, w_r)

    # particle mean / log-std copy and jitter (resample.py:83-145)
    loc = head.particles
    log_std = head.log_std_tensor()
    tgt_loc = torch.gather(loc, 1, tgt)
    tgt_log_std = torch.gather(log_std, 1, tgt)
    if not cfg.fixed_sigma:
        tgt_log_std = torch.clamp(tgt_log_std, -20.0, 2.0)
    noise = torch.exp(tgt_log_std) * u
    noise = noise + torch.where(noise < 0, -1e-4, 1e-4)
    if cfg.squash and cfg.fixed_sigma:
        moved = torch.atanh(torch.clamp(torch.tanh(tgt_loc) + noise, 1e-6 - 1.0, 1.0 - 1e-6))
    else:
        moved = tgt_loc + noise
    new_loc = torch.where(invalid, moved, loc)

    head.fc_policy.bias.copy_(b2.reshape(d * n))
    head.fc_policy.weight.copy_(w_new.reshape(w.shape))
    head.particles.copy_(new_loc)
    if not cfg.fixed_sigma:
        log_std.copy_(torch.where(invalid, tgt_log_std, log_std))
    return tgt


def resample(cfg: ParticleHead, head: ParticleHeadModule, stats: Dict,
             generator: Optional[torch.Generator]) -> torch.Tensor:
    """Draw and apply (resample.py:40)."""
    cand, u = resample_draws(cfg, stats, generator)
    return resample_apply(cfg, head, stats, cand, u)


def maybe_resample(cfg: ParticleHead, head: ParticleHeadModule, stats: Dict,
                   generator: Optional[torch.Generator]) -> Dict:
    """Per-optimizer-step hook (resample.py:113): count the step; at the
    interval, resample and clear the accumulators. Returns the new stats;
    the identity when ``cfg.resample`` is 0."""
    if not cfg.resample:
        return stats
    flag = stats["train_flag"] + 1
    if flag < cfg.resample_interval:
        return {**stats, "train_flag": flag}
    resample(cfg, head, stats, generator)
    return {"max_active": torch.zeros_like(stats["max_active"]),
            "sum_active": torch.zeros_like(stats["sum_active"]),
            "train_flag": 0}

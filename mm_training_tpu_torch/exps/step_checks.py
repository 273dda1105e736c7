"""Two train steps taken from the same weights, compared: the update where
the gradient is strong (Adam's step is sign(g) there), everywhere, and the
BN statistics. ``chip_smoke.py`` and ``exps/ddp_cards.py`` hold a step to
another with them.
"""
from __future__ import annotations

import torch

__all__ = ['step_comparison', 'step_diffs', 'within_step_tolerances']


def _update_diffs(got_model, want_model, old):
    """{name: |update difference|} of two models stepped once from the
    parameters ``old`` ({name: host tensor}), and {name: the reference
    step's parameter}, on the host."""
    diffs, want = {}, {}
    for (n, p_got), p_want in zip(got_model.named_parameters(), want_model.parameters()):
        want[n] = p_want.detach().cpu()
        diffs[n] = ((p_got.detach().cpu() - old[n]) - (want[n] - old[n])).abs()
    return diffs, want


def _worst(diffs, want_mu):
    """(largest update difference, the same where the gradient is strong)
    of {name: |update difference|} and the names of the tensors where each
    is taken; ``want_mu`` the reference step's Adam first moments."""
    worst_all = worst_strong = 0.0
    at = ['', '']
    for (n, d), mu in zip(diffs.items(), want_mu):
        if d.max().item() > worst_all:
            at[0] = n
        worst_all = max(worst_all, d.max().item())
        # fp32 gradients of a random init are ill-conditioned (BN subtracts a
        # near-constant gradient, so sums in another order move small entries
        # by up to ~10% of a tensor's largest): hold the update to 1e-3 lr
        # only where |g| is a quarter of its tensor's largest or more and
        # 400 x Adam's eps or more, where Adam's step is sign(g) to 1e-3
        g = mu.abs().cpu() / 0.1
        strong = (g >= 0.25 * g.max()) & (g >= 400 * 1e-8)
        if torch.where(strong, d, 0.0).max().item() > worst_strong:
            at[1] = n
        worst_strong = max(worst_strong, torch.where(strong, d, 0.0).max().item())
    return worst_all, worst_strong, at


def _bn_stats_diff(got_model, want_model):
    """Largest BN running-statistics difference relative to 1 + |statistic|,
    and the buffer where it is taken."""
    err, at = 0.0, ''
    for (n, b_got), b_want in zip(got_model.named_buffers(), want_model.buffers()):
        if n.endswith(('running_mean', 'running_var')):
            b_want = b_want.cpu()
            e = ((b_got.cpu() - b_want).abs() / (1 + b_want.abs())).max().item()
            if e > err:
                err, at = e, n
    return err, at


def step_diffs(got_model, want_model, old, want_mu):
    """(largest update difference, the same where the gradient is strong,
    largest BN statistics difference relative to 1 + |statistic|) of two
    models stepped once from the parameters ``old`` ({name: host tensor}),
    ``want_mu`` the reference step's Adam first moments; and the names of
    the tensors where each is taken."""
    diffs, _ = _update_diffs(got_model, want_model, old)
    worst_all, worst_strong, at = _worst(diffs, want_mu)
    stats_err, at_stats = _bn_stats_diff(got_model, want_model)
    return worst_all, worst_strong, stats_err, at + [at_stats]


def step_comparison(got, got_metrics, want, want_state, want_metrics, old):
    """The data-parallel step held to the plain one: :func:`step_diffs`,
    except that an update difference counts only beyond one float32 ulp of
    the stepped parameter (a BN scale in [0.5, 1) holds its update of ~lr to
    6.0e-8, 3.2e-3 of the camera step's lr of 1.875e-5 at B=4), with the
    losses' relative difference, the update in units of the step's learning
    rate."""
    lr = want_state.optimizer.schedule(0)
    diffs, p_want = _update_diffs(got, want, old)
    eps = torch.finfo(torch.float32).eps
    diffs = {n: (d - eps * p_want[n].abs()).clamp_min(0.0) for n, d in diffs.items()}
    worst_all, worst_strong, at = _worst(diffs, want_state.optimizer.mu)
    stats_err, at_stats = _bn_stats_diff(got, want)
    loss, want_loss = float(got_metrics['train_loss']), float(want_metrics['train_loss'])
    return {'loss_rel': abs(loss - want_loss) / abs(want_loss), 'update_all_lr': worst_all / lr,
            'update_strong_lr': worst_strong / lr, 'bn_stats': stats_err,
            'at': at + [at_stats]}


def within_step_tolerances(diff):
    """Phase 12's step tolerances on a :func:`step_comparison`: loss and BN
    statistics within 1e-5, the update within 2.001 lr everywhere (two
    opposite Adam steps of lr (1 + weight decay) at most) and within 1e-3 lr
    where the gradient is strong."""
    return (diff['loss_rel'] <= 1e-5 and diff['bn_stats'] <= 1e-5
            and diff['update_all_lr'] <= 2.001 and diff['update_strong_lr'] <= 1e-3)

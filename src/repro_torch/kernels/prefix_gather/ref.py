"""Plain torch versions of the prefix-table gather kernels."""
from __future__ import annotations

import torch


def prefix_select_plain(pref0: torch.Tensor, pref1: torch.Tensor,
                        rows: torch.Tensor, start: torch.Tensor,
                        end: torch.Tensor, split: torch.Tensor,
                        t0: torch.Tensor, t1: torch.Tensor):
    """Gather -> split-K select -> per-system segment reduce.

    ``pref0``/``pref1`` are ``[F, R, T+1]`` prefix-sum stacks (tile axes
    may differ and may be padded past the true totals);
    ``rows``/``start``/``end`` are ``[P, C]``; ``split``/``t0``/``t1``
    per-system ``[P]``. Ranges clip to the per-row true tile totals, then
    the split selector picks which table's difference survives. Returns
    ``(sel [P, C, F], total [P, F])`` in the tables' dtype — the plain
    jnp gather of the reference evaluator, written in torch."""
    rows = rows.long()

    def gather(pref, t):
        s = torch.minimum(torch.clamp(start.long(), min=0), t[:, None])
        e = torch.minimum(torch.clamp(end.long(), min=0), t[:, None])
        d = pref[:, rows, e] - pref[:, rows, s]  # [F, P, C]
        return d.permute(1, 2, 0)

    sel = torch.where((split == 1)[:, None, None],
                      gather(pref1, t1.long()), gather(pref0, t0.long()))
    return sel, sel.sum(dim=1)


def prefix_segment_plain(pref: torch.Tensor, rows: torch.Tensor,
                         start: torch.Tensor, end: torch.Tensor):
    """Per-slot prefix differences and their per-system totals.

    ``pref`` is a ``[R, T+1]`` prefix-sum table; ``rows``/``start``/``end``
    are ``[P, C]`` indices, used as they are (no clipping). Returns
    ``(diff [P, C], total [P])`` in the table's dtype, with ``diff[p, c] =
    pref[rows[p, c], end[p, c]] - pref[rows[p, c], start[p, c]]`` and
    ``total`` summed in slot order from slot 0's difference, as the
    kernel sums (floating-point totals depend on that order)."""
    rows = rows.long()
    diff = pref[rows, end.long()] - pref[rows, start.long()]
    total = diff[:, 0].clone()
    for c in range(1, diff.shape[1]):
        total = total + diff[:, c]
    return diff, total

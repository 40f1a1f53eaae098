"""Spatially bucketed keypoint selection (counterpart of
orb_slam2_2021_tpu/ops/select.py `select_keypoints_batched`).

Each cell yields its top-K corners by iterative first-occurrence argmax;
the cells' candidates are then ranked globally by the (cell rank, -response)
key with a stable descending sort, so equal keys keep index order exactly as
the reference's `lax.top_k`.
"""

from __future__ import annotations

import torch

K_PER_CELL = 8


def select_keypoints_batched(strict_score, relaxed_score, n_top: int, cell: int):
    """[B, H, W] score maps (H, W multiples of `cell`) -> (ys, xs, scores,
    valid), each [B, n_top], in (cell-rank, -response) order."""
    B, hp, wp = strict_score.shape
    hc, wc = hp // cell, wp // cell
    dev = strict_score.device

    def cells(x):
        return (
            x.reshape(B, hc, cell, wc, cell)
            .permute(0, 1, 3, 2, 4)
            .reshape(B, hc * wc, cell * cell)
        )

    s_cells = cells(strict_score)
    r_cells = cells(relaxed_score)
    has_strict = torch.amax(s_cells, dim=2, keepdim=True) > 0.0
    x = torch.where(has_strict, s_cells, r_cells)

    k = min(K_PER_CELL, cell * cell)
    neg_inf = torch.tensor(float("-inf"), dtype=x.dtype, device=dev)
    vals_l, idx_l = [], []
    for _ in range(k):
        i = torch.argmax(x, dim=2)                                    # [B, C]
        vals_l.append(torch.gather(x, 2, i[..., None])[..., 0])
        idx_l.append(i)
        x = x.scatter(2, i[..., None], neg_inf.expand(B, hc * wc, 1))
    # float32 from here: the rank * 1e5 separation must dominate exactly
    vals = torch.stack(vals_l, dim=2).to(torch.float32)               # [B, C, k]
    idx = torch.stack(idx_l, dim=2).to(torch.int32)
    rank = torch.arange(k, dtype=torch.float32, device=dev)[None, None, :]

    flat_vals = vals.reshape(B, -1)
    flat_rank = rank.expand(vals.shape).reshape(B, -1)
    cell_ids = (
        torch.arange(hc * wc, dtype=torch.int32, device=dev)[None, :, None]
        .expand(vals.shape).reshape(B, -1)
    )
    flat_idx = idx.reshape(B, -1)

    valid = flat_vals > 0.0
    key = torch.where(
        valid, -flat_rank * 1e5 + torch.clamp_max(flat_vals, 9e4),
        torch.tensor(float("-inf"), device=dev),
    )
    n_take = min(n_top, key.shape[1])
    top_keys, top_pos = torch.sort(key, dim=1, descending=True, stable=True)
    top_keys, top_pos = top_keys[:, :n_take], top_pos[:, :n_take]

    sel_cell = torch.gather(cell_ids, 1, top_pos)
    sel_inner = torch.gather(flat_idx, 1, top_pos)
    sel_val = torch.gather(flat_vals, 1, top_pos)
    sel_valid = torch.isfinite(top_keys) & (sel_val > 0.0)

    ys = (sel_cell // wc) * cell + sel_inner // cell
    xs = (sel_cell % wc) * cell + sel_inner % cell
    if n_take < n_top:
        pad = (0, n_top - n_take)
        ys, xs = torch.nn.functional.pad(ys, pad), torch.nn.functional.pad(xs, pad)
        sel_val = torch.nn.functional.pad(sel_val, pad)
        sel_valid = torch.nn.functional.pad(sel_valid.to(torch.uint8), pad).bool()
    return ys.to(torch.int32), xs.to(torch.int32), sel_val, sel_valid

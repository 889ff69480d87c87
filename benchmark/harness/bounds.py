"""The yardstick of the kernel metrics: the card's published peak and the
bytes that one call of a kernel's operation needs, counted from the live
data of the table it runs on (never from padding, size buckets or the
kernel that implements it).

K1, the patch apply  out = sum_p R_p^T A_p R_p x  (with its masks): each
live inverse entry once (row r of patch p feeds a live output dof, column
c gathers a live input dof: r_p c_p entries of A's itemsize), each
gathered entry of x once and each scattered entry of out once.

KM, the level apply  out = A x  on the merged BSR operator: each block's
d x d values once with its int32 column, the int32 row pointers, x once
and out once."""

from __future__ import annotations

import torch

#: published HBM3 bandwidth of one NVIDIA H100 SXM (NVIDIA data sheet),
#: at the 700 W power limit
HBM_BYTES_PER_S = 3.35e12


def k1_counts(pidx, n, in_keep=None, out_keep=None):
    """(A entries, vector entries) that one call on the table needs.
    ``pidx`` (np, m): positions in x, pads >= n; ``in_keep`` and
    ``out_keep``: optional bool masks of n (a False input dof is not
    gathered, a False output dof is passed through)."""
    idx = torch.as_tensor(pidx)
    live = idx < n
    safe = torch.where(live, idx, torch.zeros_like(idx))
    cols = live if in_keep is None else live & in_keep[safe]
    rows = live if out_keep is None else live & out_keep[safe]
    a = int((rows.sum(1) * cols.sum(1)).sum())
    x = int(torch.unique(idx[cols]).numel())
    out = int(torch.unique(idx[rows]).numel())
    return a, x + out


def km_counts(nnzb, d, n, nodes):
    """(value entries, index bytes, vector entries) of one KM call."""
    return nnzb * d * d, 4 * nnzb + 4 * (nodes + 1), 2 * n


def share_pct(nbytes, device_s):
    """The share (%) of the bandwidth bound in ``device_s`` seconds, or
    None where nothing was timed."""
    if not nbytes or not device_s or device_s <= 0:
        return None
    return 100.0 * nbytes / HBM_BYTES_PER_S / device_s

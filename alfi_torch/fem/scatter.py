"""Scatter-adds whose sums repeat bit for bit on the card.

``Tensor.index_add`` on a CUDA tensor adds the contributions that share a
destination with float atomics, in whatever order the threads arrive, so
the same inputs give sums that differ in their last bits from run to run.
A Newton-Krylov solve near the edge of its robustness (the [P2]^2-P0 MMS
study at Re 900 on its coarsest mesh) then takes another number of
iterations on every run.

:class:`ScatterAdd` sums every destination's contributions in index
order, as the sequential ``index_add`` of the CPU does, and without
atomics.  Out of place (the residual, the restrictions, under
``torch.func.jvp`` too) it gathers, once per call, by a table built on
the host that lists for each destination its old value and then its
contributions in index order, padded with zeros; a ``cumsum`` along
those lists, whose card kernel walks each of them in order from the
first, leaves the sums at their ends.  In place (the dense matrices of
the direct modes, whose N^2 entries no table can span) it adds in rounds
in which no destination repeats: round k holds every destination's k-th
contribution.  On a CPU tensor it is one ``index_add``.
"""

from __future__ import annotations

import numpy as np
import torch


def round_positions(index):
    """Positions of the 1-D host int array ``index`` in rounds: round k
    holds, ascending, every position that is the k-th occurrence of its
    destination.  No destination repeats within a round."""
    index = np.asarray(index).reshape(-1)
    order = np.argsort(index, kind="stable")
    s = index[order]
    first = np.ones(s.shape, dtype=bool)
    first[1:] = s[1:] != s[:-1]
    start = np.maximum.accumulate(np.where(first, np.arange(s.size), 0))
    rank = np.empty(s.size, dtype=np.int64)
    rank[order] = np.arange(s.size) - start
    by_rank = np.argsort(rank, kind="stable")
    return np.split(by_rank, np.cumsum(np.bincount(rank))[:-1])


def gather_table(index, n):
    """(1 + w, n) host table of the 1-D host int array ``index`` with
    destinations 0..n-1, w its largest multiplicity: column j holds j
    (the destination's old value), then n + i for each position i with
    index[i] = j in ascending order, then n + index.size (a zero)."""
    index = np.asarray(index).reshape(-1)
    counts = np.bincount(index, minlength=n)
    order = np.argsort(index, kind="stable")
    start = np.cumsum(counts) - counts
    rank = np.arange(index.size) - np.repeat(start, counts)
    table = np.full((1 + int(counts.max(initial=0)), n), n + index.size,
                    dtype=np.int64)
    table[0] = np.arange(n)
    table[1 + rank, index[order]] = n + order
    return table


class ScatterAdd:
    """``out[index[i]] += src[i]`` along the first axis, each destination
    in index order: by a gather table out of place and in rounds in place
    on the card (see the module docstring), one ``index_add`` on the CPU.

    ``index``: the destinations, an int tensor on the device of the
    sources, any shape (flattened); ``n``: the length of the output's
    first axis.  A host copy of the index is taken here, outside any
    ``torch.func`` transform; the table and the rounds are built from it
    on first use and kept."""

    def __init__(self, index, n):
        self.index = index.reshape(-1).to(torch.int64)
        self._host = self.index.cpu().numpy()
        self.n = int(n)
        self._table = None
        self._rounds = None

    def table(self):
        """:func:`gather_table` on the index's device."""
        if self._table is None:
            self._table = torch.as_tensor(gather_table(self._host, self.n),
                                          device=self.index.device)
        return self._table

    def rounds(self):
        """[(positions or None for all of them, destinations)] on the
        index's device."""
        if self._rounds is None:
            dev = self.index.device
            parts = round_positions(self._host)
            if len(parts) == 1:
                self._rounds = [(None, self.index)]
            else:
                self._rounds = [(torch.as_tensor(p, device=dev),
                                 torch.as_tensor(self._host[p], device=dev))
                                for p in parts]
        return self._rounds

    def __call__(self, src, out=None):
        """``out`` (zeros of (n, *src.shape[1:]) when None) plus the sums,
        out of place, so that ``torch.func.jvp`` and ``vjp`` pass
        through."""
        if out is None:
            out = src.new_zeros((self.n,) + tuple(src.shape[1:]))
        if src.device.type == "cpu":
            return out.index_add(0, self.index, src)
        return self.by_table(src, out)

    def by_table(self, src, out):
        """The sums by the gather table, on any device."""
        rest = tuple(src.shape[1:])
        vals = torch.cat([out.reshape(self.n, -1),
                          src.reshape(src.shape[0], -1),
                          src.new_zeros((1, out[0].numel()))])
        # (1 + w, n, k), scanned along its first axis: one ordered walk
        # per (destination, component)
        return vals[self.table()].cumsum(0)[-1].reshape((self.n,) + rest)

    def add_(self, out, src):
        """In place: ``out[index[i]] += src[i]``."""
        if src.device.type == "cpu":
            return out.index_add_(0, self.index, src)
        for pos, dst in self.rounds():
            out.index_add_(0, dst, src if pos is None else src[pos])
        return out

"""The live tap structure of an interpolation plan, found where the plan lies.

A tap combo ``(t_0, .., t_{k-1})`` of a group of k axes is live iff some
query element's multilinear corner reaches it with nonzero weight on every
axis of the group: weight ``1 - frac`` at the lo corner (cell offset ``off``)
and ``frac`` at the hi corner (``off + 1``). The row/lane and 6-D backups
(:mod:`.rowlane`, :mod:`.backup6d`) sum over the live combos only, as the
TPU kernel's builds do (``ocdp_tpu/ops/pallas_backup6.py:225, 286, 355``).

:func:`live_sets` finds them on the device that holds the offsets and
fracs: each element's offsets are encoded in mixed radix with two liveness
bits per axis, the present codes are found there, and only the offsets'
bounds and the present codes come to the host, where they are expanded
into the live combos. The counters ``live_sets.calls`` (analyses run) and
``live_sets.read_bytes`` (bytes the analyses read back to the host, through
:func:`to_host`) show how much of a plan leaves the device.
"""

from __future__ import annotations

import itertools
import math

import numpy as np
import torch

__all__ = ["live_sets", "to_host"]

# past this many elements a group is encoded in row blocks of about half of
# it (ocdp_tpu/ops/pallas_backup6.py:320-350), the last block overlapping
# backward (marked twice: only which codes are present is decoded)
_LIVE_BLOCK_ELEMS = 200_000_000
# the most bins of a table of the present codes (a bincount's presence,
# marked without the host reads of the codes' min and max that
# torch.bincount makes on a CUDA device); a wider encode takes torch.unique
_PRESENCE_BINS = 1 << 24


def to_host(t: torch.Tensor) -> np.ndarray:
    """``t`` as a host array, its bytes counted in
    ``live_sets.read_bytes``."""
    out = t.detach().cpu().numpy()
    live_sets.read_bytes += out.nbytes
    return out


def _row_blocks(n0: int, rest: int) -> tuple:
    """``(rows, r0s)``: one block of all ``n0`` leading rows up to
    ``_LIVE_BLOCK_ELEMS`` elements, else blocks of about half of it, the
    last one overlapping backward."""
    if n0 * rest <= _LIVE_BLOCK_ELEMS:
        return n0, [0]
    rows = max(1, (_LIVE_BLOCK_ELEMS // 2) // rest)
    r0s = list(range(0, n0 - rows + 1, rows))
    if r0s[-1] + rows < n0:
        r0s.append(n0 - rows)
    return rows, r0s


def _tensor_blocks(offs, fracs):
    """A group of broadcast-compatible tensors as the source of its row
    blocks: slices along the leading axis of the broadcast shape."""
    ts = list(offs) + list(fracs)
    shape = torch.broadcast_shapes(*(t.shape for t in ts))
    n0 = shape[0] if shape else 1
    rows, r0s = _row_blocks(n0, int(np.prod(shape[1:])) if shape else 1)

    def cut(t, r0):
        if rows == n0 or t.dim() < len(shape) or t.shape[0] == 1:
            return t
        return t[r0:r0 + rows]

    def blocks():
        for r0 in r0s:
            yield [cut(o, r0) for o in offs], [cut(f, r0) for f in fracs]

    return blocks


def encode(offs, fracs, base, span) -> torch.Tensor:
    """The int64 code of each element (``pallas_backup6.py:307-318``): the
    offsets in mixed radix ``span`` from ``base``, then 2 liveness bits per
    axis (bit 0: the lo corner has weight, bit 1: the hi corner), or both
    bits set where ``fracs`` is None."""
    k = len(offs)
    enc, origin = offs[0].to(torch.int64), base[0]
    for o, b, s in zip(offs[1:], base[1:], span[1:]):
        enc = enc * s + o
        origin = origin * s + b
    enc = enc - origin
    if fracs is None:
        return (enc << (2 * k)) | ((1 << (2 * k)) - 1)
    for fr in fracs:
        # 1: lo corner only (frac 0), 2: hi corner only (frac 1), 3: both
        bits = torch.where(fr == 0.0, 1, torch.where(fr == 1.0, 2, 3))
        enc = torch.add(bits, enc, alpha=4)
    return enc


def _decode_live(enc_values, base, span, k):
    """Expand present encode values into the live corner-combo set:
    ``(per_axis_taps, combos)``, both sorted."""
    combos = set()
    for e in enc_values:
        bits = [(e >> (2 * (k - 1 - i))) & 3 for i in range(k)]
        rest = e >> (2 * k)
        offs = []
        for s in reversed(span):
            rest, o = divmod(rest, s)
            offs.append(o)
        offs = offs[::-1]
        for corner in itertools.product((0, 1), repeat=k):
            if all((b >> c) & 1 for c, b in zip(corner, bits)):
                combos.add(tuple(o + b + c for o, b, c
                                 in zip(offs, base, corner)))
    combos = sorted(combos)
    taps = [sorted({c[i] for c in combos}) for i in range(k)]
    return taps, combos


def live_sets(*groups) -> list:
    """The exact jointly-live tap combos of each group of axes:
    ``[(per_axis_taps, combos), ...]``, one pair a group, both sorted.

    A group is ``(offs, fracs)``: per axis the cell offsets (an integer
    tensor) and fracs, broadcast-compatible tensors on one device (views
    or flat arrays; past ``_LIVE_BLOCK_ELEMS`` elements encoded in row
    blocks), or a function that returns an iterable of such ``(offs,
    fracs)`` blocks, generated anew on each call (it is called twice), whose
    fracs may be None: both corners of every element admitted. Every group
    lies on one device, where the encode and the marking run: one read of the
    offsets' bounds, then the present codes, marked in one table of bins
    where every group's encode fits ``_PRESENCE_BINS`` bins together, else
    found with ``torch.unique`` (int64 codes of any width), and one read of
    them."""
    live_sets.calls += 1
    sources = [g if callable(g) else _tensor_blocks(*g) for g in groups]
    bounds = []
    for blocks in sources:
        lo = hi = None
        for offs, _ in blocks():
            mm = torch.stack([v for o in offs for v in torch.aminmax(o)])
            lo = mm[0::2] if lo is None else torch.minimum(lo, mm[0::2])
            hi = mm[1::2] if hi is None else torch.maximum(hi, mm[1::2])
        bounds.append(torch.stack([lo, hi]).to(torch.int64))
    lows, highs = to_host(torch.cat(bounds, dim=1)).tolist()
    layouts, at, axis = [], 0, 0
    for b in bounds:
        k = b.shape[1]
        base = lows[axis:axis + k]
        span = [h - lo + 1 for h, lo in zip(highs[axis:axis + k], base)]
        nbins = math.prod(span) << (2 * k)
        layouts.append((base, span, at, nbins))
        at += nbins
        axis += k
    if at <= _PRESENCE_BINS:
        seen = None
        for blocks, (base, span, first, nbins) in zip(sources, layouts):
            for offs, fracs in blocks():
                enc = encode(offs, fracs, base, span).reshape(-1)
                if seen is None:
                    seen = torch.zeros(at, dtype=torch.bool,
                                       device=enc.device)
                seen[first:first + nbins].index_fill_(0, enc, True)
        present = torch.nonzero(seen).flatten()
    else:
        present = torch.unique(torch.cat([
            torch.unique(encode(offs, fracs, base, span)) + first
            for blocks, (base, span, first, _) in zip(sources, layouts)
            for offs, fracs in blocks()]))
    codes = to_host(present).tolist()
    return [_decode_live([c - first for c in codes
                          if first <= c < first + nbins], base, span,
                         len(span))
            for base, span, first, nbins in layouts]


live_sets.calls = 0
live_sets.read_bytes = 0

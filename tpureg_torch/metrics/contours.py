"""Marching-squares iso-contour extraction (``skimage.measure.find_contours``
semantics, implemented from the published algorithm — skimage itself is not
installed in this environment).

The reference's Hausdorff metric extracts boundary points with
``find_contours(mask, level=0.5)`` and casts the sub-pixel points to int
(reference utils.py:155-170). Matching its numbers exactly requires matching
not just the crossing-point *set* but the full point *multiset* the reference
vstacks: closed contours repeat their head point at the tail, and that
duplicate enters the Dubuisson-Jain means (utils.py:187-198). This module
therefore reproduces the algorithm end to end:

- per-cell segment emission in row-major scan order with the standard
  16-case lookup and linear level interpolation (``_get_fraction``),
  low-connectivity saddle resolution (skimage's ``fully_connected='low'``
  default, the mode the reference uses);
- head/tail segment assembly into contours, appending the closing point when
  a contour's ends meet (so ``contour[0] == contour[-1]`` for closed loops,
  exactly once), merging chains with the lower-index contour surviving;
- contours returned in creation-index order.

Verified against skimage's published doctest golden and hand-computed cases
in tests/test_metric_goldens.py; exact equality with an installed skimage
cannot be asserted here (no package egress), so the doctest golden plus the
algorithm's determinism are the parity evidence.
"""

from __future__ import annotations

from collections import deque

import numpy as np

__all__ = ["find_contours", "extract_boundary_points"]


def _get_fraction(from_value: float, to_value: float, level: float) -> float:
    if to_value == from_value:
        return 0.0
    return (level - from_value) / (to_value - from_value)


def _cell_segments(r0, c0, ul, ur, ll, lr, level):
    """Segments ((from_pt, to_pt), ...) for one 2x2 cell, low connectivity."""
    case = (
        (1 if ul > level else 0)
        + (2 if ur > level else 0)
        + (4 if ll > level else 0)
        + (8 if lr > level else 0)
    )
    if case in (0, 15):
        return ()
    r1, c1 = r0 + 1, c0 + 1
    top = (float(r0), c0 + _get_fraction(ul, ur, level))
    bottom = (float(r1), c0 + _get_fraction(ll, lr, level))
    left = (r0 + _get_fraction(ul, ll, level), float(c0))
    right = (r0 + _get_fraction(ur, lr, level), float(c1))
    if case == 1:
        return ((top, left),)
    if case == 2:
        return ((right, top),)
    if case == 3:
        return ((right, left),)
    if case == 4:
        return ((left, bottom),)
    if case == 5:
        return ((top, bottom),)
    if case == 6:  # saddle: low connectivity keeps the below-level diagonal
        return ((right, top), (left, bottom))
    if case == 7:
        return ((right, bottom),)
    if case == 8:
        return ((bottom, right),)
    if case == 9:  # saddle
        return ((top, left), (bottom, right))
    if case == 10:
        return ((bottom, top),)
    if case == 11:
        return ((bottom, left),)
    if case == 12:
        return ((left, right),)
    if case == 13:
        return ((top, right),)
    # case == 14
    return ((left, top),)


def _iter_segments(image: np.ndarray, level: float):
    # Vectorized prepass: case codes for every (H-1)x(W-1) cell at once; the
    # Python segment emission only visits crossing cells (case in 1..14 and
    # NaN-free). np.argwhere scans row-major, so the emission order — and
    # therefore the assembly semantics — match the original double loop.
    ul = image[:-1, :-1]
    ur = image[:-1, 1:]
    ll = image[1:, :-1]
    lr = image[1:, 1:]
    case = (
        (ul > level).astype(np.int8)
        + 2 * (ur > level)
        + 4 * (ll > level)
        + 8 * (lr > level)
    )
    crossing = (case != 0) & (case != 15)
    nan_free = ~(np.isnan(ul) | np.isnan(ur) | np.isnan(ll) | np.isnan(lr))
    for r0, c0 in np.argwhere(crossing & nan_free):
        yield from _cell_segments(
            int(r0), int(c0),
            ul[r0, c0], ur[r0, c0], ll[r0, c0], lr[r0, c0], level,
        )


def _assemble_contours(segments):
    """Join directed segments head-to-tail into contours.

    Mirrors the reference assembly: a segment whose endpoints meet an
    existing contour's tail and head closes it by appending the duplicate
    point; when it bridges two distinct contours, the lower creation index
    survives the merge; otherwise it extends a contour or starts a new one.
    """
    current_index = 0
    contours = {}
    starts = {}  # first point -> (deque, index)
    ends = {}  # last point -> (deque, index)
    for from_point, to_point in segments:
        if from_point == to_point:  # degenerate (flat cell at level)
            continue
        tail, tail_num = starts.pop(to_point, (None, None))
        head, head_num = ends.pop(from_point, (None, None))
        if head is not None and tail is not None:
            if head is tail:
                head.append(to_point)  # closed: duplicate head point
            elif tail_num > head_num:
                head.extend(tail)
                del contours[tail_num]
                starts.pop(tail[0], None)
                ends[head[-1]] = (head, head_num)
            else:
                tail.extendleft(reversed(head))
                del contours[head_num]
                ends.pop(head[-1], None)
                starts[tail[0]] = (tail, tail_num)
        elif head is None and tail is None:
            contour = deque((from_point, to_point))
            contours[current_index] = contour
            starts[from_point] = (contour, current_index)
            ends[to_point] = (contour, current_index)
            current_index += 1
        elif head is not None:  # extend at the tail end
            head.append(to_point)
            ends[to_point] = (head, head_num)
        else:  # extend at the head end
            tail.appendleft(from_point)
            starts[from_point] = (tail, tail_num)
    return [
        np.asarray(contour, dtype=np.float64)
        for _, contour in sorted(contours.items())
    ]


def find_contours(image, level: float | None = None):
    """Iso-valued contours of a 2-D image at ``level``.

    Returns a list of (N, 2) float64 arrays of (row, col) points; closed
    contours have ``contour[0] == contour[-1]``. ``level`` defaults to the
    image's mid-range, as in the original API.
    """
    image = np.asarray(image, dtype=np.float64)
    if image.ndim != 2:
        raise ValueError(f"expected a 2-D image, got shape {image.shape}")
    if level is None:
        level = (np.nanmin(image) + np.nanmax(image)) / 2.0
    return _assemble_contours(_iter_segments(image, float(level)))


def extract_boundary_points(mask) -> np.ndarray:
    """Reference boundary-point extraction (utils.py:155-170): the 0.5-level
    marching-squares contour points of the binary mask, vstacked in contour
    order and truncated to int."""
    contours = find_contours(np.asarray(mask, dtype=np.float64), level=0.5)
    if len(contours) == 0:
        return np.empty((0, 2), dtype=int)
    return np.vstack(contours).astype(int)

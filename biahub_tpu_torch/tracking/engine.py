"""Segmentation and frame-to-frame linking for 2D/3D time-lapse tracking.

Counterpart of ``biahub_tpu/tracking/engine.py`` (:30-474), on the host in
NumPy and SciPy as the reference runs it, so the label frames are bit-equal
to the reference's: the foreground + contour pair becomes instance labels
by marker seeding (low-contour cores) and a nearest-marker Voronoi split,
and frames are linked into tracks by a gated Hungarian assignment on
centroid distance and size change, with divisions and optional gap closing.
The tracks table is a mapping of numpy columns (``TRACK_COLUMNS``, int64
but for the float64 ``z``, ``y``, ``x``) in place of the reference's
``pandas.DataFrame``, in the same row order; :func:`tracks_csv` gives the
text of its ``to_csv(index=False)``.
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "TRACK_COLUMNS",
    "segment_foreground_contour",
    "select_hierarchy_labels",
    "link_labels",
    "close_track_gaps",
    "track_from_foreground_contour",
    "track_from_labels",
    "tracks_csv",
]


def _segment_frame(foreground: np.ndarray, contour: np.ndarray, min_size: int) -> np.ndarray:
    """Instance labels for one frame (2D or 3D arrays)."""
    from scipy import ndimage

    foreground = np.asarray(foreground) > 0.5
    if not foreground.any():
        return np.zeros(foreground.shape, np.int32)
    contour = np.asarray(contour, dtype=np.float32)

    # Seeds: low-contour cores inside the foreground
    inside = contour[foreground]
    seed_threshold = np.quantile(inside, 0.3)
    seeds = foreground & (contour <= seed_threshold)
    markers, n = ndimage.label(seeds)
    if n == 0:
        markers, n = ndimage.label(foreground)
        return markers.astype(np.int32)

    # Voronoi split: each foreground voxel takes the nearest marker's label
    _, nearest = ndimage.distance_transform_edt(markers == 0, return_indices=True)
    labels = markers[tuple(nearest)]
    labels[~foreground] = 0

    # Drop tiny fragments
    if min_size > 1:
        counts = np.bincount(labels.ravel())
        small = np.where(counts < min_size)[0]
        if len(small):
            labels[np.isin(labels, small)] = 0
    return labels.astype(np.int32)


def segment_foreground_contour(
    foreground: np.ndarray,
    contour: np.ndarray,
    min_size: int = 4,
) -> np.ndarray:
    """Per-frame instance segmentation of (T, [Z,] Y, X) foreground+contour."""
    foreground = np.asarray(foreground)
    contour = np.asarray(contour)
    return np.stack(
        [
            _segment_frame(foreground[t], contour[t], min_size)
            for t in range(foreground.shape[0])
        ]
    )


def _voronoi_parts(mask: np.ndarray, prev_sl: np.ndarray, claim_ids: np.ndarray):
    """Split ``mask`` into one part per previous object, by nearest previous
    footprint (seeded Voronoi on the overlap pixels)."""
    from scipy import ndimage

    seeds = np.where(mask & np.isin(prev_sl, claim_ids), prev_sl, 0)
    _, nearest = ndimage.distance_transform_edt(seeds == 0, return_indices=True)
    part_lab = np.where(mask, seeds[tuple(nearest)], 0)
    return [part_lab == i for i in claim_ids]


def _parts_persist(parts_masks, fine_other_sl: np.ndarray) -> bool:
    """Do >= 2 of the candidate parts map onto DISTINCT fine objects in the
    adjacent frame? Each part votes with the majority fine label under its
    own footprint, so a label must dominate a part to count."""
    seen: set[int] = set()
    for pm in parts_masks:
        vals = fine_other_sl[pm]
        vals = vals[vals != 0]
        if len(vals) == 0:
            continue
        ids_, cnt = np.unique(vals, return_counts=True)
        seen.add(int(ids_[np.argmax(cnt)]))
        if len(seen) >= 2:
            return True
    return False


def select_hierarchy_labels(
    foreground: np.ndarray,
    contour: np.ndarray,
    min_size: int = 4,
) -> np.ndarray:
    """Temporally consistent selection over a 2-level segmentation hierarchy.

    ultrack segments every frame into a hierarchy of nested candidate
    segments and lets its ILP pick the level that is most consistent over
    time (reference: biahub/track.py:406-477, via ultrack segment/link/solve).
    This native equivalent keeps two levels per frame — coarse (connected
    foreground components) and fine (marker-Voronoi split,
    :func:`_segment_frame`) — and selects per coarse component with two
    temporal rules in one forward sweep (density assumption: objects overlap
    their previous-frame footprint):

    * **under-segmentation repair** — if ≥2 objects selected at t-1 overlap
      one coarse component (cells in contact), the component is split: by the
      fine parts when the fine level separates it, else by a Voronoi
      partition seeded from the overlapping previous footprints. Identities
      survive contact instead of collapsing into one detection.
    * **over-segmentation repair** — with ≤1 previous claimant, a fine split
      is kept only when it persists in the NEXT frame's fine level (real
      divisions separate and stay split; a one-frame seeding flicker
      collapses back to the merged component).

    Components with no previous claimant (new objects) use the fine level,
    matching :func:`segment_foreground_contour`. Returns the selected
    per-frame label stack (not yet temporally linked) for :func:`link_labels`.
    """
    from scipy import ndimage

    foreground = np.asarray(foreground)
    contour = np.asarray(contour)
    T = foreground.shape[0]
    fg = foreground > 0.5
    fine = np.stack(
        [_segment_frame(foreground[t], contour[t], min_size) for t in range(T)]
    )
    out = np.zeros(fg.shape, np.int32)
    prev_sel = None
    for t in range(T):
        coarse, n_c = ndimage.label(fg[t])
        sel = np.zeros(fg[t].shape, np.int32)
        next_id = 1
        for ci, sl in enumerate(ndimage.find_objects(coarse), start=1):
            if sl is None:
                continue
            mask = coarse[sl] == ci
            fine_sl = fine[t][sl]
            fine_ids = np.unique(fine_sl[mask])
            fine_ids = fine_ids[fine_ids != 0]
            if prev_sel is not None:
                prev_sl = prev_sel[sl]
                claim_ids = np.unique(prev_sl[mask])
                claim_ids = claim_ids[claim_ids != 0]
            else:
                claim_ids = np.zeros(0, np.int32)

            if len(claim_ids) >= 2:
                if len(fine_ids) >= 2:
                    parts = [(fine_sl == i) & mask for i in fine_ids]
                else:
                    parts = _voronoi_parts(mask, prev_sl, claim_ids)
            else:
                split_ok = False
                fine_parts = None
                if len(fine_ids) >= 2:
                    if len(claim_ids) == 0:
                        split_ok = True  # new objects: trust the fine level
                    else:
                        # Persistence: the split is real only if the PARTS
                        # map onto distinct fine objects in an adjacent
                        # frame (forward when one exists, else backward).
                        # Sampling per part — not the whole component mask —
                        # keeps a neighbor wandering into the footprint from
                        # faking persistence.
                        other = t + 1 if t + 1 < T else t - 1
                        if other >= 0:
                            fine_parts = [(fine_sl == i) & mask for i in fine_ids]
                            split_ok = _parts_persist(fine_parts, fine[other][sl])
                if split_ok:
                    parts = fine_parts if fine_parts is not None else [
                        (fine_sl == i) & mask for i in fine_ids
                    ]
                else:
                    parts = [mask]
            for pmask in parts:
                if pmask.sum() < max(min_size, 1):
                    continue
                sel[sl][pmask] = next_id
                next_id += 1
        out[t] = sel
        prev_sel = sel
    return out


def _frame_regions(labels: np.ndarray, scale) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(ids, centroids(zyx/yx in physical units), sizes) for one label frame."""
    from scipy import ndimage

    ids = np.unique(labels)
    ids = ids[ids != 0]
    if len(ids) == 0:
        return ids, np.zeros((0, labels.ndim)), np.zeros(0)
    centroids = np.asarray(ndimage.center_of_mass(labels > 0, labels, ids))
    centroids = centroids * np.asarray(scale)[-labels.ndim :]
    sizes = ndimage.sum_labels(np.ones_like(labels), labels, ids)
    return ids, centroids, sizes


#: The tracks table's columns and their dtypes, as the reference's frame has
#: them (``engine.py:325-333``).
TRACK_COLUMNS = ("track_id", "parent_track_id", "t", "z", "y", "x", "id", "parent_id")
_FLOAT_COLUMNS = ("z", "y", "x")


def _table(rows: list[dict]) -> dict[str, np.ndarray]:
    return {col: np.asarray([r[col] for r in rows],
                            dtype=np.float64 if col in _FLOAT_COLUMNS else np.int64)
            for col in TRACK_COLUMNS}


def link_labels(
    labels_tzyx: np.ndarray,
    scale=(1.0, 1.0, 1.0),
    max_distance: float = 50.0,
    size_weight: float = 0.2,
    max_gap: int = 0,
) -> tuple[np.ndarray, dict[str, np.ndarray]]:
    """Link per-frame instance labels into temporally consistent tracks.

    Consecutive frames are matched with a padded Hungarian assignment; the
    cost is the centroid distance (physical units) plus a relative size-change
    penalty, gated at ``max_distance``. Unmatched detections start new tracks;
    an unmatched detection near a matched previous track is a division (both
    daughters start tracks whose parent is that track). With ``max_gap >= 1``
    a second global pass re-joins tracks separated by up to that many blank
    frames (:func:`close_track_gaps`). Returns (relabeled stack, tracks
    table: ``TRACK_COLUMNS`` as numpy columns).
    """
    from scipy.optimize import linear_sum_assignment

    labels_tzyx = np.asarray(labels_tzyx)
    T = labels_tzyx.shape[0]
    spatial_ndim = labels_tzyx.ndim - 1

    out = np.zeros_like(labels_tzyx, dtype=np.uint32)
    rows = []
    next_track = 1
    next_node = 1
    prev: dict[int, dict] = {}  # track_id -> {centroid, size, node_id}
    track_parent: dict[int, int] = {}  # track_id -> parent track (-1 = root)

    for t in range(T):
        ids, centroids, sizes = _frame_regions(labels_tzyx[t], scale)
        assignments: dict[int, int] = {}  # region idx -> track_id
        parents: dict[int, tuple[int, int]] = {}  # region idx -> (parent tid, nid)

        if prev and len(ids):
            prev_tids = list(prev)
            prev_centroids = np.asarray([prev[k]["centroid"] for k in prev_tids])
            prev_sizes = np.asarray([prev[k]["size"] for k in prev_tids])
            dist = np.linalg.norm(
                prev_centroids[:, None, :] - centroids[None, :, :], axis=-1
            )
            size_penalty = (
                np.abs(prev_sizes[:, None] - sizes[None, :])
                / np.maximum(prev_sizes[:, None], 1)
            )
            cost = dist + size_weight * max_distance * size_penalty
            cost = np.where(dist <= max_distance, cost, 1e9)
            r, c = linear_sum_assignment(
                np.pad(cost, ((0, cost.shape[1]), (0, cost.shape[0])),
                       constant_values=1e9)
                if cost.shape[0] != cost.shape[1]
                else cost
            )
            for i, j in zip(r, c):
                if i < cost.shape[0] and j < cost.shape[1] and cost[i, j] < 1e9:
                    tid = prev_tids[i]
                    assignments[j] = tid
                    parents[j] = (tid, prev[tid]["node_id"])

            division_children: dict[int, list[int]] = {}  # prev idx -> regions
            for j in range(len(ids)):
                if j in assignments:
                    continue
                nearest = int(np.argmin(dist[:, j]))
                if dist[nearest, j] <= max_distance and prev_tids[nearest] in (
                    assignments.get(jj) for jj in assignments
                ):
                    division_children.setdefault(nearest, []).append(j)
            for i, extra in division_children.items():
                tid = prev_tids[i]
                matched = [jj for jj, t_ in assignments.items() if t_ == tid]
                for j in matched + extra:
                    assignments.pop(j, None)
                    parents[j] = (tid, prev[tid]["node_id"])

        new_prev: dict[int, dict] = {}
        for j, region_id in enumerate(ids):
            if j in assignments:
                tid = assignments[j]
                parent_tid = track_parent.get(tid, -1)
                parent_nid = parents[j][1]
            elif j in parents:  # division daughter: fresh track, parent kept
                tid = next_track
                next_track += 1
                parent_tid, parent_nid = parents[j]
                track_parent[tid] = parent_tid
            else:
                tid = next_track
                next_track += 1
                parent_tid, parent_nid = -1, -1
                track_parent[tid] = -1
            nid = next_node
            next_node += 1
            out[t][labels_tzyx[t] == region_id] = tid
            centroid = centroids[j]
            rows.append({
                "track_id": tid,
                "parent_track_id": parent_tid,
                "t": t,
                "z": float(centroid[0]) if spatial_ndim == 3 else 0.0,
                "y": float(centroid[-2]),
                "x": float(centroid[-1]),
                "id": nid,
                "parent_id": parent_nid,
            })
            new_prev[tid] = {"centroid": centroids[j], "size": sizes[j], "node_id": nid}
        prev = new_prev

    table = _table(rows)
    if max_gap >= 1:
        out, table = close_track_gaps(out, table, max_distance=max_distance, max_gap=max_gap)
    return out, table


def _group_rows(track_id: np.ndarray, t: np.ndarray, last: bool) -> np.ndarray:
    """Per track id, ascending: the row of its first (``last``: latest) t,
    the earliest row among ties (pandas' ``groupby().idxmin/idxmax``)."""
    picks = []
    for tid in np.unique(track_id):
        rows = np.nonzero(track_id == tid)[0]
        picks.append(rows[np.argmax(t[rows]) if last else np.argmin(t[rows])])
    return np.asarray(picks, dtype=np.int64)


def close_track_gaps(
    out: np.ndarray,
    table: dict[str, np.ndarray],
    max_distance: float = 50.0,
    max_gap: int = 2,
    gap_penalty_frac: float = 0.1,
) -> tuple[np.ndarray, dict[str, np.ndarray]]:
    """Second-pass global segment linking: re-join tracks across blank gaps.

    Every track's end is matched against every later track's start (gap of
    1..``max_gap`` missing frames, the same ``max_distance`` gate, a mild
    per-missing-frame penalty) with one global Hungarian assignment, and
    matched segments are merged: the resumed segment takes the earlier
    track's id, its first node's ``parent_id`` points at the earlier track's
    last node. Division daughters never gap-link at their start, and a
    track that ended by dividing never gap-links at its end.
    """
    from scipy.optimize import linear_sum_assignment

    if max_gap < 1 or len(table["track_id"]) == 0:
        return out, table
    track_id, parent_track_id, t = (table[k] for k in ("track_id", "parent_track_id", "t"))
    has_daughters = set(parent_track_id[parent_track_id > 0].tolist())
    firsts = _group_rows(track_id, t, last=False)
    lasts = _group_rows(track_id, t, last=True)
    ends = lasts[~np.isin(track_id[lasts], list(has_daughters))]
    starts = firsts[parent_track_id[firsts] == -1]
    if len(ends) == 0 or len(starts) == 0:
        return out, table

    zyx = np.stack([table["z"], table["y"], table["x"]], axis=1)
    end_pos, start_pos = zyx[ends], zyx[starts]
    end_t, start_t = t[ends], t[starts]
    dist = np.linalg.norm(end_pos[:, None, :] - start_pos[None, :, :], axis=-1)
    gaps = start_t[None, :] - end_t[:, None] - 1  # missing frames between them
    same = track_id[ends][:, None] == track_id[starts][None, :]
    valid = (gaps >= 1) & (gaps <= max_gap) & (dist <= max_distance) & ~same
    if not valid.any():
        return out, table
    INVALID, UNMATCH = 1e9, 1e8  # any valid pair costs << UNMATCH << INVALID
    cost = dist + gap_penalty_frac * max_distance * gaps
    cost = np.where(valid, cost, INVALID)
    n_e, n_s = cost.shape
    padded = np.full((n_e + n_s, n_e + n_s), INVALID)
    padded[:n_e, :n_s] = cost
    np.fill_diagonal(padded[:n_e, n_s:], UNMATCH)
    np.fill_diagonal(padded[n_e:, :n_s], UNMATCH)
    padded[n_e:, n_s:] = 0.0
    r, c = linear_sum_assignment(padded)
    merges = [
        (int(track_id[ends[i]]), int(track_id[starts[j]]), int(table["id"][ends[i]]))
        for i, j in zip(r, c)
        if i < n_e and j < n_s and cost[i, j] < UNMATCH
    ]
    if not merges:
        return out, table

    root = {}

    def find(tid):
        while tid in root:
            tid = root[tid]
        return tid

    stitch_parent_node = {}  # absorbed tid -> node id it resumes from
    for keep, absorb, end_node in merges:
        root[absorb] = find(keep)
        stitch_parent_node[absorb] = end_node

    table = {k: v.copy() for k, v in table.items()}
    old_track = track_id
    table["track_id"] = np.asarray([find(int(v)) for v in old_track], dtype=np.int64)
    for absorb, end_node in stitch_parent_node.items():
        seg = np.nonzero(old_track == absorb)[0]
        table["parent_id"][seg[np.argmin(t[seg])]] = end_node
    # Every row of a merged track takes its origin's (minimum-t row's) parent
    # track, renamed through the merges.
    renamed_parent = np.asarray([find(int(v)) if v > 0 else int(v) for v in parent_track_id],
                                dtype=np.int64)
    origin = _group_rows(table["track_id"], t, last=False)
    parent_of = dict(zip(table["track_id"][origin].tolist(), renamed_parent[origin].tolist()))
    table["parent_track_id"] = np.asarray([parent_of[v] for v in table["track_id"].tolist()],
                                          dtype=np.int64)

    lut_size = int(out.max()) + 1
    lut = np.arange(lut_size, dtype=out.dtype)
    for absorb in stitch_parent_node:
        if absorb < lut_size:
            lut[absorb] = find(absorb)
    return lut[out], table


def track_from_foreground_contour(
    foreground: np.ndarray,
    contour: np.ndarray,
    scale=(1.0, 1.0, 1.0),
    max_distance: float = 50.0,
    min_size: int = 4,
    max_gap: int = 0,
    hierarchy: bool = False,
) -> tuple[np.ndarray, dict[str, np.ndarray]]:
    """Foreground + contour -> instances -> linked tracks; ``hierarchy``
    takes :func:`select_hierarchy_labels` in place of the single-level
    segmentation."""
    if hierarchy:
        labels = select_hierarchy_labels(foreground, contour, min_size=min_size)
    else:
        labels = segment_foreground_contour(foreground, contour, min_size=min_size)
    return link_labels(labels, scale=scale, max_distance=max_distance, max_gap=max_gap)


def track_from_labels(
    labels: np.ndarray,
    scale=(1.0, 1.0, 1.0),
    max_distance: float = 50.0,
    max_gap: int = 0,
) -> tuple[np.ndarray, dict[str, np.ndarray]]:
    """Link precomputed instance labels into tracks."""
    return link_labels(labels, scale=scale, max_distance=max_distance, max_gap=max_gap)


def tracks_csv(table: dict[str, np.ndarray]) -> str:
    """The table as the text of pandas' ``to_csv(index=False)`` of the
    reference's frame: a header, one line per row, floats as ``repr``."""
    lines = [",".join(TRACK_COLUMNS)]
    columns = [table[c].tolist() for c in TRACK_COLUMNS]
    for row in zip(*columns):
        lines.append(",".join(repr(float(v)) if c in _FLOAT_COLUMNS else str(int(v))
                              for c, v in zip(TRACK_COLUMNS, row)))
    return "\n".join(lines) + "\n"

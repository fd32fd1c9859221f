"""Geometric graphs and point matching for bead registration.

Counterpart of ``biahub_tpu/transforms/graph_matching.py`` on numpy and
scipy: k-NN/radius edges via ``cKDTree``, Hungarian matching
(``linear_sum_assignment``) with a cost matrix of position distance plus
local edge-length/angle consistency and optional PCA/descriptor terms,
quantile cost threshold, Lowe ratio, cross-check; or mutual-nearest
descriptor matching. The edge-consistency cost is the reference's
sorted-assignment DP (``_sorted_assignment_cost``), computed for all (i, j)
pairs at once in float64 (:func:`sorted_assignment_costs`) where the
reference calls a compiled helper or loops in Python.

scipy is imported where it is used: its import starts a process (numpy's
CPU probe), and importing the port starts none.
"""

from __future__ import annotations

from collections import defaultdict
from functools import cached_property
from typing import Literal

import numpy as np

__all__ = ["Graph", "GraphMatcher", "match_descriptors", "sorted_assignment_costs"]

class Graph:
    """Geometric graph over 2D/3D points with cached local features."""

    def __init__(self, nodes, edges: list[tuple[int, int]]):
        self.nodes = np.asarray(nodes, dtype=np.float32)
        self._edges = edges
        if self.nodes.ndim != 2:
            raise ValueError(f"nodes must be 2D array, got shape {self.nodes.shape}")
        if self.dim not in (2, 3):
            raise ValueError(f"nodes must be 2D or 3D points, got dim={self.dim}")

    @classmethod
    def from_nodes(
        cls,
        nodes,
        mode: Literal["knn", "radius", "full"] = "knn",
        k: int = 5,
        radius: float = 30.0,
    ) -> "Graph":
        return cls(nodes, cls._build_edges(nodes, mode=mode, k=k, radius=radius))

    @staticmethod
    def _build_edges(points, mode="knn", k=5, radius=30.0) -> list[tuple[int, int]]:
        points = np.asarray(points)
        n = len(points)
        if n <= 1:
            return []
        from scipy.spatial import cKDTree

        if mode == "knn":
            k_eff = min(k + 1, n)
            tree = cKDTree(points)
            _, indices = tree.query(points, k=k_eff)
            indices = np.atleast_2d(indices)
            return [(i, int(j)) for i in range(n) for j in indices[i] if i != j]
        if mode == "radius":
            tree = cKDTree(points)
            pairs = tree.query_pairs(r=radius)
            edges = []
            for i, j in pairs:
                edges.append((int(i), int(j)))
                edges.append((int(j), int(i)))
            return sorted(edges)
        if mode == "full":
            return [(i, j) for i in range(n) for j in range(n) if i != j]
        raise ValueError(f"Unknown mode: {mode}")

    @property
    def n_nodes(self) -> int:
        return len(self.nodes)

    @property
    def dim(self) -> int:
        return self.nodes.shape[1]

    @property
    def edges(self) -> list[tuple[int, int]]:
        return self._edges

    @cached_property
    def neighbor_map(self) -> dict[int, list[int]]:
        neighbors = defaultdict(list)
        for i, j in self._edges:
            neighbors[i].append(j)
        return dict(neighbors)

    @cached_property
    def edge_distances(self) -> dict[tuple[int, int], float]:
        distances = {}
        for i, j in self._edges:
            d = float(np.linalg.norm(self.nodes[j] - self.nodes[i]))
            distances[(i, j)] = distances[(j, i)] = d
        return distances

    @cached_property
    def edge_angles(self) -> dict[tuple[int, int], float]:
        if self.dim != 2:
            return {}
        angles = {}
        for i, j in self._edges:
            vec = self.nodes[j] - self.nodes[i]
            a = float(np.arctan2(vec[1], vec[0]))
            angles[(i, j)] = angles[(j, i)] = a
        return angles

    @cached_property
    def edge_descriptors(self) -> np.ndarray:
        """(N, 4): [mean_length, std_length, mean_angle, std_angle] per node."""
        desc = np.zeros((self.n_nodes, 4), dtype=np.float32)
        for i in range(self.n_nodes):
            neighbors = self.neighbor_map.get(i, [])
            if not neighbors:
                continue
            lengths = np.array([self.edge_distances[(i, j)] for j in neighbors])
            desc[i, 0] = lengths.mean()
            desc[i, 1] = lengths.std()
            if self.dim == 2 and self.edge_angles:
                angles = np.array([self.edge_angles[(i, j)] for j in neighbors])
                desc[i, 2] = angles.mean()
                desc[i, 3] = angles.std()
        return desc

    @cached_property
    def pca_features(self) -> tuple[np.ndarray, np.ndarray]:
        """(N, D) dominant neighborhood directions + (N,) anisotropy ratios."""
        n, d = self.n_nodes, self.dim
        directions = np.zeros((n, d), dtype=np.float32)
        anisotropy = np.zeros(n, dtype=np.float32)
        for i in range(n):
            neighbors = self.neighbor_map.get(i, [])
            if not neighbors:
                directions[i] = np.nan
                anisotropy[i] = np.nan
                continue
            local = self.nodes[neighbors] - self.nodes[neighbors].mean(axis=0)
            _, S, Vt = np.linalg.svd(local, full_matrices=False)
            directions[i] = Vt[0] if Vt.shape[0] > 0 else np.zeros(d)
            anisotropy[i] = S[0] / (S[-1] + 1e-5) if len(S) >= 2 else 0.0
        return directions, anisotropy

    def get_neighbors(self, node_idx: int) -> list[int]:
        return self.neighbor_map.get(node_idx, [])

    def __repr__(self) -> str:
        return f"Graph(n_nodes={self.n_nodes}, n_edges={len(self.edges)}, dim={self.dim})"


def match_descriptors(
    descriptors1: np.ndarray,
    descriptors2: np.ndarray,
    metric: str = "euclidean",
    cross_check: bool = True,
    max_ratio: float = 1.0,
) -> np.ndarray:
    """Mutual-nearest descriptor matching with Lowe's ratio test.

    Drop-in for skimage.feature.match_descriptors on small point sets.
    """
    from scipy.spatial.distance import cdist

    if len(descriptors1) == 0 or len(descriptors2) == 0:
        return np.zeros((0, 2), dtype=np.int32)
    distances = cdist(descriptors1, descriptors2, metric=metric)
    idx1 = np.arange(len(descriptors1))
    idx2 = np.argmin(distances, axis=1)

    if cross_check:
        back = np.argmin(distances, axis=0)
        mutual = idx1 == back[idx2]
        idx1, idx2 = idx1[mutual], idx2[mutual]

    if max_ratio < 1.0 and distances.shape[1] > 1:
        best = distances[idx1, idx2]
        d = distances[idx1].copy()
        d[np.arange(len(idx1)), idx2] = np.inf
        second = d.min(axis=1)
        keep = best < max_ratio * second
        idx1, idx2 = idx1[keep], idx2[keep]

    return np.stack([idx1, idx2], axis=1).astype(np.int32)


class GraphMatcher:
    """Match nodes between two geometric graphs (see module docstring)."""

    def __init__(
        self,
        algorithm: Literal["hungarian", "descriptor"] = "hungarian",
        weights: dict[str, float] | None = None,
        distance_metric: str = "euclidean",
        normalize: bool = False,
        cost_threshold: float = 0.9,
        cross_check: bool = False,
        max_ratio: float | None = None,
        metric: str = "euclidean",
        verbose: bool = False,
    ):
        self.algorithm = algorithm
        default_weights = {
            "dist": 0.5,
            "edge_length": 1.0,
            "edge_angle": 1.0,
            "pca_dir": 0.0,
            "pca_aniso": 0.0,
            "edge_descriptor": 0.0,
        }
        self.weights = {**default_weights, **(weights or {})}
        self.distance_metric = distance_metric
        self.normalize = normalize
        self.cost_threshold = cost_threshold
        self.cross_check = cross_check
        self.max_ratio = max_ratio
        self.metric = metric
        self.verbose = verbose

    def match(self, moving: Graph, reference: Graph, verbose: bool | None = None):
        verbose = self.verbose if verbose is None else verbose
        if moving.dim != reference.dim:
            raise ValueError(
                f"Dimension mismatch: moving={moving.dim}D, reference={reference.dim}D"
            )
        if moving.n_nodes == 0 or reference.n_nodes == 0:
            return np.array([]).reshape(0, 2).astype(np.int32)
        if self.algorithm == "hungarian":
            if self.cross_check:
                fwd = self._solve_assignment(self.compute_cost_matrix(moving, reference), False)
                bwd = self._solve_assignment(self.compute_cost_matrix(reference, moving), False)
                reverse = {(j, i) for i, j in bwd}
                matches = np.array(
                    [[i, j] for i, j in fwd if (i, j) in reverse], dtype=np.int32
                ).reshape(-1, 2)
            else:
                matches = self._solve_assignment(
                    self.compute_cost_matrix(moving, reference), verbose
                )
            return matches
        if self.algorithm == "descriptor":
            return match_descriptors(
                moving.nodes,
                reference.nodes,
                metric=self.metric,
                cross_check=self.cross_check,
                max_ratio=self.max_ratio if self.max_ratio is not None else 1.0,
            )
        raise ValueError(f"Unknown algorithm: {self.algorithm}")

    # -- cost construction -------------------------------------------------

    def compute_cost_matrix(self, moving: Graph, reference: Graph) -> np.ndarray:
        from scipy.spatial.distance import cdist

        n, m = moving.n_nodes, reference.n_nodes
        C = np.zeros((n, m), dtype=np.float32)
        w = self.weights

        def _norm(mat, scale=None):
            if not self.normalize:
                return mat
            s = scale if scale is not None else mat.max()
            return mat / s if s > 0 else mat

        if w["dist"] > 0:
            C += w["dist"] * _norm(
                cdist(moving.nodes, reference.nodes, metric=self.distance_metric)
            )
        if w["edge_length"] > 0:
            C += w["edge_length"] * _norm(
                self._edge_consistency_cost(moving, reference, "distance", 1e6)
            )
        if w["edge_angle"] > 0 and moving.dim == 2:
            C += w["edge_angle"] * _norm(
                self._edge_consistency_cost(moving, reference, "angle", np.pi),
                scale=np.pi,
            )
        if w["pca_dir"] > 0 or w["pca_aniso"] > 0:
            mov_dirs, mov_aniso = moving.pca_features
            ref_dirs, ref_aniso = reference.pca_features
            if w["pca_dir"] > 0:
                dot = np.clip(mov_dirs @ ref_dirs.T, -1.0, 1.0)
                C += w["pca_dir"] * _norm(1 - np.abs(dot))
            if w["pca_aniso"] > 0:
                C += w["pca_aniso"] * _norm(np.abs(mov_aniso[:, None] - ref_aniso[None, :]))
        if w["edge_descriptor"] > 0:
            C += w["edge_descriptor"] * _norm(
                cdist(moving.edge_descriptors, reference.edge_descriptors)
            )
        return C

    def _edge_consistency_cost(
        self, moving: Graph, reference: Graph, attr_type: str, default_cost: float
    ) -> np.ndarray:
        """Mean cost of optimally pairing the two nodes' sorted local edge
        attributes (:func:`sorted_assignment_costs`); ``default_cost`` where
        a node has no edges."""
        n, m = moving.n_nodes, reference.n_nodes
        if attr_type == "distance":
            mov_attrs, ref_attrs = moving.edge_distances, reference.edge_distances
        elif attr_type == "angle":
            mov_attrs, ref_attrs = moving.edge_angles, reference.edge_angles
            if not mov_attrs or not ref_attrs:
                return np.full((n, m), default_cost, dtype=np.float32)
        else:
            raise ValueError(f"Unknown attr_type: {attr_type}")

        mov_lists = [
            np.sort([mov_attrs[(i, ni)] for ni in moving.neighbor_map.get(i, [])])
            for i in range(n)
        ]
        ref_lists = [
            np.sort([ref_attrs[(j, nj)] for nj in reference.neighbor_map.get(j, [])])
            for j in range(m)
        ]
        return sorted_assignment_costs(mov_lists, ref_lists, default_cost)

    def _solve_assignment(self, C: np.ndarray, verbose: bool) -> np.ndarray:
        """Padded Hungarian solve + quantile threshold + Lowe ratio filter."""
        from scipy.optimize import linear_sum_assignment

        n_a, n_b = C.shape
        n = max(n_a, n_b)
        padded = np.full((n, n), 1e6, dtype=np.float32)
        padded[:n_a, :n_b] = C
        row_ind, col_ind = linear_sum_assignment(padded)

        cost_thresh = np.quantile(C, self.cost_threshold)
        matches = []
        for i, j in zip(row_ind, col_ind):
            if i >= n_a or j >= n_b:
                continue
            if C[i, j] >= cost_thresh:
                continue
            if self.max_ratio is not None and C.shape[1] > 1:
                second_best = np.sort(C[i, :])[1]
                if C[i, j] / (second_best + 1e-10) > self.max_ratio:
                    continue
            matches.append((i, j))
        if verbose:
            print(f"Found {len(matches)} matches (cost_threshold={cost_thresh:.3f})")
        return np.array(matches, dtype=np.int32).reshape(-1, 2)

    # -- geometric filtering -------------------------------------------------

    def filter_matches(
        self,
        matches: np.ndarray,
        moving: Graph,
        reference: Graph,
        angle_threshold: float | None = 0,
        direction_threshold: float | None = 0,
        min_distance_quantile: float = 0.01,
        max_distance_quantile: float = 0.95,
        verbose: bool | None = None,
    ) -> np.ndarray:
        """Drop matches whose displacement disagrees with the population."""
        verbose = self.verbose if verbose is None else verbose
        if len(matches) == 0:
            return matches

        if min_distance_quantile != 0 or max_distance_quantile != 0:
            dist = np.linalg.norm(
                moving.nodes[matches[:, 0]] - reference.nodes[matches[:, 1]], axis=1
            )
            low = np.quantile(dist, min_distance_quantile)
            high = np.quantile(dist, max_distance_quantile)
            matches = matches[(dist >= low) & (dist <= high)]
            if verbose:
                print(f"Matches after distance filtering: {len(matches)}")

        if direction_threshold != 0 and len(matches):
            vectors = reference.nodes[matches[:, 1]] - moving.nodes[matches[:, 0]]
            unit = vectors / (np.linalg.norm(vectors, axis=1, keepdims=True) + 1e-10)
            mean_dir = unit.mean(axis=0)
            mean_dir = mean_dir / (np.linalg.norm(mean_dir) + 1e-10)
            angles_deg = np.degrees(np.arccos(np.clip(unit @ mean_dir, -1.0, 1.0)))
            matches = matches[angles_deg <= direction_threshold]
            if verbose:
                print(f"Matches after direction filtering: {len(matches)}")

        if angle_threshold != 0 and moving.dim == 2 and len(matches):
            vectors = reference.nodes[matches[:, 1]] - moving.nodes[matches[:, 0]]
            angles_deg = np.degrees(np.arctan2(vectors[:, 1], vectors[:, 0]))
            hist, bin_edges = np.histogram(angles_deg, bins=np.linspace(-180, 180, 36))
            k = np.argmax(hist)
            dominant = (bin_edges[k] + bin_edges[k + 1]) / 2
            matches = matches[np.abs(angles_deg - dominant) <= angle_threshold]
            if verbose:
                print(f"Matches after 2D angle filtering: {len(matches)}")

        return matches


def _assignment_dp(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """The DP of the reference's ``_sorted_assignment_cost`` (graph_matching.py
    :404-427) over broadcast batches: ``a`` (..., k) and ``b`` (..., m)
    sorted, k <= m; the mean cost of the optimal monotone alignment of ``a``
    into ``b``, float64, with the reference's operations in its order."""
    k, m = a.shape[-1], b.shape[-1]
    batch = np.broadcast_shapes(a.shape[:-1], b.shape[:-1])
    # prev[..., j]: min cost of matching all of a[:i] into some subset of b[:j]
    prev = np.zeros(batch + (m + 1,))
    for i in range(1, k + 1):
        cur = np.full(batch + (m + 1,), np.inf)
        for j in range(i, m + 1):
            match = prev[..., j - 1] + np.abs(a[..., i - 1] - b[..., j - 1])
            cur[..., j] = np.minimum(match, cur[..., j - 1])
        prev = cur
    return prev[..., m] / k


def sorted_assignment_costs(mov_lists, ref_lists, default_cost: float) -> np.ndarray:
    """(N, M) float32: the reference's ``_sorted_assignment_cost`` of every
    pair of sorted lists (the shorter one aligned into the longer), and
    ``default_cost`` where a list is empty. Lists are grouped by length,
    and each (length, length) group runs the DP on all its pairs at once."""
    n, m = len(mov_lists), len(ref_lists)
    out = np.full((n, m), default_cost, dtype=np.float32)
    mov_len = np.array([len(a) for a in mov_lists], dtype=int)
    ref_len = np.array([len(b) for b in ref_lists], dtype=int)
    for la in np.unique(mov_len[mov_len > 0]):
        rows = np.nonzero(mov_len == la)[0]
        a = np.stack([np.asarray(mov_lists[i], dtype=np.float64) for i in rows])[:, None]
        for lb in np.unique(ref_len[ref_len > 0]):
            cols = np.nonzero(ref_len == lb)[0]
            b = np.stack([np.asarray(ref_lists[j], dtype=np.float64) for j in cols])[None]
            cost = _assignment_dp(a, b) if la <= lb else _assignment_dp(b, a)
            out[np.ix_(rows, cols)] = cost
    return out

"""The paper's baseline: dislib's row-partitioned Dataset/Subset structure.

Implemented with the *same task structure* the paper describes so that the
benchmarks reproduce the paper's complexity separation:

* a Dataset is a list of Subsets; each Subset holds a block of samples
  (rows) and a block of labels,
* ``transpose`` splits every Subset into N parts and merges them
  (N^2 + N tasks, paper §5.2),
* ``shuffle`` splits every Subset into min(N, S) random parts and merges
  (N·min(N,S) + N tasks, paper §5.4),
* row-wise ops are one task per Subset; column-wise ops require a gather
  (paper Fig. 3).

Tasks here execute eagerly as NumPy calls (we count them); on PyCOMPSs each
would be a scheduled remote task — the benchmark couples these counts with
``core.costmodel.pycompss_time`` to model cluster behaviour, and measures the
wall-clock of the real NumPy execution at container scale.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional

import numpy as np


class TaskCounter:
    """Counts 'tasks' (units PyCOMPSs would schedule) and bytes moved."""

    def __init__(self):
        self.tasks = 0
        self.bytes_moved = 0

    def task(self, *arrays: np.ndarray, moved: Optional[int] = None) -> None:
        self.tasks += 1
        if moved is not None:
            self.bytes_moved += moved
        else:
            self.bytes_moved += sum(int(a.nbytes) for a in arrays)


@dataclasses.dataclass
class Subset:
    samples: np.ndarray            # (s, m)
    labels: Optional[np.ndarray]   # (s,) or None


class Dataset:
    """Row-partitioned collection of (samples, labels) Subsets."""

    def __init__(self, subsets: List[Subset], counter: Optional[TaskCounter] = None):
        self.subsets = subsets
        self.counter = counter or TaskCounter()

    # -- construction -------------------------------------------------------
    @classmethod
    def from_array(cls, samples: np.ndarray, n_subsets: int,
                   labels: Optional[np.ndarray] = None,
                   counter: Optional[TaskCounter] = None) -> "Dataset":
        rows = np.array_split(samples, n_subsets, axis=0)
        labs = (np.array_split(labels, n_subsets) if labels is not None
                else [None] * n_subsets)
        c = counter or TaskCounter()
        subsets = []
        for r, l in zip(rows, labs):
            c.task(r)  # one load task per Subset (paper §3.2.1)
            subsets.append(Subset(np.asarray(r), None if l is None else np.asarray(l)))
        return cls(subsets, c)

    @property
    def n_subsets(self) -> int:
        return len(self.subsets)

    def collect(self) -> np.ndarray:
        return np.concatenate([s.samples for s in self.subsets], axis=0)

    # -- paper §5.2: N^2 + N task transpose ---------------------------------
    def transpose(self) -> "Dataset":
        n = self.n_subsets
        # N^2 split tasks: each Subset is divided column-wise into N parts
        parts: List[List[np.ndarray]] = []
        for s in self.subsets:
            cols = np.array_split(s.samples, n, axis=1)
            row_parts = []
            for cpart in cols:
                self.counter.task(cpart)
                row_parts.append(cpart.T.copy())
            parts.append(row_parts)
        # N merge tasks: new Subset j concatenates part j of every old Subset
        new_subsets = []
        for j in range(n):
            pieces = [parts[i][j] for i in range(len(parts))]
            self.counter.task(*pieces)
            new_subsets.append(Subset(np.concatenate(pieces, axis=1), None))
        return Dataset(new_subsets, self.counter)

    # -- paper §5.4: N*min(N,S)+N task pseudo-shuffle ------------------------
    def shuffle(self, rng: np.random.Generator) -> "Dataset":
        n = self.n_subsets
        buckets: List[List[np.ndarray]] = [[] for _ in range(n)]
        lab_buckets: List[List[np.ndarray]] = [[] for _ in range(n)]
        for s in self.subsets:
            size = s.samples.shape[0]
            k = min(n, size)
            perm = rng.permutation(size)
            split_points = np.array_split(perm, k)
            targets = rng.choice(n, size=k, replace=False)
            for part_idx, idx in enumerate(split_points):
                piece = s.samples[idx]
                self.counter.task(piece)  # one split task per part
                buckets[targets[part_idx] % n].append(piece)
                if s.labels is not None:
                    lab_buckets[targets[part_idx] % n].append(s.labels[idx])
        new_subsets = []
        for j in range(n):
            pieces = buckets[j] or [np.zeros((0, self.subsets[0].samples.shape[1]),
                                             dtype=self.subsets[0].samples.dtype)]
            self.counter.task(*pieces)  # one merge task per new Subset
            labs = np.concatenate(lab_buckets[j]) if lab_buckets[j] else None
            new_subsets.append(Subset(np.concatenate(pieces, axis=0), labs))
        return Dataset(new_subsets, self.counter)

    # -- row-parallel map + reduction (paper Fig. 3) -------------------------
    def map_subsets(self, fn: Callable[[np.ndarray], np.ndarray]) -> List[np.ndarray]:
        out = []
        for s in self.subsets:
            self.counter.task(s.samples)
            out.append(fn(s.samples))
        return out

    def reduce(self, partials: List[np.ndarray],
               op: Callable[[np.ndarray, np.ndarray], np.ndarray]) -> np.ndarray:
        """Binary reduction tree: N-1 tasks (paper Fig. 3 right)."""
        level = list(partials)
        while len(level) > 1:
            nxt = []
            for i in range(0, len(level) - 1, 2):
                self.counter.task(level[i], level[i + 1])
                nxt.append(op(level[i], level[i + 1]))
            if len(level) % 2:
                nxt.append(level[-1])
            level = nxt
        return level[0]

    def sum_rows(self) -> np.ndarray:
        """Column-wise total (paper Fig. 3: map + reduction tree)."""
        partials = self.map_subsets(lambda x: x.sum(axis=0, keepdims=True))
        return self.reduce(partials, np.add)

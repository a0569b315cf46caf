"""Expert placement tables and strategies (paper §6; the port's copy of
``repro.core.placement``, with ``replica_devices`` of ``repro.core.lp``).

A placement maps every replica slot on every device of a MicroEP group to an
expert id.  We represent a MicroEP group as a logical (rows=D, cols=M) grid:
``cols`` is the EP axis (canonical expert block c lives at column c) and
``rows`` are the merged EP groups (the paper's parameter ``d`` = number of
rows merged; here d == D when the whole group is merged).

``place[i, c, s] = e`` means device (i, c) hosts a replica of expert ``e`` in
local slot ``s``.  The EDP group of expert e (the hyperedge of §6.1) is the
set of devices hosting a replica of e.

Strategies implemented (paper §6.2-6.3):
  * vanilla      — identity per row: canonical Megatron EP layout.  EDP groups
                   are mesh columns; scheduling degenerates to Figure 3b.
  * random       — independent random block permutation per row (Fig. 3c,
                   "MicroMoE (random)" in Fig. 7).
  * latin        — rows are cyclic shifts (a Latin square): the Cayley-graph
                   construction for the cyclic group Z_M (Appendix B,
                   Example 1 generalized); guarantees every pair of columns is
                   linked through every row offset.
  * cayley       — d=2 constructions from Appendix B for power-of-two sizes.
  * asymmetric   — greedy replica counts + Monte-Carlo placement given real
                   expert loads (§6.3).  Optionally budget-respecting:
                   per-device ``slot_budgets`` cap the replica slots a
                   device hosts (HBM budgets; unfilled slots are -1) and
                   per-device ``weights`` make the Monte-Carlo search
                   optimize the weighted makespan (DESIGN.md §11).
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

__all__ = [
    "Placement",
    "vanilla_placement",
    "random_placement",
    "latin_placement",
    "asymmetric_placement",
    "greedy_replica_counts",
    "count_moved_slots",
    "max_induced_density",
    "replica_matrix",
    "replica_devices",
]


@dataclasses.dataclass(frozen=True)
class Placement:
    """An expert placement for one MicroEP group.

    Attributes:
      table: int32[rows, cols, slots] expert id per replica slot.  An
        entry of -1 marks an *empty* slot — devices whose HBM budget is
        below the uniform slot count simply host fewer replicas
        (budget-respecting asymmetric placements, DESIGN.md §11).
      num_experts: E.
    """

    table: np.ndarray
    num_experts: int

    def __post_init__(self):
        table = np.asarray(self.table)
        if table.ndim != 3:
            raise ValueError(f"placement table must be [rows, cols, slots], "
                             f"got shape {table.shape}")
        if table.min() < -1 or table.max() >= self.num_experts:
            raise ValueError("placement table entries must be in "
                             f"[-1, {self.num_experts})")
        present = np.unique(table[table >= 0])
        if len(present) != self.num_experts:
            raise ValueError(f"placement hosts {len(present)} of "
                             f"{self.num_experts} experts")
        object.__setattr__(self, "table", table)

    @property
    def rows(self) -> int:
        return self.table.shape[0]

    @property
    def cols(self) -> int:
        return self.table.shape[1]

    @property
    def slots(self) -> int:
        return self.table.shape[2]

    @property
    def num_devices(self) -> int:
        return self.rows * self.cols

    def flat(self) -> np.ndarray:
        """int32[num_devices, slots] with device index g = row * cols + col."""
        return self.table.reshape(self.num_devices, self.slots)

    def replicas_of(self, e: int) -> np.ndarray:
        """Flat device indices of the EDP group of expert e."""
        g, _ = np.nonzero(self.flat() == e)
        return g

    def replica_count(self) -> np.ndarray:
        """int[E] number of replicas per expert (empty slots ignored)."""
        flat = self.flat().ravel()
        return np.bincount(flat[flat >= 0], minlength=self.num_experts)

    def slots_per_device(self) -> np.ndarray:
        """int[G] occupied replica slots per device (<= ``slots``)."""
        return (self.flat() >= 0).sum(axis=1)

    def consistent_slots(self) -> bool:
        """Paper §B.3: all replicas of an expert share the local slot index."""
        flat = self.flat()
        for e in range(self.num_experts):
            _, s = np.nonzero(flat == e)
            if len(np.unique(s)) > 1:
                return False
        return True


def _check_sizes(rows: int, cols: int, num_experts: int) -> int:
    if num_experts % cols:
        raise ValueError(f"num_experts={num_experts} must divide by cols={cols}")
    return num_experts // cols


def vanilla_placement(rows: int, cols: int, num_experts: int) -> Placement:
    """Canonical EP layout: every row hosts expert block c at column c."""
    k = _check_sizes(rows, cols, num_experts)
    blocks = np.arange(num_experts, dtype=np.int32).reshape(cols, k)
    table = np.broadcast_to(blocks, (rows, cols, k)).copy()
    return Placement(table, num_experts)


def random_placement(
    rows: int, cols: int, num_experts: int, seed: int = 0
) -> Placement:
    """Independent random *expert-level* shuffle per row (paper 'random').

    Each row assigns all E experts to its cols*k slots by an independent
    permutation, so EDP groups of different experts intersect arbitrarily —
    the Fig. 3c scheduling-space expansion.  (Shuffling whole expert *blocks*
    would collapse the placement graph to a perfect matching with only
    ``cols`` distinct hyperedges, no better than vanilla — a pitfall we test
    against explicitly.)
    """
    k = _check_sizes(rows, cols, num_experts)
    rng = np.random.default_rng(seed)
    table = np.stack(
        [rng.permutation(num_experts).astype(np.int32).reshape(cols, k)
         for _ in range(rows)]
    )
    return Placement(table, num_experts)


def latin_placement(rows: int, cols: int, num_experts: int) -> Placement:
    """Symmetric circulant (Cayley) placement at expert granularity (§6.2).

    Expert e has canonical column c_e = e // k and slot class s_e = e % k.
    Row i places e at column (c_e + i * stride(s_e)) % cols, slot s_e, with
    per-class strides 1..k.  This is the Cayley-graph construction over the
    cyclic group Z_cols with k generators (Appendix B generalized beyond
    d=2): the placement hypergraph is vertex-transitive per slot class, so
    no induced subgraph is denser than average by construction — near-optimal
    symmetric placement without load knowledge.  Slot classes are preserved
    across rows (the paper's §B.3 consistency restriction).
    """
    k = _check_sizes(rows, cols, num_experts)
    table = np.empty((rows, cols, k), dtype=np.int32)
    for i in range(rows):
        for s in range(k):
            stride = (s % max(cols - 1, 1)) + 1 if cols > 1 else 0
            # expert with canonical column c_e sits at col (c_e + i*stride)
            c_e = (np.arange(cols) - i * stride) % cols
            table[i, :, s] = (c_e * k + s).astype(np.int32)
    return Placement(table, num_experts)


def greedy_replica_counts(
    loads: np.ndarray,
    total_slots: int,
    max_per_expert: int,
) -> np.ndarray:
    """int64[E] replica counts by water-filling replicas onto load (§6.3
    step 1, also the replica-count planner of DESIGN.md §12).

    Start with one replica per expert; repeatedly grant a replica to the
    expert with maximum load-per-replica, capped at ``max_per_expert``
    (a device hosts an expert at most once).  Exactly ``total_slots``
    replicas are allocated.
    """
    loads = np.asarray(loads, dtype=np.float64).ravel()
    num_experts = len(loads)
    if total_slots < num_experts:
        raise ValueError(
            f"not enough replica slots for one replica per expert "
            f"({total_slots} slots < {num_experts} experts)")
    if total_slots > num_experts * max_per_expert:
        raise ValueError(
            f"{total_slots} replica slots cannot be filled: at most "
            f"{max_per_expert} replicas per expert x {num_experts} experts")
    counts = np.ones(num_experts, dtype=np.int64)
    import heapq

    heap = [(-loads[e] / 1.0, e) for e in range(num_experts)]
    heapq.heapify(heap)
    remaining = total_slots - num_experts
    while remaining > 0 and heap:
        _, e = heapq.heappop(heap)
        counts[e] += 1
        remaining -= 1
        if counts[e] < max_per_expert:
            heapq.heappush(heap, (-loads[e] / counts[e], e))
    if remaining > 0:
        # everyone is capped; spread leftovers round-robin over experts
        order = np.argsort(-loads)
        i = 0
        while remaining > 0:
            e = order[i % num_experts]
            if counts[e] < max_per_expert:
                counts[e] += 1
                remaining -= 1
            i += 1
    return counts


def count_moved_slots(old: "Placement", new: "Placement") -> int:
    """Expert-parameter fetches a migration ``old`` -> ``new`` needs.

    Per device: the number of occupied slots in ``new`` hosting an expert
    the device did *not* already host in ``old``.  Empty slots (table
    entry -1) never count, replicas that stay on their device are free
    regardless of local slot index, and tables with differing
    ``slots_per_device`` (budgeted asymmetric placements, DESIGN.md §11)
    diff correctly — the comparison is per-device set membership, not
    positional.  This is the migration cost signal of the replica-topology
    gate (DESIGN.md §12).
    """
    if old.num_devices != new.num_devices:
        raise ValueError(
            f"placements span different groups: {old.num_devices} vs "
            f"{new.num_devices} devices")
    of, nf = old.flat(), new.flat()
    moved = 0
    for g in range(new.num_devices):
        old_set = set(of[g][of[g] >= 0].tolist())
        moved += sum(1 for e in nf[g][nf[g] >= 0].tolist()
                     if e not in old_set)
    return moved


def asymmetric_placement(
    rows: int,
    cols: int,
    num_experts: int,
    loads: np.ndarray,
    seed: int = 0,
    num_samples: int = 64,
    slot_budgets: Sequence[int] | np.ndarray | None = None,
    weights: np.ndarray | None = None,
) -> Placement:
    """Asymmetric placement given real expert loads (paper §6.3).

    Step 1 (greedy replica counts): total replica slots = rows*cols*k.  Start
    with 1 replica per expert; repeatedly give a replica to the expert with
    maximum load-per-replica.
    Step 2 (Monte-Carlo): sample ``num_samples`` random slot assignments
    consistent with the replica counts and keep the one minimizing the
    sampled max induced-subgraph density (Eq. 3 on the given loads).

    Heterogeneous fleets (DESIGN.md §11): ``slot_budgets`` (int[G]) caps
    how many replica slots each flat device may host — the HBM budget.
    Devices below the max budget get trailing *empty* slots (table entry
    -1); total slots = Σ budgets.  ``weights`` (f64[G] compute weights)
    switches the Monte-Carlo scoring to the weighted density, so the
    search optimizes the weighted makespan the scheduler will actually
    see.
    """
    loads = np.asarray(loads, dtype=np.float64)
    assert loads.shape == (num_experts,)
    num_devices = rows * cols
    max_hosts = num_devices
    if slot_budgets is not None:
        slot_budgets = np.asarray(slot_budgets, dtype=np.int64).ravel()
        if slot_budgets.shape != (num_devices,):
            raise ValueError(
                f"slot_budgets must have one entry per device "
                f"({num_devices}), got shape {slot_budgets.shape}")
        if (slot_budgets < 0).any():
            raise ValueError("slot_budgets must all be >= 0")
        if not (slot_budgets > 0).any():
            raise ValueError("slot_budgets must have a positive entry")
        # A zero budget marks a device that hosts nothing — e.g. a fleet
        # group being drained (FLEET.md): its slots stay -1 and an expert
        # can replicate across at most the positive-budget devices.
        max_hosts = int((slot_budgets > 0).sum())
        k = int(slot_budgets.max())
        total_slots = int(slot_budgets.sum())
    else:
        k = _check_sizes(rows, cols, num_experts)
        total_slots = rows * cols * k

    # -- Step 1: greedy replica counts (capped at one replica per device) ---
    counts = greedy_replica_counts(loads, total_slots, max_hosts)

    # -- Step 2: Monte-Carlo slot assignment (collision-free greedy) -------
    rng = np.random.default_rng(seed)
    best_tbl, best_m = None, np.inf
    for _ in range(num_samples):
        tbl = _assign_slots(rows, cols, k, counts, rng,
                            slot_budgets=slot_budgets)
        if tbl is None:
            continue
        p = Placement(tbl, num_experts)
        m = max_induced_density(p, loads, num_samples=128, rng=rng,
                                weights=weights)
        if m < best_m:
            best_m, best_tbl = m, tbl
    if best_tbl is None:
        raise RuntimeError(
            f"could not construct a collision-free placement in "
            f"{num_samples} samples: {num_experts} experts with replica "
            f"counts summing to {total_slots} do not pack into the "
            f"per-device slot budgets "
            f"{'(uniform ' + str(k) + ')' if slot_budgets is None else np.asarray(slot_budgets).tolist()}"
            f" — raise the budgets or num_samples")
    return Placement(best_tbl, num_experts)


def _assign_slots(rows, cols, k, counts, rng, slot_budgets=None):
    """Assign each expert's replicas to distinct devices, filling all slots.

    Greedy: experts in decreasing replica count; each picks its r_e replicas
    on the devices with the most free slots (noise-randomized tie-break).
    With ``slot_budgets`` device g only offers budgets[g] of its k slots
    (the rest stay -1 = empty).  Returns None if the greedy dead-ends
    (caller resamples)."""
    num_devices = rows * cols
    if slot_budgets is None:
        budgets = np.full(num_devices, k, dtype=np.int64)
    else:
        budgets = np.asarray(slot_budgets, dtype=np.int64)
    free = budgets.copy()
    table = np.full((num_devices, k), -1, dtype=np.int32)
    order = np.argsort(-counts + rng.uniform(0, 0.1, len(counts)))
    for e in order:
        r_e = int(counts[e])
        cand = np.nonzero(free > 0)[0]
        if len(cand) < r_e:
            return None
        pick = cand[np.argsort(-(free[cand] + rng.uniform(0, 0.5, len(cand))))[:r_e]]
        for g in pick:
            table[g, budgets[g] - free[g]] = e
            free[g] -= 1
    if ((table >= 0).sum(axis=1) != budgets).any():
        return None
    return table.reshape(rows, cols, k)


def replica_matrix(p: Placement) -> np.ndarray:
    """bool[E, num_devices] membership matrix A[e, g] = g hosts a replica of e."""
    flat = p.flat()
    a = np.zeros((p.num_experts, p.num_devices), dtype=bool)
    for g in range(p.num_devices):
        occupied = flat[g][flat[g] >= 0]
        a[occupied, g] = True
    return a


def max_induced_density(
    p: Placement,
    loads: np.ndarray,
    num_samples: int = 0,
    rng=None,
    weights: np.ndarray | None = None,
) -> float:
    """Optimal LP objective m via Eq. 3: max over device subsets S of
    (sum of loads of experts whose EDP group ⊆ S) / |S|.

    With per-device compute ``weights`` the denominator generalizes to
    Σ_{g∈S} w_g, and the value is the optimal *weighted makespan*
    max_g load_g / w_g of the weighted LP (DESIGN.md §11) — the same
    supermodular-duality argument, with the uniform case being w ≡ 1.

    Exact (bitmask enumeration) for num_devices <= 20; otherwise falls back to
    exact-on-structure heuristics + Monte-Carlo subset sampling (used only for
    placement search, never for correctness tests).
    """
    loads = np.asarray(loads, dtype=np.float64)
    g_count = p.num_devices
    if weights is None:
        wdev = np.ones(g_count, dtype=np.float64)
    else:
        wdev = np.asarray(weights, dtype=np.float64).ravel()
        assert wdev.shape == (g_count,) and (wdev > 0).all()
    a = replica_matrix(p)  # [E, G]
    masks = np.zeros(p.num_experts, dtype=np.int64)
    for e in range(p.num_experts):
        mask = 0
        for g in np.nonzero(a[e])[0]:
            mask |= 1 << int(g)
        masks[e] = mask

    def subset_weight(sub: int) -> float:
        return float(sum(wdev[g] for g in range(g_count) if sub >> g & 1))

    total = loads.sum()
    w_total = float(wdev.sum())
    if g_count <= 20:
        best = total / w_total  # S = everything is always a candidate
        for sub in range(1, 1 << g_count):
            inside = (masks & ~sub) == 0
            w = loads[inside].sum()
            if w > 0:
                best = max(best, w / subset_weight(sub))
        return float(best)

    # Monte-Carlo + structural candidates for big groups.
    best = total / w_total
    # candidate: each expert's own EDP group and unions of top-loaded experts
    order = np.argsort(-loads)
    for take in range(1, min(len(order), 32)):
        sub = 0
        for e in order[:take]:
            sub |= int(masks[e])
        inside = (masks & ~sub) == 0
        w = loads[inside].sum()
        size = subset_weight(sub)
        if size:
            best = max(best, w / size)
    if num_samples and rng is not None:
        for _ in range(num_samples):
            size = int(rng.integers(1, g_count))
            sub_devices = rng.choice(g_count, size=size, replace=False)
            sub = 0
            for g in sub_devices:
                sub |= 1 << int(g)
            inside = (masks & ~sub) == 0
            w = loads[inside].sum()
            if w > 0:
                best = max(best, w / subset_weight(sub))
    return float(best)


def replica_devices(placement: Placement) -> np.ndarray:
    """int[E, R] flat device index of each replica, -1 padding.

    R = max replica count over experts; replicas are in ascending flat
    device order (deterministic on every device); empty slots are skipped."""
    flat = placement.flat()
    r_max = int(placement.replica_count().max())
    dev = np.full((placement.num_experts, r_max), -1, dtype=np.int64)
    fill = np.zeros(placement.num_experts, dtype=np.int64)
    for g in range(flat.shape[0]):
        for s in range(flat.shape[1]):
            e = int(flat[g, s])
            if e < 0:
                continue
            dev[e, fill[e]] = g
            fill[e] += 1
    return dev

"""NetworkPlan — compiled, cached preprocessing of one overlay topology.

A copy of the reference package's plan layer for a frozen
:class:`~repro_torch.p2psim.graph.Topology`.  Everything about a
topology that does not depend on the trial RNG is computed once and
persists across ``SimEngine.run`` calls:

  * the CSR adjacency and directed edge arrays (+ sorted membership
    keys for the Strategy-2 edge test);
  * per-origin BFS trees, tree levels, children CSR, and forward-phase
    static edge masks (``_OriginStatic``), keyed by (origin, ttl,
    forward strategy);
  * resolved auto-TTL eccentricities (the ``ttl=0`` case);
  * the replication placement table (``replica_table``);
  * per-origin :class:`DepthSlices` — the dense per-level index arrays
    and static merge-fold schedule the device sweep
    (``repro_torch.engine.sim_torch``) runs on; the sweep caches their
    device copies on the instance, one per device; ``reroute=True``
    extends a cached instance in place with the churn sweep's §4.2
    dead-parent reroute tables.

Live overlays (``sync``) are not part of this package yet.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.p2psim.graph import (Topology, as_csr, bfs_tree_csr,
                                      bfs_tree_csr_multi, directed_edges)
from repro_torch.p2psim.simulate import (SimParams, _OriginStatic,
                                         build_replica_table)

_I32_MAX = np.iinfo(np.int32).max


def resolve_index_dtype(n: int, nnz: int, requested: str) -> np.dtype:
    """Pick (and guard) the plan's index width.

    ``requested="int32"`` raises — a clear error instead of a silent
    wrap — whenever any indexable quantity exceeds int32: the peer
    count ``n``, the directed-edge count ``nnz`` (CSR offsets run to
    nnz), or the *virtual edge space* ``n²`` that a packed int32 edge
    key would need (the plan keeps packed keys int64 precisely so the
    common case n > 46340, n² > 2³¹ stays safe — see
    ``NetworkPlan._compile_topology``).  ``"auto"`` falls back to int64
    in those cases instead of raising.
    """
    wide = int(n) > _I32_MAX or int(nnz) > _I32_MAX
    if requested == "int64":
        return np.dtype(np.int64)
    if requested == "int32":
        if wide:
            raise ValueError(
                f"index_dtype='int32' cannot address this plan: "
                f"n={n}, directed edges={nnz} (virtual edge space "
                f"n**2={int(n) * int(n)}) exceed int32's {_I32_MAX}; "
                "use index_dtype='int64' (or 'auto')")
        return np.dtype(np.int32)
    return np.dtype(np.int64 if wide else np.int32)


class DepthSlices:
    """Depth-bucketed dense slices + static merge schedule of one tree.

    Everything the device sweep needs to run one origin's simulation as
    pure gathers/concats — no scatters, no data-dependent shapes.  Each
    BFS level is one dense slice; the bottom-up k-list merge is
    precompiled here into a static *fold schedule*: per round, which
    child-slot pairs merge (``mi_a`` / ``mi_b``), which odd slots carry
    over (``pi``), and where each parent's finished segment retires
    (``ret``).  Only real pairwise merges are ever executed on device,
    so the sweep's work is O(reached + children) k-list merges
    regardless of degree skew.

    Per depth ``d`` (all indices are *positions*, not node ids):
      * ``vv`` — the level's nodes (ascending);
      * ``par_pos`` — each node's parent position inside level d-1;
      * ``cnode`` — the level's children (= the d+1 reach set) grouped
        by parent; ``c_in_next`` their positions inside level d+1;
        ``cpar_pos`` their parents' positions inside this level;
      * ``par_sel`` / ``leaf_sel`` / ``asm_perm`` — the with-children /
        leaf split of the level and the permutation reassembling
        [parents, leaves] into node order;
      * ``rounds`` / ``ret`` / ``ret_perm`` — the fold schedule.

    With ``reroute=True`` (the churn sweep's §4.2 dead-parent rerouting)
    each level that has grandchildren additionally carries a STATIC
    reroute candidate table: every level-d+2 node is a potential urgent
    contributor to its grandparent at level d whenever its own parent
    died, so the fold schedule is recompiled over the augmented slot set
    [children..., grandchildren...]:

      * ``rr_gc_pos`` — grandchild positions inside level d+2;
      * ``rr_gc_par_pos`` — their parents' positions inside level d+1
        (the liveness gather: a grandchild slot is live iff that parent
        is DEAD);
      * ``rr_rounds`` / ``rr_ret`` / ``rr_ret_perm`` — the augmented
        fold schedule (grandchild slots segment to their grandparent).

    Which slots actually contribute is decided per entry by validity
    masks at run time; the shapes, gathers and merge schedule stay
    fixed.
    """

    def __init__(self, st: _OriginStatic, n: int, reroute: bool = False,
                 index_dtype=np.int64):
        """Compile ``st``'s tree into dense slices + fold schedules.

        ``index_dtype``: dtype of every position/index array (``vv``,
        gathers, fold-schedule slots, els).  int32 halves the plan's
        resident footprint and the device transfer at large n; the
        plan layer picks it only after its overflow guards pass.
        """
        self.n = n
        self.origin = st.origin
        self.reroute = False
        self.dmax = len(st.levels) - 1
        self.index_dtype = np.dtype(index_dtype)
        ix = self._ix
        self.levels = []
        for d in range(self.dmax + 1):
            vs = st.levels[d]
            L = len(vs)
            lv = {"vv": ix(vs)}
            if d > 0:
                lv["par_pos"] = ix(np.searchsorted(st.levels[d - 1],
                                                   st.parent[vs]))
            if d < self.dmax:
                ch = st.levels[d + 1]
                order = np.argsort(st.parent[ch], kind="stable")
                cnode = ch[order]
                cpar = st.parent[ch][order]
                lv["cnode"] = ix(cnode)
                lv["c_in_next"] = ix(np.searchsorted(ch, cnode))
                lv["cpar_pos"] = ix(np.searchsorted(vs, cpar))
                par_nodes = np.unique(cpar)          # ascending
                par_sel = np.searchsorted(vs, par_nodes)
                leaf_sel = np.setdiff1d(np.arange(L), par_sel)
                lv["par_sel"], lv["leaf_sel"] = ix(par_sel), ix(leaf_sel)
                lv["asm_perm"] = ix(np.argsort(
                    np.concatenate([par_sel, leaf_sel])))
                rounds, ret, segs = self._fold_schedule(
                    np.searchsorted(par_nodes, cpar))
                lv["rounds"] = self._ix_rounds(rounds)
                lv["ret"] = self._ix_ret(ret)
                # concat-of-retirements order -> parent-ascending order
                lv["ret_perm"] = ix(np.argsort(segs, kind="stable"))
            self.levels.append(lv)
        self._set_els(st)
        if reroute:
            self.extend_reroute(st)

    def _ix(self, a: np.ndarray) -> np.ndarray:
        return a.astype(self.index_dtype, copy=False)

    def _ix_rounds(self, rounds):
        return tuple(tuple(self._ix(a) for a in rnd) for rnd in rounds)

    def _ix_ret(self, ret):
        return tuple(None if idx is None else self._ix(idx)
                     for idx in ret)

    def _set_els(self, st: _OriginStatic) -> None:
        """Adopt ``st``'s forward-phase edge masks (Strategy-1/2 els)."""
        if st.fw_strategy == "basic":
            self.n_els = 0
            self.els_src = self.els_dst = np.zeros(0, self.index_dtype)
            self.cond = np.zeros(0, bool)
        else:
            self.n_els = len(st.fw_els_src)
            self.els_src = self._ix(st.fw_els_src)
            self.els_dst = self._ix(st.fw_els_dst)
            self.cond = st.fw_cond

    def extend_reroute(self, st: _OriginStatic) -> None:
        """Add the reroute tables to THIS instance, in place.

        Level d's grandchildren are level d+1's children, re-segmented
        by grandparent (always one of level d's parents: a grandchild's
        grandparent has the dead child as a child by construction).
        Everything already compiled is shared, and the static sweep's
        device tensors stay valid: the sweep caches the rr tables
        separately (``sim_torch._device_slices``).
        """
        if self.reroute:
            return
        for d in range(self.dmax - 1):
            lv, nxt = self.levels[d], self.levels[d + 1]
            par_nodes = lv["vv"][lv["par_sel"]]
            gp = st.parent[st.parent[nxt["cnode"]]]
            lv["rr_gc_pos"] = nxt["c_in_next"]
            lv["rr_gc_par_pos"] = nxt["cpar_pos"]
            seg = np.concatenate([
                np.searchsorted(par_nodes, st.parent[lv["cnode"]]),
                np.searchsorted(par_nodes, gp)])
            rounds, ret, segs = self._fold_schedule(seg)
            lv["rr_rounds"] = self._ix_rounds(rounds)
            lv["rr_ret"] = self._ix_ret(ret)
            lv["rr_ret_perm"] = self._ix(np.argsort(segs, kind="stable"))
        self.reroute = True

    @staticmethod
    def _fold_schedule(seg_of_slot: np.ndarray):
        """Static schedule of the segmented pairwise top-k reduction.

        Returns (rounds, ret, segs): ``rounds[r] = (mi_a, mi_b, pi)``
        index arrays into round r's input array (round 0's input is the
        parent-grouped child-list array) — pairs to merge plus odd
        slots carried over, output layout [merged..., carried...];
        ``ret[r]`` — the slots of round r's array holding a finished
        segment's full reduction (None when no segment finishes there;
        round 0 retires single-child parents); ``segs`` — the segment
        ids in concat-of-retirements order.
        """
        slots: dict = {}
        for i, seg in enumerate(seg_of_slot):
            slots.setdefault(int(seg), []).append(i)
        rounds, ret, seg_order = [], [], []
        while True:
            done = [(v[0], s) for s, v in sorted(slots.items())
                    if len(v) == 1]
            ret.append(np.array([i for i, _ in done])
                       if done else None)
            seg_order.extend(s for _, s in done)
            slots = {s: v for s, v in slots.items() if len(v) > 1}
            if not slots:
                break
            mi_a, mi_b, pi = [], [], []
            nxt: dict = {}
            for s in sorted(slots):
                v = slots[s]
                for j in range(0, len(v) - 1, 2):
                    nxt.setdefault(s, []).append(len(mi_a))
                    mi_a.append(v[j])
                    mi_b.append(v[j + 1])
                if len(v) % 2:
                    pi.append(v[-1])
            off = len(mi_a)
            for j, s in enumerate(s for s in sorted(slots)
                                  if len(slots[s]) % 2):
                nxt[s].append(off + j)
            rounds.append((np.array(mi_a), np.array(mi_b),
                           np.array(pi, np.int64)))
            slots = nxt
        return (tuple(rounds), tuple(ret),
                np.array(seg_order, np.int64))


class NetworkPlan:
    """Reusable per-topology state shared by every query on an overlay."""

    def __init__(self, top: Topology, *, index_dtype: str = "auto"):
        """Compile the per-topology state (CSR, edges, latency array).

        ``index_dtype``: width of the CSR / edge / depth-slice index
        arrays — ``"int64"``, ``"int32"`` (halves the index footprint
        and device transfer; guarded — raises if the plan cannot be
        addressed in 32 bits), or ``"auto"`` (int32 whenever the guards
        pass).  The packed ``edge_keys`` stay int64 regardless: their
        value space is n², which silently wraps int32 from n = 46341 up.
        """
        if index_dtype not in ("auto", "int32", "int64"):
            raise ValueError(
                "index_dtype must be 'auto', 'int32' or 'int64', got "
                f"{index_dtype!r}")
        self._index_dtype_req = index_dtype
        self.top = top
        self._compile_topology()
        self._statics: Dict[Tuple[int, int, str], _OriginStatic] = {}
        self._auto_ttl: Dict[int, int] = {}
        self._slices: Dict[Tuple[int, int, str], DepthSlices] = {}
        self._replicas: Dict[Tuple[int, str], np.ndarray] = {}

    def _compile_topology(self) -> None:
        """(Re)compile the per-topology tier from ``self.top``."""
        top = self.top
        self.indptr, self.indices = as_csr(top)
        dt = resolve_index_dtype(top.n, len(self.indices),
                                 self._index_dtype_req)
        self.index_dtype = dt
        self.indptr = self.indptr.astype(dt, copy=False)
        self.indices = self.indices.astype(dt, copy=False)
        self.e_src, self.e_dst = directed_edges(self.indptr, self.indices)
        self.e_src = self.e_src.astype(dt, copy=False)
        self.e_dst = self.e_dst.astype(dt, copy=False)
        # packed (src, dst) keys: the value space is n*n — ALWAYS int64,
        # an int32 key would silently wrap from n = 46341 up
        self.edge_keys = (self.e_src.astype(np.int64) * top.n
                          + self.e_dst)                # sorted by constr.
        # message-count arithmetic accumulates over degrees: keep wide
        self.degrees = np.diff(self.indptr).astype(np.int64, copy=False)
        # CSR-aligned per-edge latencies (BRITE distance model); None
        # for embeddings-free topologies, which support iid only
        self.edge_lat = (top.edge_latencies(self.e_src, self.e_dst)
                         if top.coords is not None else None)

    def replica_table(self, p: SimParams) -> Optional[np.ndarray]:
        """The (n, r) replication placement table for ``p`` (cached per
        (factor, placement)); None when
        replication is off."""
        r = p.replication_factor
        if r <= 0:
            return None
        key = (r, p.replication_placement)
        tab = self._replicas.get(key)
        if tab is None:
            tab = self._replicas[key] = build_replica_table(
                self.indptr, self.indices, r, p.replication_placement)
        return tab

    def depth_slices(self, st: _OriginStatic,
                     reroute: bool = False) -> DepthSlices:
        """Padded depth-bucketed arrays for ``st`` (the device sweep's
        inputs), compiled once per (origin, ttl, strategy) and cached.
        ``reroute=True`` lazily EXTENDS the cached instance with the
        static §4.2 dead-parent reroute tables the churn sweep folds
        over — the base arrays are never duplicated."""
        key = (st.origin, st.ttl, st.fw_strategy)
        sl = self._slices.get(key)
        if sl is None:
            sl = self._slices[key] = DepthSlices(
                st, self.top.n, reroute=reroute,
                index_dtype=self.index_dtype)
        elif reroute:
            sl.extend_reroute(st)
        return sl

    def auto_ttl(self, origin: int) -> int:
        """Resolved auto-TTL (BFS eccentricity), computed once per origin
        and reused by every later query with ``ttl=0``."""
        o = int(origin)
        if o not in self._auto_ttl:
            _, depth, _ = bfs_tree_csr(self.indptr, self.indices, o,
                                       self.top.n)
            self._auto_ttl[o] = int(depth.max())
        return self._auto_ttl[o]

    def origin_statics(self, origins: np.ndarray, ttl: int,
                       fw_strategy: str):
        """(sts, st_of_q): the unique ``_OriginStatic`` per distinct
        origin (first-appearance order) and the per-query index into it.

        Statics missing from the cache are built with one multi-origin
        BFS sweep; everything already cached is reused as-is.
        """
        uniq: Dict[int, int] = {}
        st_of_q = np.empty(len(origins), np.int64)
        for qi, origin in enumerate(origins):
            key = int(origin)
            if key not in uniq:
                uniq[key] = len(uniq)
            st_of_q[qi] = uniq[key]
        uniq_origins: List[int] = sorted(uniq, key=uniq.get)
        missing = [o for o in uniq_origins
                   if (o, ttl, fw_strategy) not in self._statics]
        if missing:
            P_all, D_all, R_all, K_all = bfs_tree_csr_multi(
                self.indptr, self.indices, np.asarray(missing, np.int64),
                self.top.n if ttl == 0 else ttl, return_rank=True)
            for i, o in enumerate(missing):
                st = _OriginStatic(self.top, self.indptr, self.indices,
                                   self.e_src, self.e_dst, self.edge_keys,
                                   self.degrees, o, ttl, fw_strategy,
                                   bfs=(P_all[i], D_all[i], R_all[i],
                                        K_all[i]),
                                   edge_lat=self.edge_lat)
                self._statics[(o, ttl, fw_strategy)] = st
                if ttl == 0:
                    # the full-depth BFS doubles as the TTL resolution
                    self._auto_ttl.setdefault(o, st.ttl)
        sts = [self._statics[(o, ttl, fw_strategy)] for o in uniq_origins]
        return sts, st_of_q

    def cache_info(self) -> dict:
        """Cache-occupancy counters (statics / auto-TTLs / slices)."""
        return {"origin_statics": len(self._statics),
                "auto_ttls": len(self._auto_ttl),
                "depth_slices": len(self._slices)}

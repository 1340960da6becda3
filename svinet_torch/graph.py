"""Graph ingest and host-side network store.

TPU-native equivalent of the reference's ``Network`` class
(reference: src/network.hh:22-216, src/network.cc:10-159): reads a
tab/whitespace-separated edge list, dedups, drops self-loops, compacts
external ids to sequence ids 0..n-1 in first-seen order, and builds the
arrays the device kernels need: a canonical edge array (E,2) with p<q,
CSR adjacency, and degrees. Heldout (validation/test/precision) splits are
sampled host-side (reference: src/linksampling.cc:281-309) and training
links are materialized as a dense array
(reference: LinkSampling::assign_training_links, src/linksampling.cc:493-523).
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Tuple

import numpy as np

from svinet_torch.config import Config

SINGLE_NODE_START_ID = 891212  # reference: src/network.hh uses a magic base id


def _pair_key(p: np.ndarray, q: np.ndarray, n: int) -> np.ndarray:
    """Unique int64 key for a canonical (p<q) node pair."""
    return p.astype(np.int64) * np.int64(n) + q.astype(np.int64)


class Network:
    """Host-side undirected graph store."""

    def __init__(self, cfg: Config):
        self.cfg = cfg
        self.n: int = 0
        self.edges: np.ndarray = np.zeros((0, 2), np.int32)  # canonical p<q
        self.deg: np.ndarray = np.zeros(0, np.int32)
        self.id2seq: Dict[int, int] = {}
        self.seq2id: np.ndarray = np.zeros(0, np.int64)
        self.str_ids: Optional[List[str]] = None
        self.singles: int = 0
        self._edge_keys: Optional[np.ndarray] = None  # sorted keys of all links
        # CSR adjacency
        self.row_ptr: np.ndarray = np.zeros(1, np.int64)
        self.col_idx: np.ndarray = np.zeros(0, np.int32)
        # ground truth communities: list of np arrays of seq ids
        self.ground_truth: Optional[List[np.ndarray]] = None
        # -groups-file: per-seq-node group metadata string
        self.gt_groups: Dict[int, str] = {}
        # heldout splits (canonical pairs + labels). The classic-SVI
        # engines sample TWO disjoint sets (src/mmsbinfer.cc:206-328):
        # heldout_pairs drives the stopping rule + heldout.txt, and
        # validation_pairs is evaluated at each new max (max.txt col 6).
        # LinkSampling uses a single split (validation_pairs only,
        # src/linksampling.cc:170-179) and heldout_pairs stays empty.
        self.validation_pairs: np.ndarray = np.zeros((0, 2), np.int32)
        self.validation_y: np.ndarray = np.zeros(0, np.int8)
        self.heldout_pairs: np.ndarray = np.zeros((0, 2), np.int32)
        self.heldout_y: np.ndarray = np.zeros(0, np.int8)
        self.test_pairs: np.ndarray = np.zeros((0, 2), np.int32)
        self.test_y: np.ndarray = np.zeros(0, np.int8)
        self.precision_pairs: np.ndarray = np.zeros((0, 2), np.int32)
        self.precision_y: np.ndarray = np.zeros(0, np.int8)
        # training links (validation/test excluded)
        self.training_links: np.ndarray = np.zeros((0, 2), np.int32)
        self.training_deg: np.ndarray = np.zeros(0, np.int32)
        # informative-zero neighborhood sets (infset mode), CSR layout
        self.sparse_zeros_ptr: Optional[np.ndarray] = None
        self.sparse_zeros_idx: Optional[np.ndarray] = None

    # ------------------------------------------------------------------
    @property
    def ones(self) -> int:
        return int(self.edges.shape[0])

    @property
    def total_pairs(self) -> int:
        if self.cfg.undirected:
            return self.n * (self.n - 1) // 2
        return self.n * (self.n - 1)

    def deg_stats(self) -> Tuple[int, float]:
        if self.n == 0:
            return 0, 0.0
        return int(self.deg.max()), float(self.deg.mean())

    # ------------------------------------------------------------------
    def read(self, path: str) -> None:
        """Read an edge list file (reference: Network::read, src/network.cc:10-159).

        Numeric ids go through the native multithreaded parser
        (native/ingest.cpp) when built; string ids (-strid) and the
        fallback use Python."""
        if not self.cfg.strid:
            from svinet_torch.io.native import parse_ints
            raw = parse_ints(path)
            if raw is not None:
                if raw.size % 2:
                    raw = raw[:-1]
                self._build(raw.reshape(-1, 2))
                return
        with open(path) as f:
            # match the native parser's tolerance: '#'/'%' comment lines
            # dropped, commas treated as separators
            text = "\n".join(
                line for line in f.read().split("\n")
                if not line.lstrip().startswith(("#", "%"))
            ).replace(",", " ")
        if self.cfg.strid:
            toks = text.split()
            if len(toks) % 2:
                toks = toks[:-1]
            uniq: Dict[str, int] = {}
            a = np.empty(len(toks) // 2, np.int64)
            b = np.empty(len(toks) // 2, np.int64)
            for i in range(0, len(toks), 2):
                for tok, arr in ((toks[i], a), (toks[i + 1], b)):
                    if tok not in uniq:
                        uniq[tok] = len(uniq)
                    arr[i // 2] = uniq[tok]
            self.str_ids = list(uniq.keys())
            raw = np.stack([a, b], axis=1)
        else:
            raw = np.array(text.split(), dtype=np.int64)
            if raw.size % 2:
                raw = raw[:-1]
            raw = raw.reshape(-1, 2)
        self._build(raw)

    def from_arrays(self, src: np.ndarray, dst: np.ndarray) -> None:
        """Build directly from id arrays (for synthetic/generated graphs)."""
        self._build(np.stack([np.asarray(src, np.int64),
                              np.asarray(dst, np.int64)], axis=1))

    def _build(self, raw: np.ndarray) -> None:
        cfg = self.cfg
        # compact external ids -> seq ids in first-seen order
        flat = raw.reshape(-1)
        uniq, first_pos = np.unique(flat, return_index=True)
        order = np.argsort(first_pos, kind="stable")
        uniq_in_order = uniq[order]
        if cfg.n and len(uniq_in_order) > cfg.n:
            # reference caps distinct nodes at env.n (Network::add fails after n)
            keep = uniq_in_order[: cfg.n]
            keep_set = np.isin(flat.reshape(-1, 2)[:, 0], keep) & np.isin(
                flat.reshape(-1, 2)[:, 1], keep
            )
            raw = raw[keep_set]
            uniq_in_order = keep
        n_read = len(uniq_in_order)
        seq2id = list(int(x) for x in uniq_in_order)

        # pad missing nodes as singles (reference: src/network.cc:107-113)
        self.singles = 0
        if cfg.n and cfg.n > n_read:
            self.singles = cfg.n - n_read
            for k in range(self.singles):
                seq2id.append(SINGLE_NODE_START_ID + k)
        self.n = max(cfg.n, n_read)
        cfg.n = self.n
        self.seq2id = np.array(seq2id, np.int64)
        self.id2seq = {e: i for i, e in enumerate(seq2id)}

        # vectorized id -> seq remap, keeping ingest at parser speed:
        # uniq is sorted and seq(uniq[j]) = inverse-permutation of `order`
        sorted_pos_to_seq = np.empty(len(uniq), np.int64)
        sorted_pos_to_seq[order] = np.arange(len(uniq))
        p = sorted_pos_to_seq[np.searchsorted(uniq, raw[:, 0])]
        q = sorted_pos_to_seq[np.searchsorted(uniq, raw[:, 1])]
        # drop self loops, canonicalize p<q, dedup keeping first occurrence
        mask = p != q
        p, q = p[mask], q[mask]
        lo, hi = np.minimum(p, q), np.maximum(p, q)
        keys = _pair_key(lo, hi, self.n)
        _, first = np.unique(keys, return_index=True)
        first.sort()
        self.edges = np.stack([lo[first], hi[first]], axis=1).astype(np.int32)
        self._edge_keys = np.sort(
            _pair_key(self.edges[:, 0].astype(np.int64),
                      self.edges[:, 1].astype(np.int64), self.n))

        self.deg = np.zeros(self.n, np.int32)
        np.add.at(self.deg, self.edges[:, 0], 1)
        np.add.at(self.deg, self.edges[:, 1], 1)
        self._build_csr()

        cfg.set_eta(self.total_pairs, self.ones)
        if cfg.nmi and cfg.ground_truth_fname:
            self.load_ground_truth(cfg.ground_truth_fname)

    def _build_csr(self) -> None:
        both_src = np.concatenate([self.edges[:, 0], self.edges[:, 1]])
        both_dst = np.concatenate([self.edges[:, 1], self.edges[:, 0]])
        order = np.argsort(both_src, kind="stable")
        self.col_idx = both_dst[order].astype(np.int32)
        counts = np.bincount(both_src, minlength=self.n)
        self.row_ptr = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)

    def neighbors(self, p: int) -> np.ndarray:
        return self.col_idx[self.row_ptr[p]: self.row_ptr[p + 1]]

    def drop_singles(self) -> None:
        """Shrink n to exclude padded single (edgeless) nodes, matching
        the reference's `env.n = network.n() - network.singles()`
        (reference: src/main.cc:291). Singles occupy the trailing seq ids
        so truncation is safe; total_pairs (already computed at ingest)
        keeps the padded value like the reference's Network does."""
        if self.singles == 0:
            return
        n_used = self.n - self.singles
        self.n = n_used
        self.cfg.n = n_used
        self.seq2id = self.seq2id[:n_used]
        self.id2seq = {e: i for i, e in enumerate(self.seq2id)}
        self.deg = self.deg[:n_used]
        self.row_ptr = self.row_ptr[: n_used + 1]
        self.singles = 0
        # pair keys are lo*n + hi: every cached key set must be rebuilt
        # under the shrunk n or y()/edge_ok/sample lookups compare keys
        # from two different bases and mislabel real links as nonlinks
        self._edge_keys = np.sort(
            _pair_key(self.edges[:, 0].astype(np.int64),
                      self.edges[:, 1].astype(np.int64), self.n))
        assert not hasattr(self, "_held_keys_sorted"), \
            "drop_singles must run before heldout splits are assigned"

    @staticmethod
    def _lpa_weighted(src: np.ndarray, dst: np.ndarray, w: np.ndarray,
                      n: int, sweeps: int) -> np.ndarray:
        """One level of deterministic weighted label propagation over a
        doubled (src, dst, weight) edge list that already includes unit
        self-votes: each node adopts the label with the largest vote
        weight among its neighbors+self, moving only on a STRICT win (or
        to a smaller label at equal weight). The self-vote + strict rule
        bounds label percolation to one hop per sweep — without it, tie
        breaks percolate the global min label through sparse
        cross-community edges and the partition collapses to one giant
        cluster (measured on a degree-5 planted graph: 17% internal)."""
        labels = np.arange(n, dtype=np.int64)
        for _ in range(sweeps):
            key = src * n + labels[dst]
            order = np.argsort(key, kind="stable")
            ks = key[order]
            ws = w[order]
            start = np.flatnonzero(
                np.concatenate([[True], np.diff(ks) != 0]))
            run_key = ks[start]
            run_w = np.add.reduceat(ws, start)
            node = run_key // n
            lab = run_key % n
            sel = np.lexsort((lab, -run_w, node))
            node_s = node[sel]
            first = np.flatnonzero(
                np.concatenate([[True], np.diff(node_s) != 0]))
            best_lab = lab[sel][first]
            best_w = run_w[sel][first]
            nn = node_s[first]
            cur_pos = np.searchsorted(run_key, nn * n + labels[nn])
            cur_w = run_w[cur_pos]              # self-vote: always >= 1
            move = (best_w > cur_w) | ((best_w == cur_w)
                                       & (best_lab < labels[nn]))
            new = labels.copy()
            new[nn[move]] = best_lab[move]
            if np.array_equal(new, labels):
                break
            labels = new
        return labels

    @staticmethod
    def _louvain_level(cp: np.ndarray, cq: np.ndarray, cw: np.ndarray,
                       m: int, sweeps: int, sizes: np.ndarray,
                       cap: int) -> np.ndarray:
        """Modularity-scored label sweeps over a contracted weighted
        graph (self-loops excluded): a supernode moves to the neighbor
        label maximizing the Louvain gain  w(i->c) − s_i·S_c / 2W
        (current label scored with itself removed from S_c), only on a
        strict win. Raw weight votes cannot tell structure from noise at
        coarse levels — they either freeze (self-cohesion dominates) or
        collapse to a giant cluster (measured both ways on a degree-5
        planted graph); the degree-product null model is what
        discriminates. `sizes` (base-node count per supernode) and
        `cap` bound cluster growth: moves into a label whose size would
        exceed cap are forbidden — unbounded merging grows clusters
        toward the bin capacity, which wrecks both the pack granularity
        and the boundary-row count (measured on the stretch graph:
        internal 95.6%->92.6%, table 0.23n->0.82n without the cap)."""
        node_str = np.bincount(np.concatenate([cp, cq]),
                               weights=np.concatenate([cw, cw]),
                               minlength=m)
        two_w = max(float(cw.sum()) * 2.0, 1.0)
        labels = np.arange(m, dtype=np.int64)
        all_m = np.arange(m, dtype=np.int64)
        src = np.concatenate([cp, cq, all_m])
        dstE = np.concatenate([cq, cp])
        wts = np.concatenate([cw, cw, np.zeros(m)]).astype(np.float64)
        for _ in range(sweeps):
            strength = np.bincount(labels, weights=node_str, minlength=m)
            csize = np.bincount(labels, weights=sizes.astype(np.float64),
                                minlength=m)
            # votes + a zero-weight entry for every node's CURRENT label
            # (so the stay-score exists even with no like-labeled
            # neighbor)
            dst_lab = np.concatenate([labels[dstE], labels])
            key = src * m + dst_lab
            order = np.argsort(key, kind="stable")
            ks = key[order]
            ws = wts[order]
            start = np.flatnonzero(
                np.concatenate([[True], np.diff(ks) != 0]))
            run_key = ks[start]
            run_w = np.add.reduceat(ws, start)
            node = run_key // m
            lab = run_key % m
            is_cur = lab == labels[node]
            s_other = np.where(is_cur, strength[lab] - node_str[node],
                               strength[lab])
            score = run_w - node_str[node] * s_other / two_w
            over = ~is_cur & (csize[lab] + sizes[node] > cap)
            score = np.where(over, -np.inf, score)
            sel = np.lexsort((lab, -score, node))
            node_s = node[sel]
            first = np.flatnonzero(
                np.concatenate([[True], np.diff(node_s) != 0]))
            best_lab = lab[sel][first]
            best_sc = score[sel][first]
            nn = node_s[first]
            cur_pos = np.searchsorted(run_key, nn * m + labels[nn])
            cur_sc = score[cur_pos]
            move = best_sc > cur_sc
            new = labels.copy()
            new[nn[move]] = best_lab[move]
            if np.array_equal(new, labels):
                break
            labels = new
        return labels

    def _label_prop(self, sweeps: int = 5, levels: int = 3,
                    cap: int = 0) -> np.ndarray:
        """Multilevel community pre-pass for the locality partition:
        one bounded-hop label-propagation level over the raw graph
        (fragments), then CONTRACT the fragments into supernodes (edge
        multiplicities become weights) and merge them with
        modularity-scored sweeps (_louvain_level) — the Louvain-style
        coarsening that fuses the fragments LPA leaves behind on
        low-degree graphs without collapsing across noise edges. Pure
        numpy sort-and-reduceat; ~3 sorts of 2E per sweep (seconds at
        29M edges)."""
        n = self.n
        cap = cap or n
        p = self.edges[:, 0].astype(np.int64)
        q = self.edges[:, 1].astype(np.int64)
        comp = np.arange(n, dtype=np.int64)     # node -> cluster id
        m = n
        sizes = np.ones(n, np.int64)            # base nodes per cluster
        cp, cq, cw = p, q, np.ones(len(p), np.int64)
        for level in range(max(levels, 1)):
            if level == 0:
                all_m = np.arange(m, dtype=np.int64)
                src = np.concatenate([cp, cq, all_m])
                dst = np.concatenate([cq, cp, all_m])
                w = np.concatenate([cw, cw, np.ones(m, np.int64)])
                sub = self._lpa_weighted(src, dst, w, m, sweeps)
            else:
                sub = self._louvain_level(cp, cq, cw, m, sweeps,
                                          sizes, cap)
            comp = sub[comp]
            uniq, inv = np.unique(comp, return_inverse=True)
            if len(uniq) == m or len(uniq) <= 1:
                break
            comp = inv.astype(np.int64)
            m = len(uniq)
            sizes = np.bincount(comp, minlength=m).astype(np.int64)
            # contract: aggregate parallel edges, DROPPING self-loops —
            # a supernode's internal weight as a vote for itself freezes
            # the coarse levels solid (measured: coarsening stalls at
            # ~39k fragments on the degree-5 planted graph); the unit
            # self-vote alone keeps the strict rule's percolation bound
            # while letting sibling-fragment weights accumulate
            a = comp[p]
            b = comp[q]
            lo, hi = np.minimum(a, b), np.maximum(a, b)
            keep = lo != hi
            if not keep.any():
                break          # every edge internal: nothing to merge
            key = lo[keep] * m + hi[keep]
            ks = np.sort(key)
            start = np.flatnonzero(
                np.concatenate([[True], np.diff(ks) != 0]))
            run_key = ks[start]
            cw = np.diff(np.concatenate([start, [len(ks)]]))
            cp = run_key // m
            cq = run_key % m
        return comp

    def reorder_locality(self, n_shards: int, sweeps: int = 5) -> None:
        """Permute seq ids into locality blocks for `-mesh-locality`:
        a majority-label-propagation pre-pass groups nodes into
        community clusters, and the clusters are best-fit packed into
        the d contiguous row blocks of the row-sharded mesh, so most
        edges fall INSIDE one block. The sharded sweep then exchanges
        only the boundary rows its edge shard actually touches — the
        TPU form of the reference's touched-rows-only reduce (its
        threads add back only the gamma_hat rows they touched,
        src/mmsbinfer.cc:1802-1808). (A plain BFS ordering was measured
        first: 0.2% cross-community noise edges make BFS frontiers leak
        across the planted stretch communities — 73% internal vs 99.5%+
        for label-prop packing.)

        Must run BEFORE any heldout split is sampled: pair keys are
        lo*n+hi over seq ids, and every downstream array (splits,
        training links, gamma rows) lives in the new order. seq2id
        carries the permutation, so all external-id interop (gamma.txt,
        communities.txt, NMI) is unchanged."""
        assert not hasattr(self, "_held_keys_sorted"), \
            "reorder_locality must run before heldout splits are sampled"
        if self.n == 0:
            return
        # cap clusters well below the bin size: pack granularity sets
        # the edge-load skew (measured on the stretch graph: cap at
        # rows_per/4 -> 1.32x max/mean load, rows_per/16 -> ~1.0x at a
        # negligible internal-fraction cost)
        rows_per_cap = self.n // max(n_shards, 1)
        labels = self._label_prop(sweeps,
                                  cap=max(rows_per_cap // 16, 1))
        by_label = np.argsort(labels, kind="stable")   # nodes grouped
        uniq, gstart = np.unique(labels[by_label], return_index=True)
        gsize = np.diff(np.concatenate([gstart, [self.n]]))
        # per-group INTERNAL edge weight: the pack balances edge load
        # across bins (the sweeps pad every shard to the max edge
        # count, so edge imbalance is wasted compute), subject to the
        # exact node capacity the row sharding requires; a group no bin
        # can hold is split across the emptiest bins (caps sum to n, so
        # the pack always completes)
        lp = labels[self.edges[:, 0].astype(np.int64)]
        lq = labels[self.edges[:, 1].astype(np.int64)]
        ew = np.bincount(lp[lp == lq], minlength=self.n)[uniq]
        d = max(n_shards, 1)
        cap = np.full(d, self.n // d, np.int64)
        cap[: self.n % d] += 1
        load = np.zeros(d, np.int64)
        bins: list = [[] for _ in range(d)]
        for gi in np.lexsort((-gsize, -ew)):
            lo = int(gstart[gi])
            size = int(gsize[gi])
            w = float(ew[gi]) / max(size, 1)     # edge weight per node
            while size > 0:
                fits = np.nonzero(cap >= size)[0]
                if len(fits):
                    b = int(fits[np.argmin(load[fits])])
                    take = size
                else:
                    b = int(np.argmax(cap))
                    take = int(cap[b])
                bins[b].append(by_label[lo: lo + take])
                cap[b] -= take
                load[b] += int(w * take)
                lo += take
                size -= take
        order = np.concatenate([a for bl in bins for a in bl]
                               or [np.zeros(0, np.int64)]).astype(np.int64)
        assert len(order) == self.n
        perm = np.empty(self.n, np.int64)    # perm[old] = new seq
        perm[order] = np.arange(self.n)

        p = perm[self.edges[:, 0].astype(np.int64)]
        q = perm[self.edges[:, 1].astype(np.int64)]
        lo, hi = np.minimum(p, q), np.maximum(p, q)
        self.edges = np.stack([lo, hi], axis=1).astype(np.int32)
        self._edge_keys = np.sort(_pair_key(lo, hi, self.n))
        self.seq2id = self.seq2id[order]
        self.id2seq = {int(e): i for i, e in enumerate(self.seq2id)}
        self.deg = self.deg[order]
        self._build_csr()
        if self.ground_truth is not None:
            self.ground_truth = [np.sort(perm[c]) for c in self.ground_truth]
        if self.gt_groups:
            self.gt_groups = {int(perm[s]): v
                              for s, v in self.gt_groups.items()}
        rows_per = self.n // max(n_shards, 1)
        if rows_per:
            own = self.edges // rows_per
            internal = float((own[:, 0] == own[:, 1]).mean())
            print(f"+ locality order: {internal:.1%} of edges internal "
                  f"to their {n_shards}-block partition")

    # ------------------------------------------------------------------
    def y(self, p: np.ndarray, q: np.ndarray) -> np.ndarray:
        """Vectorized link lookup for canonical or arbitrary pairs."""
        p = np.asarray(p, np.int64)
        q = np.asarray(q, np.int64)
        lo, hi = np.minimum(p, q), np.maximum(p, q)
        keys = _pair_key(lo, hi, self.n)
        idx = np.searchsorted(self._edge_keys, keys)
        idx = np.clip(idx, 0, len(self._edge_keys) - 1)
        return (self._edge_keys[idx] == keys).astype(np.int8)

    # ------------------------------------------------------------------
    def _resolve_ext_id(self, tok: str):
        """External-id token -> seq id, honoring -strid (string ids map
        through str_ids; otherwise int ids through id2seq). Returns None
        for ids absent from the network."""
        if self.cfg.strid and self.str_ids:
            if not hasattr(self, "_str2seq"):
                self._str2seq = {s: i for i, s in enumerate(self.str_ids)}
            tok_idx = self._str2seq.get(tok)
            if tok_idx is not None:
                # token index is the ORIGINAL ext id; map through id2seq
                # so a reorder_locality permutation stays transparent
                return self.id2seq.get(tok_idx)
        try:
            return self.id2seq.get(int(tok))
        except ValueError:
            return None

    def load_ground_truth(self, path: str) -> None:
        """Load ground-truth communities (reference: src/network.cc:253-438).

        Format: ``node_id<TAB>comm1 comm2 ...`` — one node per line.
        Stored as a list of per-community seq-id arrays. With -strid the
        node column may use the graph's string ids (an extension: the
        reference's loader is %d-only, src/network.cc:276, and asserts
        out on any unknown id)."""
        comms: Dict[int, List[int]] = {}
        with open(path) as f:
            for line in f:
                toks = line.split()
                if len(toks) < 2:
                    continue
                seq = self._resolve_ext_id(toks[0])
                if seq is None:
                    continue
                for c in toks[1:]:
                    comms.setdefault(int(c), []).append(seq)
        self.ground_truth = [np.array(sorted(v), np.int64)
                             for _, v in sorted(comms.items())]

    def load_gt_groups(self, path: str) -> int:
        """-groups-file: per-node ground-truth group metadata, one
        ``node_id<TAB>group`` line per node (string node ids with -strid).
        First entry per node wins; ids absent from the network are skipped
        with a warning (reference: Network::load_gt_groups,
        src/network.cc:721-775)."""
        n_loaded = 0
        str2seq = ({s: i for i, s in enumerate(self.str_ids)}
                   if self.str_ids else None)
        with open(path) as f:
            for line in f:
                toks = line.split()
                if len(toks) < 2:
                    continue
                if str2seq is not None:
                    seq = str2seq.get(toks[0])
                else:
                    try:
                        seq = self.id2seq.get(int(toks[0]))
                    except ValueError:
                        seq = None
                if seq is None:
                    print(f"+ groups-file: no node for id {toks[0]!r}")
                    continue
                if seq not in self.gt_groups:
                    self.gt_groups[seq] = toks[1]
                    n_loaded += 1
        print(f"+ loaded {n_loaded} group entries")
        return n_loaded

    def gt_group(self, seq: int) -> str:
        """Group metadata for a seq node id, '' when absent
        (reference: Network::gt_group, src/network.hh:208-214)."""
        return self.gt_groups.get(seq, "")

    def load_init_communities(self, path: str) -> None:
        """Load -init-communities: ONE COMMUNITY PER LINE of external node
        ids (e.g. a previous run's communities.txt; reference:
        Network::load_init_communities, src/network.cc:388-438). Stored as
        per-seq-node membership lists in ``init_communities_seq``."""
        members: List[List[int]] = [[] for _ in range(self.n)]
        cid = 0
        with open(path) as f:
            for line in f:
                toks = line.split()
                if not toks:
                    continue
                for t in toks:
                    seq = self._resolve_ext_id(t)
                    if seq is not None:
                        members[seq].append(cid)
                cid += 1
        self.init_communities_seq = members

    def write_gt_communities(self, path: str) -> None:
        """Write ground-truth communities as external ids, one community per
        line (reference: Network::write_gt_communities)."""
        assert self.ground_truth is not None
        with open(path, "w") as f:
            for comm in self.ground_truth:
                ids = sorted(int(self.seq2id[s]) for s in comm)
                f.write(" ".join(str(i) for i in ids) + " \n")

    # ------------------------------------------------------------------
    def sample_heldout_sets(self, rng: np.random.Generator,
                            dual: bool = False) -> None:
        """Sample the validation (and optional precision) heldout sets
        (reference: LinkSampling::init_validation, src/linksampling.cc:164-188;
        set_validation_sample, src/linksampling.cc:283-309).

        s1 = heldout_ratio * ones; the validation set holds s1/2 links and
        s1/2 nonlinks.

        dual (classic-SVI engines, reference set_heldout_sample +
        set_validation_sample, src/mmsbinfer.cc:245-328): a SECOND
        disjoint split of the same size goes into heldout_pairs — it
        drives the stopping rule, while validation_pairs is only
        evaluated at new maxima. Both are excluded from training
        (src/mmsbinfer.cc:858-863). Deterministic mode keeps the single
        split (the reproducible test path).
        """
        cfg = self.cfg
        s1 = int(cfg.heldout_ratio * self.ones)
        half = max(s1 // 2, 1)
        if cfg.deterministic:
            # deterministic pair walk (reference: Env::deterministic +
            # MMSBInfer::get_edge, src/mmsbinfer.hh:669-687): first links
            # in canonical order + first nonlinks of a sequential scan
            links = self.edges[:half]
            nonlinks = []
            p, q = 0, 1
            while len(nonlinks) < half:
                if not self.y(np.array([p]), np.array([q]))[0]:
                    nonlinks.append((p, q))
                q += 1
                if q >= self.n:
                    p += 1
                    q = p + 1
                    if p >= self.n - 1:
                        break
            nl = np.asarray(nonlinks, np.int64).reshape(-1, 2)
            self.validation_pairs = np.concatenate(
                [links, nl], axis=0).astype(np.int32)
            self.validation_y = np.concatenate(
                [np.ones(len(links), np.int8), np.zeros(len(nl), np.int8)])
            self.assign_training_links()
            return
        self.validation_pairs, self.validation_y = self._sample_split(rng, half, half)
        if dual:
            vkeys = _pair_key(
                self.validation_pairs[:, 0].astype(np.int64),
                self.validation_pairs[:, 1].astype(np.int64), self.n)
            self.heldout_pairs, self.heldout_y = self._sample_split(
                rng, half, half, exclude_keys=vkeys)
        if cfg.create_test_precision_sets:
            # precision split holds out s1 links and
            # (total_pairs - ones) * heldout_ratio nonlinks (reference:
            # set_precision_uniform_sample, src/linksampling.cc:311-330).
            # The nonlink count follows the reference exactly up to an
            # absolute 5M guard (the quadratic total_pairs term asks for
            # ~5e9 pairs at n=1M — unusable on either implementation)
            zeros = int((self.total_pairs - self.ones) * cfg.heldout_ratio)
            cap = 5_000_000
            if zeros > cap:
                print(f"+ precision nonlink sample capped at {cap} "
                      f"(reference formula asks for {zeros})")
            self.precision_pairs, self.precision_y = self._sample_split(
                rng, max(s1, 1), min(zeros, cap))
        self.assign_training_links()

    def _sample_split(self, rng: np.random.Generator, n_links: int,
                      n_nonlinks: int,
                      exclude_keys: Optional[np.ndarray] = None
                      ) -> Tuple[np.ndarray, np.ndarray]:
        """Sample n_links random links + n_nonlinks random nonlink pairs;
        exclude_keys keeps a second split disjoint from the first."""
        cand = np.arange(self.ones)
        if exclude_keys is not None:
            ek = _pair_key(self.edges[:, 0].astype(np.int64),
                           self.edges[:, 1].astype(np.int64), self.n)
            cand = cand[~np.isin(ek, exclude_keys)]
        link_idx = rng.choice(cand, size=min(n_links, len(cand)),
                              replace=False)
        links = self.edges[np.sort(link_idx)]
        nonlinks = self._sample_nonlinks(rng, n_nonlinks,
                                         exclude_keys=exclude_keys)
        pairs = np.concatenate([links, nonlinks], axis=0).astype(np.int32)
        ys = np.concatenate([
            np.ones(len(links), np.int8), np.zeros(len(nonlinks), np.int8)])
        return pairs, ys

    def _sample_nonlinks(self, rng: np.random.Generator, count: int,
                         exclude_keys: Optional[np.ndarray] = None) -> np.ndarray:
        """Rejection-sample up to `count` distinct nonlink pairs. Bails out
        (returning fewer) after a bounded number of attempts so dense or
        tiny graphs with < count distinct nonlinks cannot hang."""
        out = np.zeros((0, 2), np.int64)
        seen = np.zeros(0, np.int64)
        max_rounds = 200
        rounds = 0
        while len(out) < count:
            rounds += 1
            if rounds > max_rounds:
                break
            m = max(64, 2 * (count - len(out)))
            a = rng.integers(0, self.n, size=m)
            b = rng.integers(0, self.n, size=m)
            lo, hi = np.minimum(a, b), np.maximum(a, b)
            ok = lo != hi
            lo, hi = lo[ok], hi[ok]
            keys = _pair_key(lo, hi, self.n)
            # not a link
            idx = np.clip(np.searchsorted(self._edge_keys, keys), 0,
                          len(self._edge_keys) - 1)
            ok = self._edge_keys[idx] != keys
            # not already chosen
            uniq_keys, uniq_idx = np.unique(keys, return_index=True)
            dup = np.ones(len(keys), bool)
            dup[uniq_idx] = False
            ok &= ~dup
            ok &= ~np.isin(keys, seen)
            if exclude_keys is not None:
                ok &= ~np.isin(keys, exclude_keys)
            lo, hi, keys = lo[ok], hi[ok], keys[ok]
            take = min(count - len(out), len(lo))
            out = np.concatenate([out, np.stack([lo[:take], hi[:take]], 1)])
            seen = np.concatenate([seen, keys[:take]])
        return out

    def load_pairs_file(self, path: str) -> Tuple[np.ndarray, np.ndarray]:
        """Load a heldout pair file of external-id pairs
        (reference: LinkSampling::load_validation, src/linksampling.cc:1382-1418)."""
        raw = np.array(open(path).read().split(), np.int64).reshape(-1, 2)
        p = np.array([self.id2seq[int(x)] for x in raw[:, 0]], np.int64)
        q = np.array([self.id2seq[int(x)] for x in raw[:, 1]], np.int64)
        lo, hi = np.minimum(p, q), np.maximum(p, q)
        pairs = np.stack([lo, hi], 1).astype(np.int32)
        return pairs, self.y(lo, hi)

    # ------------------------------------------------------------------
    def assign_training_links(self) -> None:
        """Materialize training links = all links minus heldout link pairs
        (reference: LinkSampling::assign_training_links,
        src/linksampling.cc:493-523)."""
        held = [self.validation_pairs, self.heldout_pairs,
                self.test_pairs, self.precision_pairs]
        held_keys = np.concatenate(
            [_pair_key(h[:, 0].astype(np.int64), h[:, 1].astype(np.int64), self.n)
             for h in held if len(h)] or [np.zeros(0, np.int64)])
        edge_keys = _pair_key(self.edges[:, 0].astype(np.int64),
                              self.edges[:, 1].astype(np.int64), self.n)
        keep = ~np.isin(edge_keys, held_keys)
        self.training_links = self.edges[keep]
        self.training_deg = np.zeros(self.n, np.int32)
        np.add.at(self.training_deg, self.training_links[:, 0], 1)
        np.add.at(self.training_deg, self.training_links[:, 1], 1)
        self._held_keys_sorted = (np.sort(held_keys) if len(held_keys)
                                  else np.array([-1], np.int64))

    def edge_ok_mask(self, lo: np.ndarray, hi: np.ndarray) -> np.ndarray:
        """True where a canonical pair is NOT in any heldout split
        (reference: edge_ok, src/linksampling.hh:294-326). Requires
        assign_training_links to have run."""
        held = getattr(self, "_held_keys_sorted", None)
        if held is None:
            held = np.array([-1], np.int64)
        keys = _pair_key(lo.astype(np.int64), hi.astype(np.int64), self.n)
        idx = np.clip(np.searchsorted(held, keys), 0, len(held) - 1)
        return held[idx] != keys

    # ------------------------------------------------------------------
    def set_neighborhood_sets(self, cfg: Optional[Config] = None) -> None:
        """-preprocess: collect up to 100 "informative zeros" per node —
        2-hop non-neighbors, at most 10 per neighbor per cycle — or random
        zeros with -randzeros; write neighbors.bin
        (reference: Network::set_neighborhood_sets, src/network.cc:558-686).
        Binary layout matches the reference: per node, uint32 id,
        uint64 count, uint32[count] zero ids."""
        cfg = cfg or self.cfg
        limit = 100
        per_neighbor = 10
        rng = np.random.default_rng(cfg.seed)
        ptr = [0]
        idx: List[int] = []
        cfg.make_outdir()
        path = cfg.file_str("neighbors.bin")
        if not cfg.randzeros:
            # parallel C++ walk (native/ingest.cpp) — same output bytes as
            # the Python loop below; required at 1M-node scale
            from svinet_torch.io import native
            if native.preprocess_neighbors(path, self.row_ptr, self.col_idx,
                                           limit, per_neighbor):
                self.load_neighborhood_sets(path)
                print(f"+ wrote {path}: "
                      f"{len(self.sparse_zeros_idx)} informative zeros")
                return
        with open(path, "wb") as f:
            for i in range(self.n):
                nbrs = self.neighbors(i)
                zeros: List[int] = []
                if len(nbrs) == 0:
                    pass
                elif cfg.randzeros:
                    seen = set()
                    tries = 0
                    while len(zeros) < limit and tries < 50 * limit:
                        tries += 1
                        s = int(rng.integers(0, self.n))
                        if s != i and s not in seen and not self.y(
                                np.array([i]), np.array([s]))[0]:
                            zeros.append(s)
                            seen.add(s)
                else:
                    seen = set(int(x) for x in nbrs)
                    seen.add(i)
                    exhausted = set()
                    pos = {int(q): 0 for q in nbrs}
                    while len(zeros) < limit and len(exhausted) < len(nbrs):
                        for q in nbrs:
                            q = int(q)
                            if q in exhausted or len(zeros) >= limit:
                                continue
                            two_hop = self.neighbors(q)
                            c = 0
                            k = pos[q]
                            while k < len(two_hop) and len(zeros) < limit:
                                p = int(two_hop[k])
                                k += 1
                                if p not in seen:
                                    zeros.append(p)
                                    seen.add(p)
                                    c += 1
                                    if c >= per_neighbor:
                                        break
                            pos[q] = k
                            if k >= len(two_hop):
                                exhausted.add(q)
                f.write(np.uint32(i).tobytes())
                f.write(np.uint64(len(zeros)).tobytes())
                if zeros:
                    f.write(np.asarray(zeros, np.uint32).tobytes())
                idx.extend(zeros)
                ptr.append(len(idx))
        self.sparse_zeros_ptr = np.asarray(ptr, np.int64)
        self.sparse_zeros_idx = np.asarray(idx, np.int32)
        print(f"+ wrote {path}: {len(idx)} informative zeros")

    def load_neighborhood_sets(self, path: str) -> None:
        """Load neighbors.bin into CSR arrays
        (reference: Network::load_neighborhood_sets, src/network.cc:688-719)."""
        raw = open(path, "rb").read()
        off = 0
        ptr = np.zeros(self.n + 1, np.int64)
        idx: List[np.ndarray] = []
        total = 0
        while off < len(raw):
            node = int(np.frombuffer(raw, np.uint32, 1, off)[0])
            off += 4
            sz = int(np.frombuffer(raw, np.uint64, 1, off)[0])
            off += 8
            zeros = np.frombuffer(raw, np.uint32, sz, off)
            off += 4 * sz
            idx.append(zeros.astype(np.int32))
            total += sz
            ptr[node + 1] = total
        self.sparse_zeros_ptr = ptr
        self.sparse_zeros_idx = (np.concatenate(idx)
                                 if idx else np.zeros(0, np.int32))

    def sparse_zeros(self, i: int) -> np.ndarray:
        assert self.sparse_zeros_ptr is not None
        return self.sparse_zeros_idx[
            self.sparse_zeros_ptr[i]: self.sparse_zeros_ptr[i + 1]]


"""MMSBGen: network generation (-gen), posterior predictive checks (-ppc),
GML export (-gml) and link-community statistics (-lcstats)
(svinet_tpu/svi/gen.py; reference: src/mmsbgen.cc).

The dense pair draw runs on kernel 16 (csrc/gen_pairs.cu): for every pair
i < j, z_p ~ Cat(pi_i), z_q ~ Cat(pi_j) and a link with probability
beta[z_p] where z_p == z_q, eps otherwise (reference: src/mmsbgen.cc:
662-697). It draws on JAX's threefry stream (ops/threefry.py), in
draw_network's row blocks and keys: -gen from PRNGKey(seed), the -ppc draw
d from fold_in(PRNGKey(seed), d); each category is the Gumbel-max that
jax.random.categorical takes over log(max(pi, 1e-300)). So the edges are
the JAX package's, but where two of a pair's Gumbel scores lie within the
last bits of each other (the logs are the framework's, not XLA's).
gen_pairs_plain draws the same in int64 and f32 torch arithmetic. Every
numpy draw (pi, beta, ppc's per-draw pi and beta, the sparse generator
above n = 65,536) is the JAX package's, in its order;
draw_network_sparse, local_clustering_avg and bridgeness are copied
whole. The edge colours (inner_prod_max) are
plain PyTorch.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np
import torch

from svinet_torch.config import Config
from svinet_torch.graph import Network
from svinet_torch.io.writers import load_model
from svinet_torch.kernels import build
from svinet_torch.ops import threefry

# above this many nodes -gen takes the sparse Poisson-thinned draw
# (svinet_tpu/svi/gen.py:216)
DENSE_MAX_N = 65536
# pairs x K Gumbel draws the plain version makes at once
_PLAIN_FLOATS = 1 << 24
# words of the kernel's bit table a launch pair fills (256 MB)
_TABLE_WORDS = 1 << 26
# edges whose (E, K) products _edge_colors makes at once
_COLOR_FLOATS = 1 << 26


def default_row_block(n: int, k: int) -> int:
    """draw_network's row block (svinet_tpu/svi/gen.py:68-69)."""
    return max(1, min(n, (1 << 24) // max(n * k, 1) + 1))


def logits_of(pi: np.ndarray) -> np.ndarray:
    """log(max(pi, 1e-300)) in float64, kept in f32, as draw_network makes
    the categorical's logits."""
    return np.log(np.maximum(np.asarray(pi, np.float64), 1e-300)).astype(
        np.float32)


def _block_keys(key: threefry.Key, start: int):
    """(k1, k2, k3) of the row block at `start`: split(fold_in(key,
    start), 3)."""
    return threefry.split_keys(threefry.fold_in(key, start), 3)


def _categories(key, base, logits_rows, k):
    """The first argmax over c of gumbel(key, base K + c) + logits_rows."""
    c = torch.arange(k, dtype=torch.int64, device=base.device)
    g = threefry.gumbel_at(key, base[:, None] * k + c)
    return torch.argmax(g + logits_rows, dim=1)


def gen_pairs_plain(logits, beta, eps: float, key: threefry.Key,
                    row_block: int, row0: int = 0,
                    row1: Optional[int] = None) -> torch.Tensor:
    """Kernel 16 in plain PyTorch: the links among the pairs i < j of rows
    [row0, row1), row-major, (E, 2) int32. logits (n, K) f32 are log(max(pi,
    1e-300)), beta (K,) f32; key the draw's key, row_block
    default_row_block(n, K) for the JAX package's stream."""
    n, k = logits.shape
    row1 = n if row1 is None else row1
    dev = logits.device
    epsf = torch.tensor(eps, dtype=torch.float32, device=dev)
    limit = max(1024, _PLAIN_FLOATS // k)
    out = []
    i0 = row0
    while i0 < row1:
        start = i0 // row_block * row_block
        k1, k2, k3 = _block_keys(key, start)
        stop = min(row1, start + row_block)
        i1, count = i0, 0
        while i1 < stop and (count == 0 or count + (n - 1 - i1) <= limit):
            count += n - 1 - i1
            i1 += 1
        rows = torch.arange(i0, i1, device=dev, dtype=torch.int64)
        per = n - 1 - rows
        i = torch.repeat_interleave(rows, per)
        first = torch.cumsum(per, 0) - per
        j = (torch.arange(i.shape[0], device=dev)
             - torch.repeat_interleave(first, per) + i + 1)
        x = (i - start) * n + j
        u = threefry.uniform_at(k3, x)
        zp = _categories(k1, x, logits[i], k)
        zq = _categories(k2, x, logits[j], k)
        rate = torch.where(zp == zq, beta[zp], epsf)
        hit = u < rate
        out.append(torch.stack([i[hit], j[hit]], 1).to(torch.int32))
        i0 = i1
    if not out:
        return torch.zeros((0, 2), dtype=torch.int32, device=dev)
    return torch.cat(out)


def gen_pairs(logits, beta, eps: float, key: threefry.Key, row_block: int,
              row0: int = 0, row1: Optional[int] = None,
              stats: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Kernel 16 (csrc/gen_pairs.cu) on a CUDA tensor, gen_pairs_plain on
    a CPU tensor: the links among the pairs i < j of rows [row0, row1),
    row-major, (E, 2) int32. On the card, spans of rows whose bit table
    fits _TABLE_WORDS: pass 1 draws each pair once into the table and
    counts each row's links, the counts are scanned into offsets, pass 2
    writes. `stats` (2,) int64 on the card, when given, += the pairs whose
    z_p and z_q were drawn (the rest the kernel's exact shortcuts skip)."""
    if logits.device.type == "cpu":
        return gen_pairs_plain(logits, beta, eps, key, row_block, row0, row1)
    build.require_cuda(logits, "gen_pairs")
    dev = logits.device
    n, k = logits.shape
    row1 = n if row1 is None else row1
    build.check_cuda(logits, "logits", torch.float32, (n, k), dev)
    build.check_cuda(beta, "beta", torch.float32, (k,), dev)
    if stats is not None:
        build.check_cuda(stats, "stats", torch.int64, (2,), dev)
    eps = float(np.float32(eps))
    umax = max(float(beta.max()), eps)
    words = max(1, -(-n // 32))
    span = max(1, _TABLE_WORDS // words)
    table = torch.empty((min(span, max(row1 - row0, 1)), words),
                        dtype=torch.int32, device=dev)
    out = []
    for lo in range(row0, row1, span):
        hi = min(row1, lo + span)
        rows = hi - lo
        counts = torch.empty(rows, dtype=torch.int64, device=dev)
        args = (n, k, lo, hi, int(row_block), words, eps, umax,
                int(key[0]), int(key[1]))
        build.launch("svt_gen_pairs", dev, logits.data_ptr(),
                     beta.data_ptr(), table.data_ptr(), counts.data_ptr(),
                     None, None, None if stats is None else stats.data_ptr(),
                     *args, 0)
        ends = torch.cumsum(counts, 0)
        total = int(ends[-1])
        offsets = (ends - counts).contiguous()
        edges = torch.empty((max(total, 1), 2), dtype=torch.int32,
                            device=dev)
        build.launch("svt_gen_pairs", dev, logits.data_ptr(),
                     beta.data_ptr(), table.data_ptr(), None,
                     offsets.data_ptr(), edges.data_ptr(), None, *args, 1)
        out.append(edges[:total])
    build.count_launch(gen_pairs, "f32")
    if not out:
        return torch.zeros((0, 2), dtype=torch.int32, device=dev)
    return out[0] if len(out) == 1 else torch.cat(out)


gen_pairs.launches = 0
gen_pairs.forms = {}


def draw_network(pi: np.ndarray, beta: np.ndarray, eps: float,
                 key: threefry.Key, device) -> np.ndarray:
    """Draw a full network (svinet_tpu/svi/gen.py:64-82) on JAX's stream
    under `key`: (E, 2) int32 canonical edges, row-major, from kernel 16 on
    `device` (the plain version on the CPU)."""
    n, k = pi.shape
    logits = torch.as_tensor(logits_of(pi), device=device)
    b = torch.as_tensor(np.asarray(beta, np.float32), device=device)
    return gen_pairs(logits, b, float(np.float32(eps)), key,
                     default_row_block(n, k)).cpu().numpy()


def draw_network_sparse(rng: np.random.Generator, pi: np.ndarray,
                        beta: np.ndarray, eps: float) -> np.ndarray:
    """Sparse a-MMSB draw for large n — never enumerates the n^2 pairs.

    Per-community Poisson thinning (the Ball-Karrer-Newman Poisson
    multigraph construction): community k contributes
    m_k ~ Poisson(beta_k * (S_k^2 - sum_p pi_pk^2) / 2) candidate edges,
    each endpoint drawn iid proportional to pi[:,k]; self-loops dropped,
    duplicates deduped. For the small per-pair rates the generator is
    used with (beta_k * pi_pk * pi_qk << 1), this matches the reference's
    exact Bernoulli pair draw (reference: MMSBGen::draw_and_save,
    src/mmsbgen.cc:662-697) to O(rate^2). The epsilon cross-community
    term is ignored; with the default eps=1e-30 its expected edge count
    is ~0 on any graph that fits in memory (asserted below).

    Returns (E,2) int32 canonical (p<q) deduped edges.
    """
    n, k = pi.shape
    total_pairs = n * (n - 1) / 2.0
    if eps * total_pairs > 0.5:
        raise ValueError(
            f"sparse generator ignores the eps cross term but "
            f"eps*pairs = {eps * total_pairs:.2g} expected edges")
    out = []
    pi64 = pi.astype(np.float64, copy=False)
    s = pi64.sum(axis=0)
    t = (pi64 * pi64).sum(axis=0)
    lam = np.maximum(beta * (s * s - t) / 2.0, 0.0)
    m = rng.poisson(lam)
    for c in range(k):
        if m[c] == 0:
            continue
        cdf = np.cumsum(pi64[:, c])
        draws = np.searchsorted(
            cdf, rng.random(2 * int(m[c])) * cdf[-1], side="right")
        draws = np.minimum(draws, n - 1).astype(np.int32)
        p, q = draws[::2], draws[1::2]
        keep = p != q
        p, q = p[keep], q[keep]
        out.append(np.stack([np.minimum(p, q), np.maximum(p, q)], axis=1))
    if not out:
        return np.zeros((0, 2), np.int32)
    edges = np.concatenate(out, axis=0)
    keys = edges[:, 0].astype(np.int64) * n + edges[:, 1]
    _, idx = np.unique(keys, return_index=True)
    return edges[np.sort(idx)]


def local_clustering_avg(n: int, edges: np.ndarray) -> float:
    """Average local clustering coefficient, computed natively (the
    reference shells out to SNAP nstat). Triangle counting via sorted
    adjacency-set intersection per edge."""
    if len(edges) == 0:
        return 0.0
    deg = np.zeros(n, np.int64)
    np.add.at(deg, edges[:, 0], 1)
    np.add.at(deg, edges[:, 1], 1)
    nbrs = [[] for _ in range(n)]
    for p, q in edges:
        nbrs[p].append(q)
        nbrs[q].append(p)
    nbrs = [np.sort(np.array(v, np.int64)) for v in nbrs]
    tri = np.zeros(n, np.float64)
    for p, q in edges:
        common = np.intersect1d(nbrs[p], nbrs[q], assume_unique=True)
        c = len(common)
        tri[p] += c
        tri[q] += c
    denom = deg * (deg - 1)
    cc = np.where(denom > 0, tri / np.maximum(denom, 1), 0.0)
    return float(cc.mean())


def bridgeness(pi: np.ndarray, deg: np.ndarray) -> np.ndarray:
    """(1 - sqrt(sum (pi-1/K)^2 * K/(K-1))) * deg
    (reference: src/fastamm2.cc:2061-2073)."""
    n, k = pi.shape
    v = ((pi - 1.0 / k) ** 2).sum(1) * k / (k - 1)
    return (1.0 - np.sqrt(v)) * deg


def _edge_colors(pi, beta, edges):
    """inner_prod_max per edge (svinet_tpu/svi/gen.py:159-168; reference:
    src/matrix.hh:459-476): the argmax over k of pi_p pi_q beta (the first
    of equal maxima, as jnp.argmax takes), its share of the sum, and the
    sum. pi (n, K) and beta (K,) f32 tensors, edges (E, 2); numpy
    results, in chunks of edges."""
    k = pi.shape[1]
    e = torch.as_tensor(np.asarray(edges, np.int64), device=pi.device)
    colors, shares, sums = [], [], []
    step = max(1, _COLOR_FLOATS // max(k, 1))
    for lo in range(0, e.shape[0], step):
        pq = e[lo:lo + step]
        prod = pi[pq[:, 0]] * pi[pq[:, 1]] * beta
        s = prod.sum(-1)
        amax = prod.argmax(-1)
        mx = prod.gather(1, amax[:, None])[:, 0]
        colors.append(amax.to(torch.int32).cpu())
        shares.append((mx / s.clamp_min(1e-30)).cpu())
        sums.append(s.cpu())
    if not colors:
        return (np.zeros(0, np.int32), np.zeros(0, np.float32),
                np.zeros(0, np.float32))
    return (torch.cat(colors).numpy(), torch.cat(shares).numpy(),
            torch.cat(sums).numpy())


class MMSBGen:
    """The -gen / -ppc / -gml / -lcstats entry points on the host
    (svinet_tpu/svi/gen.py:194-474)."""

    def __init__(self, cfg: Config, network: Optional[Network],
                 device: torch.device):
        self.cfg = cfg
        self.network = network
        self.device = device
        self.n = cfg.n if network is None else network.n
        self.k = cfg.k

    def _f32(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a, np.float32), device=self.device)

    # ------------------------------------------------------------------
    def gen(self) -> None:
        """-gen: the a-MMSB generator; with -orig the full-blockmodel
        variant (alpha = 1/K, beta-gen-matrix.txt; reference:
        MMSBOrig::gen, src/mmsborig.cc:25-116); pi then beta from
        default_rng(seed), as the JAX engine draws them."""
        cfg = self.cfg
        cfg.make_outdir()
        rng = np.random.default_rng(cfg.seed)
        sparse = self.n > DENSE_MAX_N

        def _draw(pi, beta):
            if sparse:
                print(f"+ sparse generator (n={self.n} > 65536)")
                return draw_network_sparse(rng, pi, beta, cfg.epsilon)
            return draw_network(pi, beta, cfg.epsilon,
                                threefry.prng_key(cfg.seed), self.device)

        if cfg.orig:
            alpha = 1.0 / self.k
            pi = rng.dirichlet(np.full(self.k, alpha), size=self.n)
            beta = rng.beta(cfg.eta0_gen, cfg.eta1_gen, size=self.k)
            edges = _draw(pi, beta)
            with open(cfg.file_str("beta-gen-matrix.txt"), "w") as f:
                for g in range(self.k):
                    row = [cfg.epsilon] * self.k
                    row[g] = beta[g]
                    f.write("\t".join(f"{v:.5g}" for v in row) + "\n")
        else:
            alpha = 0.05  # reference: src/main.cc:277 hardcodes gen alpha
            pi = rng.dirichlet(np.full(self.k, alpha), size=self.n)
            beta = rng.beta(cfg.eta0_gen, cfg.eta1_gen, size=self.k)
            if cfg.disjoint:
                # every pair draw uses the node's most likely group
                # (reference: src/mmsbgen.hh:151-170)
                hard = np.eye(self.k)[pi.argmax(1)]
                pi = 0.999 * hard + 0.001 / self.k
            edges = _draw(pi, beta)
        from svinet_torch.io.native import write_edges_tsv
        if not write_edges_tsv(cfg.file_str("network_gen.dat"),
                               edges.astype(np.int64)):
            with open(cfg.file_str("network_gen.dat"), "w") as f:
                for p, q in edges:
                    f.write(f"{p}\t{q}\n")
        self._save_pi_beta(pi, beta)
        self._write_groups(pi)
        print(f"+ generated network: n={self.n}, ones={len(edges)}")

    def _save_pi_beta(self, pi, beta) -> None:
        cfg = self.cfg
        from svinet_torch.io.native import write_matrix_tsv
        if not write_matrix_tsv(cfg.file_str("pi-gen.txt"),
                                np.asarray(pi, np.float32), None,
                                decimals=5):
            with open(cfg.file_str("pi-gen.txt"), "w") as f:
                for i in range(self.n):
                    vals = "\t".join(f"{v:.5f}" for v in pi[i])
                    f.write(f"{i}\t{i}\t{vals}\n")
        with open(cfg.file_str("beta-gen.txt"), "w") as f:
            for k in range(self.k):
                f.write(f"{k}\t{beta[k]:.5f}\n")

    def _write_groups(self, pi) -> None:
        cfg = self.cfg
        groups = pi.argmax(1)
        from svinet_torch.io.native import write_matrix_tsv_extra
        if not write_matrix_tsv_extra(cfg.file_str("groups.txt"),
                                      np.asarray(pi, np.float32), None,
                                      groups, decimals=5):
            with open(cfg.file_str("groups.txt"), "w") as f:
                for i in range(self.n):
                    vals = "\t".join(f"{v:.5f}" for v in pi[i])
                    f.write(f"{i}\t{i}\t{vals}\t{groups[i]}\n")
        with open(cfg.file_str("summary.txt"), "a") as f:
            counts = np.bincount(groups, minlength=self.k)
            f.write("\t".join(str(c) for c in counts) + "\n")

    # ------------------------------------------------------------------
    def _load(self) -> Tuple[np.ndarray, np.ndarray]:
        """gamma.txt/lambda.txt from the cwd (reference:
        MMSBGen::load_model, src/mmsbgen.cc:73-149)."""
        return load_model(".", self.n, self.k, self.cfg.t)

    def ppc(self) -> None:
        """-ppc (svinet_tpu/svi/gen.py:294-382): the observed statistics,
        then ppc_ndraws networks under pi ~ Dir(gamma), beta ~
        Beta(lambda), drawn in the JAX order (a Dirichlet a row, then
        beta), each network from kernel 16 under fold_in(PRNGKey(seed), d); z-scores of
        the observed against the replicated statistics."""
        cfg = self.cfg
        net = self.network
        gamma, lam = self._load()
        os.makedirs("ppc", exist_ok=True)

        total_pairs = net.total_pairs
        obs_ones = net.ones / total_pairs
        obs_maxd, obs_avgd = net.deg_stats()
        obs_ccf = local_clustering_avg(self.n, net.edges)
        with open("obs-ones.txt", "a") as f:
            f.write(f"{obs_ones:.5f}\n")
        with open("obs-avg-deg.txt", "w") as f:
            f.write(f"{obs_avgd:.5f}\n")
        with open("obs-max-deg.txt", "w") as f:
            f.write(f"{obs_maxd}\n")
        with open("obs-ccf.txt", "w") as f:
            f.write(f"{obs_ccf:.5f}\n")

        rng = np.random.default_rng(cfg.seed)
        key = threefry.prng_key(cfg.seed)
        nd = cfg.ppc_ndraws
        rep_ones = np.zeros(nd)
        rep_avgd = np.zeros(nd)
        rep_maxd = np.zeros(nd)
        rep_ccf = np.zeros(nd)
        lc_obs_pe = np.zeros((nd, self.k))
        lc_ppc_pe = np.zeros((nd, self.k))
        lc_obs_sz = np.zeros((nd, self.k))
        lc_ppc_sz = np.zeros((nd, self.k))

        for d in range(nd):
            pi = np.stack([rng.dirichlet(gamma[i]) for i in range(self.n)])
            beta = rng.beta(lam[:, 0], lam[:, 1])
            edges = draw_network(pi, beta, cfg.epsilon,
                                 threefry.fold_in(key, d), self.device)
            rep_ones[d] = len(edges) / total_pairs
            deg = np.zeros(self.n, np.int64)
            if len(edges):
                np.add.at(deg, edges[:, 0], 1)
                np.add.at(deg, edges[:, 1], 1)
            rep_avgd[d] = deg.mean()
            rep_maxd[d] = deg.max() if len(edges) else 0
            rep_ccf[d] = local_clustering_avg(self.n, edges)

            # per-link-community statistics under this draw's pi and beta
            pi_d, beta_d = self._f32(pi), self._f32(beta)
            for (pairs, pe, sz) in ((net.edges, lc_obs_pe, lc_obs_sz),
                                    (edges, lc_ppc_pe, lc_ppc_sz)):
                if pairs.shape[0] == 0:
                    continue
                colors, mx, pr = _edge_colors(pi_d, beta_d, pairs)
                keep = mx >= 0.5
                ll = np.log(np.maximum(pr, 1e-30))
                for k in range(self.k):
                    sel = keep & (colors == k)
                    sz[d, k] = sel.sum()
                    pe[d, k] = ll[sel].mean() if sel.any() else 0.0
            print(f"ppc draw: {d} / {nd}")

        def _dump(name, arr):
            with open(f"ppc/{name}", "w") as f:
                for v in arr:
                    f.write(f"{v:.5f}\n")

        _dump("ppc-ones.txt", rep_ones)
        _dump("ppc-avg-deg.txt", rep_avgd)
        _dump("ppc-max-deg.txt", rep_maxd)
        _dump("ppc-ccf.txt", rep_ccf)

        def _z(obs, rep):
            sd = rep.std()
            return (obs - rep.mean()) / sd if sd > 0 else 0.0

        with open("ppc/zscores.txt", "w") as f:
            f.write(f"ones\t{_z(obs_ones, rep_ones):.5f}\n")
            f.write(f"avg_deg\t{_z(obs_avgd, rep_avgd):.5f}\n")
            f.write(f"max_deg\t{_z(obs_maxd, rep_maxd):.5f}\n")
            f.write(f"ccf\t{_z(obs_ccf, rep_ccf):.5f}\n")
        with open("ppc/lc_zscores_pe.txt", "w") as f:
            for k in range(self.k):
                f.write(f"{k}\t{_z(lc_obs_pe[:, k].mean(), lc_ppc_pe[:, k]):.5f}\n")
        with open("ppc/lc_zscores_size.txt", "w") as f:
            for k in range(self.k):
                f.write(f"{k}\t{_z(lc_obs_sz[:, k].mean(), lc_ppc_sz[:, k]):.5f}\n")
        print("+ ppc done")

    # ------------------------------------------------------------------
    def _colors_of_model(self):
        """pi, beta, the colours of every observed link under the
        gamma.txt/lambda.txt in the cwd."""
        gamma, lam = self._load()
        pi = gamma / gamma.sum(1, keepdims=True)
        beta = lam[:, 0] / (lam[:, 0] + lam[:, 1])
        colors, mx, _ = _edge_colors(self._f32(pi), self._f32(beta),
                                     self.network.edges)
        return pi, colors, mx

    def gml(self) -> None:
        """-gml: network.gml with node groups, bridgeness, influence and
        degree and each link coloured by its community where the share is
        >= 0.9, uncolored-links.txt, node_bridgeness.txt and
        node_influence.txt (svinet_tpu/svi/gen.py:385-445; reference:
        MMSBGen::gml, src/mmsbgen.cc:910-961)."""
        cfg = self.cfg
        cfg.make_outdir()
        net = self.network
        pi, colors, mx = self._colors_of_model()
        groups = pi.argmax(1)
        bri = bridgeness(pi, net.deg)

        # per-community subgraph degrees (influence; reference: community.hh)
        comm_deg = np.zeros((self.n, self.k), np.int64)
        sel = mx >= 0.9
        for (p, q), c in zip(net.edges[sel], colors[sel]):
            comm_deg[p, c] += 1
            comm_deg[q, c] += 1

        with open(cfg.file_str("network.gml"), "w") as f:
            f.write("graph\n[\n\tdirected 0\n")
            for i in range(self.n):
                g = int(groups[i])
                f.write("\tnode\n\t[\n")
                f.write(f"\t\tid {i}\n")
                f.write(f"\t\textid {int(net.seq2id[i])}\n")
                f.write(f"\t\tgroup {g}\n")
                f.write(f"\t\tbridgeness {bri[i]:.5f}\n")
                f.write(f"\t\tinfluence {int(comm_deg[i, g])}\n")
                f.write(f"\t\tdegree {int(net.deg[i])}\n")
                f.write("\t]\n")
            for (p, q), c, m in zip(net.edges, colors, mx):
                if m < 0.9:
                    continue
                f.write("\tedge\n\t[\n")
                f.write(f"\t\tsource {p}\n")
                f.write(f"\t\ttarget {q}\n")
                f.write(f"\t\tcolor {c}\n")
                f.write("\t]\n")
            f.write("]\n")
        with open(cfg.file_str("uncolored-links.txt"), "w") as f:
            for (p, q), m in zip(net.edges, mx):
                if m < 0.9:
                    f.write(f"{int(net.seq2id[p])}\t{int(net.seq2id[q])}\n")
        with open(cfg.file_str("node_bridgeness.txt"), "w") as f:
            for i in range(self.n):
                f.write(f"{i}\t{int(net.seq2id[i])}\t{bri[i]:.5f}\t"
                        f"{int(net.deg[i])}\t{int(groups[i])}\n")
        with open(cfg.file_str("node_influence.txt"), "w") as f:
            for i in range(self.n):
                row = "\t".join(str(int(v)) for v in comm_deg[i])
                f.write(f"{i}\t{int(net.seq2id[i])}\t{row}\n")
        print("+ Done writing GML file. Visualize the communities using "
              "a tool such as Gephi.")

    def get_lc_stats(self) -> None:
        """-lcstats: per-community degree statistics and the most
        influential node (svinet_tpu/svi/gen.py:447-474; reference:
        MMSBGen::get_lc_stats, src/mmsbgen.cc:180-193, 673-700)."""
        cfg = self.cfg
        cfg.make_outdir()
        net = self.network
        _, colors, mx = self._colors_of_model()
        sel = mx >= 0.5
        comm_deg = np.zeros((self.n, self.k), np.int64)
        for (p, q), c in zip(net.edges[sel], colors[sel]):
            comm_deg[p, c] += 1
            comm_deg[q, c] += 1
        with open(cfg.file_str("community_stats.txt"), "w") as f:
            for k in range(self.k):
                d = comm_deg[:, k]
                nz = d[d > 0]
                avg = nz.mean() if len(nz) else 0.0
                mxd = d.max() if len(nz) else 0
                node = int(d.argmax())
                f.write(f"{k}\t{avg:.5f}\t{float(mxd):.5f}\t{node}\t"
                        f"{int(net.seq2id[node])}\n")
